"""Synthetic data for the port: the numpy trajectory simulator, its IMU
bundling, and the textured-sphere renderer."""
