"""Data for the port: the numpy trajectory simulator, its IMU bundling, the
textured-sphere renderer, the EuRoC reader (euroc.py) and writer
(synth_euroc.py), and a numpy + zlib PNG codec (png.py)."""
