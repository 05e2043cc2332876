"""Numpy utilities of the port: trajectory metrics."""
