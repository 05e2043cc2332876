"""Utilities of the port: trajectory metrics, logging, checkpoints."""
