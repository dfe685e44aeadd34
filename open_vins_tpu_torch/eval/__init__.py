"""Trajectory alignment and error metrics (numpy, offline)."""
