"""Metrics logging and profiler traces."""
