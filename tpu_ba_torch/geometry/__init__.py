"""Rotations and the BAL camera model."""
