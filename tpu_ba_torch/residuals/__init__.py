"""Robust losses and reprojection residuals."""
