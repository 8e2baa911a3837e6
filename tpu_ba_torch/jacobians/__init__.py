"""Analytic Jacobian blocks."""
