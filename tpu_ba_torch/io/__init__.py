"""Problem generators (numpy, seeded like the reference)."""
