"""LM loop, Schur complement, PCG and their host plans."""
