"""Measurement harnesses of the port's scan kernels (they need the card)."""
