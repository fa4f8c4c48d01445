"""Nearest-neighbor indexes: brute force and IVF-Flat."""
