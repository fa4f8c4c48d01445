"""Distances."""
