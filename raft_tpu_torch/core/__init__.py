"""Core: resources, validation and serialization."""
