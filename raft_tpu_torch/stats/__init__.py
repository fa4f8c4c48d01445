"""Statistics: recall."""
