"""Core data structures: solver configuration, levels and the hierarchy."""
