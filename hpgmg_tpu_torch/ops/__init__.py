"""Operator suites, boundary ghosts and inter-level transfers."""
