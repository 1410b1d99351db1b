"""Benchmark problem initializers."""
