"""Frozen operation counts, one module per model family."""
