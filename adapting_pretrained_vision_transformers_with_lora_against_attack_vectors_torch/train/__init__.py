"""Evaluation steps and metrics (the training stages are ported later)."""
