"""Measurement scripts of the port that run on the card."""
