"""Measurement scripts of the torch package, run on the card."""
