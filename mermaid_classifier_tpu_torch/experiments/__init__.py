"""Experiment harnesses of the port (``trunk_ab``: the full-trunk schedule
A/B)."""
