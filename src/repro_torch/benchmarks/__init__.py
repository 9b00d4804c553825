"""Benchmark drivers of the port (run on the card)."""
