"""Serving steps of the port (train steps come with ROADMAP A12)."""
