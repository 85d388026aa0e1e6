"""Serving engine (copies of repro.serving modules) and the torch executor."""
