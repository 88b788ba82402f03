"""Execution engines. Reference: ``src/repro/distributed/``."""
