"""Data pipelines. Reference: ``src/repro/data/``."""
