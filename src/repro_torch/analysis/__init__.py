"""Analytic cost models. Reference: ``src/repro/analysis/``."""
