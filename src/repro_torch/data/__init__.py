"""Synthetic data: twins of ``repro/data/pipeline.py``."""
