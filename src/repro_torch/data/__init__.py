"""Synthetic datasets (numpy copies of ``repro/data/pipeline.py``)."""
