"""Synthetic data (``pipeline.SyntheticLM``)."""
