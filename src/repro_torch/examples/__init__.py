"""Runnable ports of the JAX package's examples (python -m repro_torch.examples.<name>)."""
