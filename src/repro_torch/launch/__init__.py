"""Step builders and the serving CLI (``python -m repro_torch.launch.serve``)."""
