"""JSONL metrics sink and structured logger (``sink.py``)."""
from repro_torch.obs.sink import MetricsSink, StructuredLogger, read_jsonl

__all__ = ["MetricsSink", "StructuredLogger", "read_jsonl"]
