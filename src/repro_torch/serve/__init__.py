"""LM serving: ``queue.py`` (admission and scheduling) and ``engine.py``
(``LMEngine``, wave-based continuous batching)."""
from repro_torch.serve.engine import LMEngine
from repro_torch.serve.queue import (AdmissionError, BucketSpec, Request,
                                     RequestQueue, Ticket)

__all__ = ["AdmissionError", "BucketSpec", "LMEngine", "Request",
           "RequestQueue", "Ticket"]
