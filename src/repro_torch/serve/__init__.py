"""Serving: ``queue.py`` (admission and scheduling) and ``engine.py``
(``ODEEngine``, batched ODE evaluation, and ``LMEngine``, wave-based
continuous batching)."""
from repro_torch.serve.engine import LMEngine, ODEEngine
from repro_torch.serve.queue import (AdmissionError, BucketSpec, Request,
                                     RequestQueue, Ticket)

__all__ = ["AdmissionError", "BucketSpec", "LMEngine", "ODEEngine",
           "Request", "RequestQueue", "Ticket"]
