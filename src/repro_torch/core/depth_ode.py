"""Continuous-depth blocks on top of ``core.adjoint.odeint``.

``ODEBlock`` integrates du/dt = F(u, theta, t) with any explicit method and
any PNODE adjoint policy (shared weights over depth).  The layer-stack
``checkpointed_scan`` of the JAX package arrives with the LM stack.
"""
from __future__ import annotations

import torch

from repro_torch.core.adjoint import odeint
from repro_torch.core.integrators import PyTree


class ODEBlock(torch.nn.Module):
    """Continuous-depth block: ``block(u0, theta)`` solves from t0 to t1 in
    ``n_steps`` fixed steps.  It holds no parameters: ``theta`` is passed in
    (a dict of tensors, as every vector field here takes).
    ``fused_stages`` is handed to ``odeint`` as it is."""

    def __init__(self, vf, *, n_steps: int = 4, method: str = "rk4",
                 adjoint: str = "pnode", ncheck: int | None = None,
                 t0: float = 0.0, t1: float = 1.0,
                 fused_stages: bool = False):
        super().__init__()
        self.vf = vf
        self.n_steps = n_steps
        self.method = method
        self.adjoint = adjoint
        self.ncheck = ncheck
        self.t0 = t0
        self.dt = (t1 - t0) / n_steps
        self.fused_stages = fused_stages

    def forward(self, u0: PyTree, theta: PyTree) -> PyTree:
        return odeint(self.vf, u0, theta, dt=self.dt, n_steps=self.n_steps,
                      t0=self.t0, method=self.method, adjoint=self.adjoint,
                      ncheck=self.ncheck, fused_stages=self.fused_stages)
