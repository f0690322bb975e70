"""PNODE checkpointing applied over *depth*, and continuous-depth blocks:
the port of ``repro/core/depth_ode.py``.

A residual stack  u_{l+1} = u_l + F(u_l, theta_l)  is forward Euler with
h = 1 and a layer-indexed vector field.  ``checkpointed_scan`` runs the
layers over stacked per-layer parameters with a selectable gradient
strategy, the paper's adjoint policies at the depth level:

  remat='none'     a plain loop: autograd keeps every layer's residuals.
  remat='full'     every layer recomputed in the reverse pass (each layer
                   under ``torch.utils.checkpoint``).
  remat='sqrt'     segments of about sqrt(N_l) layers, each checkpointed:
                   the segment boundaries are the checkpoints, one
                   recompute per layer.
  remat='revolve'  segments between the binomial schedule's positions
                   over layers (``core/revolve.py``, N_c slots), each
                   checkpointed.

Where JAX scans (``lax.scan``) this port loops in Python; checkpoints are
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, which
keeps the first forward's graph and recomputes only its saved tensors,
so with deterministic kernels every policy gives bitwise the value and
gradients of ``'none'``.

``ODEBlock`` integrates du/dt = F(u, theta, t) with any explicit method and
any PNODE adjoint policy (shared weights over depth).
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.adjoint import odeint
from repro_torch.core.integrators import PyTree
from repro_torch.core.revolve import sweep_checkpoint_positions

LayerFn = Callable[[PyTree, PyTree], PyTree]  # (carry, layer_params) -> carry


def _at(tree: PyTree, i):
    """Layer ``i`` (an int) or layers ``i`` (a slice) of a stacked tree:
    views of every tensor leaf's leading axis."""
    if isinstance(tree, dict):
        return {k: _at(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_at(v, i) for v in tree)
    return tree[i]


def _plain_scan(layer_fn: LayerFn, u0: PyTree, stacked: PyTree,
                n: int) -> PyTree:
    u = u0
    for l in range(n):
        u = layer_fn(u, _at(stacked, l))
    return u


def _checkpointed_segment(layer_fn: LayerFn, u: PyTree, stacked: PyTree,
                          a: int, b: int) -> PyTree:
    """Layers [a, b) as one checkpoint: their activations are recomputed
    in the reverse pass from the segment's input."""
    return checkpoint(lambda c, ps: _plain_scan(layer_fn, c, ps, b - a),
                      u, _at(stacked, slice(a, b)), use_reentrant=False)


def checkpointed_scan(layer_fn: LayerFn, u0: PyTree, stacked_params: PyTree,
                      n_layers: int, remat: str = "sqrt",
                      ncheck: int | None = None) -> PyTree:
    """Run u <- layer_fn(u, params_l) for l = 0..n_layers-1 with the chosen
    depth-checkpointing policy.  ``stacked_params`` has a leading N_l axis
    on every tensor leaf (dicts, tuples and lists are walked)."""
    if remat == "none":
        return _plain_scan(layer_fn, u0, stacked_params, n_layers)
    if remat == "full":
        u = u0
        for l in range(n_layers):
            u = _checkpointed_segment(layer_fn, u, stacked_params, l, l + 1)
        return u
    if remat == "sqrt":
        seg = max(1, int(math.sqrt(n_layers)))
        if n_layers % seg:
            # the largest divisor <= sqrt, as the JAX package reshapes
            seg = next(d for d in range(int(math.sqrt(n_layers)), 0, -1)
                       if n_layers % d == 0)
        u = u0
        for a in range(0, n_layers, seg):
            u = _checkpointed_segment(layer_fn, u, stacked_params, a, a + seg)
        return u
    if remat == "revolve":
        if ncheck is None:
            raise ValueError("remat='revolve' requires ncheck")
        positions = [0] + sweep_checkpoint_positions(n_layers, ncheck) \
            + [n_layers]
        u = u0
        for a, b in zip(positions[:-1], positions[1:]):
            u = _checkpointed_segment(layer_fn, u, stacked_params, a, b)
        return u
    raise ValueError(f"unknown remat policy {remat!r}")


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
