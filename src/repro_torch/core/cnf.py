"""Continuous normalizing flows (FFJORD) on top of the PNODE adjoint core.

The CNF ODE evolves (x, log p) jointly:

    d x / dt       = f(x, theta, t)
    d logdet / dt  = -tr( df/dx )

Trace estimation: exact (d ``torch.func.jvp`` probes, for small d — the
paper's tabular datasets are 6/43/63-dim) or Hutchinson (one vjp with a
fixed Rademacher probe).  The augmented system is just another vector
field, so every adjoint policy applies unchanged — this is what the
paper's Tables 3-7 measure.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.adjoint import odeint
from repro_torch.core.integrators import PyTree, VectorField


def exact_trace_vf(f: VectorField, dim: int) -> VectorField:
    """Augmented vector field with exact trace (dim jvp probes)."""

    def aug(state, theta, t):
        x, _logdet = state
        fx = f(x, theta, t)

        def jac_diag_i(i):
            e = torch.zeros_like(x)
            e[..., i] = 1.0
            _, jv = torch.func.jvp(lambda xx: f(xx, theta, t), (x,), (e,))
            return jv[..., i]

        diag = torch.stack([jac_diag_i(i) for i in range(dim)], dim=-1)
        trace = torch.sum(diag, dim=-1)
        return (fx, -trace)

    return aug


def hutchinson_trace_vf(f: VectorField, probe: torch.Tensor) -> VectorField:
    """Augmented vector field with a Hutchinson trace estimate.

    ``probe`` is a fixed Rademacher tensor shaped like x (drawn once per
    training iteration, as in FFJORD)."""

    def aug(state, theta, t):
        x, _logdet = state
        fx, vjp_fn = torch.func.vjp(lambda xx: f(xx, theta, t), x)
        (vjp_probe,) = vjp_fn(probe)
        trace_est = torch.sum(vjp_probe * probe, dim=-1)
        return (fx, -trace_est)

    return aug


def cnf_log_prob(f: VectorField, x: torch.Tensor, theta: PyTree, *,
                 dt: float, n_steps: int, method: str = "dopri5",
                 adjoint: str = "pnode", ncheck: int | None = None,
                 trace: str = "exact", probe: torch.Tensor | None = None,
                 t0: float = 0.0, fused_stages: bool = False) -> torch.Tensor:
    """log p(x) under the CNF that flows data -> base N(0, I) over [t0, t1].

    Integrates the augmented ODE forward from the data points; returns the
    per-sample log-probability (batch,) — the training loss is its negative
    mean (Tables 3-7 of the paper).  ``fused_stages`` is handed to
    ``odeint``.
    """
    dim = x.shape[-1]
    if trace == "exact":
        aug = exact_trace_vf(f, dim)
    elif trace == "hutchinson":
        if probe is None:
            raise ValueError("hutchinson trace needs a probe")
        aug = hutchinson_trace_vf(f, probe)
    else:
        raise ValueError(trace)

    logdet0 = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    z, dlogdet = odeint(aug, (x, logdet0), theta, dt=dt, n_steps=n_steps,
                        t0=t0, method=method, adjoint=adjoint, ncheck=ncheck,
                        fused_stages=fused_stages)
    base_logp = -0.5 * torch.sum(z ** 2, dim=-1) \
        - 0.5 * dim * math.log(2 * math.pi)
    # log p(x) = log p_base(z) + integral of -tr(J) accumulated in dlogdet
    return base_logp + dlogdet


def cnf_sample(f: VectorField, z: torch.Tensor, theta: PyTree, *, dt: float,
               n_steps: int, method: str = "dopri5", t0: float = 0.0):
    """Sample by integrating base noise backward through the flow."""
    t1 = t0 + dt * n_steps

    def neg_f(x, th, t):
        return -f(x, th, t1 + t0 - t)

    logdet0 = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
    aug = exact_trace_vf(neg_f, z.shape[-1])
    x, _ = odeint(aug, (z, logdet0), theta, dt=dt, n_steps=n_steps, t0=t0,
                  method=method, adjoint="naive")
    return x
