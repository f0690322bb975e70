"""Matrix-free restarted GMRES on pytrees of tensors, and on a folded lane
axis of independent systems.

The counterpart of ``jax.scipy.sparse.linalg.gmres(A, b, tol=..., maxiter=...,
solve_method="incremental")``, which the JAX package's implicit solvers call
(``repro/core/implicit.py``).  It follows that algorithm step for step, not
SciPy's, so that a Newton solve built on it takes the same iterations:

- ``maxiter`` counts restart cycles, not inner iterations (default
  ``10 * size``); ``restart`` (default 20) is capped at the system size;
- the outer loop runs while ``||b - A x|| > atol``, with
  ``atol = max(tol * ||b||, atol)``; a cycle's inner loop runs while
  ``k < restart`` and the rotated residual estimate ``|beta[k+1]|`` exceeds
  ``ptol = ||b|| * min(1, atol / ||b||)``;
- each inner iteration is one Arnoldi step: ``A`` applied to the newest
  Krylov vector, one classical Gram-Schmidt pass against all of them
  (JAX's "iterative" loop, whose two-iteration cap makes it one pass), the
  new vector's norm thresholded at ``eps * ||A v||``, and the
  Hessenberg row reduced by Givens rotations;
- a cycle ends with the triangular solve over the full ``restart``-sized
  system, whose unfilled rows are identity rows, exactly as JAX's does.

Every quantity is kept per lane: ``b`` is ``(B, n)``, and each lane has its
own norms, tolerances, Krylov basis, Givens pairs and exits, as
``jax.vmap`` of the JAX solver gives them.  An exit is a per-lane boolean
tensor, and a lane whose exit is taken keeps its values through
``torch.where`` (never a 0/1 product: a frozen lane may hold ``0/0`` or
``inf``).  The loop bounds are Python ints, so ``gmres_lanes`` with
``host_exits=False`` reads nothing on the host and can be captured as a
CUDA graph; with ``host_exits=True`` a loop ends as soon as no lane is live
(one device-to-host read per inner iteration and per cycle).  ``gmres`` is
the latter on one lane: the pytree flattened to a ``(1, n)`` vector, the
eager route.  No graph is recorded: the implicit solvers never
differentiate through GMRES.  ``A`` must be lane-separable: row i of
``A(w)`` depends only on row i of ``w``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

__all__ = ["gmres", "gmres_lanes", "GmresLanes", "GmresCarry"]


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Per-lane 2-norm of a (B, n) block."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _safe_normalize(x: torch.Tensor, thresh=None):
    """x / ||x|| and ||x|| per lane, or zeros and 0 where ||x|| <= thresh
    (by default the dtype's machine epsilon)."""
    norm = _norm(x)
    if thresh is None:
        thresh = torch.finfo(norm.dtype).eps
    use = norm > thresh
    return (torch.where(use[:, None], x / norm[:, None], 0.0),
            torch.where(use, norm, 0.0))


def _gram_schmidt(Q: torch.Tensor, x: torch.Tensor):
    """Orthogonalize each lane's x against the rows of its Q (B, k, n) by
    one classical Gram-Schmidt pass.  Returns q and the overlaps h (B, k)."""
    h = (Q @ x[:, :, None])[:, :, 0]
    return x - (Q.transpose(1, 2) @ h[:, :, None])[:, :, 0], h


def _rotate(H: torch.Tensor, i: int, cs, sn) -> None:
    x1, y1 = H[:, i].clone(), H[:, i + 1].clone()
    H[:, i] = cs * x1 - sn * y1
    H[:, i + 1] = sn * x1 + cs * y1


def _givens_rotation(a, b):
    b_zero = b.abs() == 0
    a_lt_b = a.abs() < b.abs()
    t = -torch.where(a_lt_b, a, b) / torch.where(a_lt_b, b, a)
    r = torch.rsqrt(1 + t.abs() ** 2)
    cs = torch.where(b_zero, 1.0, torch.where(a_lt_b, r * t, r))
    sn = torch.where(b_zero, 0.0, torch.where(a_lt_b, r, r * t))
    return cs, sn


class GmresCarry:
    """The state of a restarted GMRES between cycles, per lane: the
    right-hand side, the iterate, the unit residual and its norm, the two
    tolerances and the counts.  The solvers keep one as static buffers and
    update it in place, a cycle at a time."""

    def __init__(self, like: torch.Tensor):
        lanes = like.shape[0]
        vec = dict(dtype=like.dtype, device=like.device)
        count = dict(dtype=torch.int64, device=like.device)
        self.b = torch.zeros_like(like)
        self.x = torch.zeros_like(like)
        self.unit = torch.zeros_like(like)
        self.rnorm = torch.zeros(lanes, **vec)
        self.atol = torch.zeros(lanes, **vec)
        self.ptol = torch.zeros(lanes, **vec)
        self.cycles = torch.zeros(lanes, **count)
        self.steps = torch.zeros(lanes, **count)

    def tensors(self) -> list:
        return [self.b, self.x, self.unit, self.rnorm, self.atol, self.ptol,
                self.cycles, self.steps]

    def begin(self, A: Callable, b: torch.Tensor, mask: torch.Tensor, *,
              tol: float, atol: float, x0: torch.Tensor | None = None) -> None:
        """Start a solve of ``A x = b`` on the lanes in ``mask`` (from x0,
        by default 0); the other lanes keep their state."""
        x = torch.zeros_like(b) if x0 is None else x0
        b_norm = _norm(b)
        atol_l = torch.clamp(tol * b_norm, min=atol)
        ptol = b_norm * torch.clamp(atol_l / b_norm, max=1.0)
        unit, rnorm = _safe_normalize(b - A(x))
        m = mask[:, None]
        self.b.copy_(torch.where(m, b, self.b))
        self.x.copy_(torch.where(m, x, self.x))
        self.unit.copy_(torch.where(m, unit, self.unit))
        self.rnorm.copy_(torch.where(mask, rnorm, self.rnorm))
        self.atol.copy_(torch.where(mask, atol_l, self.atol))
        self.ptol.copy_(torch.where(mask, ptol, self.ptol))
        self.cycles.masked_fill_(mask, 0)
        self.steps.masked_fill_(mask, 0)

    def live(self, maxiter: int) -> torch.Tensor:
        """The outer loop's condition per lane."""
        return (self.cycles < maxiter) & (self.rnorm > self.atol)

    def cycle(self, A: Callable, mask: torch.Tensor, restart: int,
              host_exits: bool = False) -> None:
        """One restart cycle on the lanes in ``mask``: build the Krylov basis
        with the QR factorization kept up to date by Givens rotations, then
        project.  ``host_exits`` ends the inner loop once no lane is live
        (a host read an iteration)."""
        lanes, n = self.x.shape
        vec = dict(dtype=self.x.dtype, device=self.x.device)
        eps = torch.finfo(self.x.dtype).eps
        V = torch.zeros(lanes, restart + 1, n, **vec)
        V[:, 0] = self.unit
        # eye(): rows the early exit leaves unfilled keep the system regular
        R = torch.eye(restart, restart + 1, **vec).expand(
            lanes, restart, restart + 1).clone()
        givens = torch.zeros(lanes, restart, 2, **vec)
        beta = torch.zeros(lanes, restart + 1, **vec)
        beta[:, 0] = self.rnorm
        err = self.rnorm
        inner = mask
        for k in range(restart):
            inner = inner & (err > self.ptol)
            if host_exits and not bool(inner.any()):
                break
            # the Arnoldi step
            v = A(V[:, k])
            _, v_norm_0 = _safe_normalize(v)
            v, row = _gram_schmidt(V, v)
            unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
            V[:, k + 1] = torch.where(inner[:, None], unit_v, V[:, k + 1])
            row[:, k + 1] = v_norm_1
            for i in range(k):
                _rotate(row, i, givens[:, i, 0], givens[:, i, 1])
            cs, sn = _givens_rotation(row[:, k], row[:, k + 1])
            givens[:, k, 0], givens[:, k, 1] = cs, sn
            _rotate(row, k, cs, sn)
            R[:, k] = torch.where(inner[:, None], row, R[:, k])
            rotated = beta.clone()
            _rotate(rotated, k, cs, sn)
            beta = torch.where(inner[:, None], rotated, beta)
            err = torch.where(inner, beta[:, k + 1].abs(), err)
            self.steps.add_(inner.to(torch.int64))
        y = torch.linalg.solve_triangular(R[:, :, :-1].transpose(1, 2),
                                          beta[:, :-1, None], upper=True)
        x = self.x + (V[:, :-1].transpose(1, 2) @ y)[:, :, 0]
        unit, rnorm = _safe_normalize(self.b - A(x))
        m = mask[:, None]
        self.x.copy_(torch.where(m, x, self.x))
        self.unit.copy_(torch.where(m, unit, self.unit))
        self.rnorm.copy_(torch.where(mask, rnorm, self.rnorm))
        self.cycles.add_(mask.to(torch.int64))


class GmresLanes(NamedTuple):
    """``gmres_lanes``'s result, per lane: the solution (B, n), JAX's info
    (-1 where x holds a NaN, else 0), the restart cycles run and the
    Arnoldi steps taken."""
    x: torch.Tensor
    info: torch.Tensor
    cycles: torch.Tensor
    steps: torch.Tensor


def gmres_lanes(A: Callable, b: torch.Tensor, x0=None, *, tol: float = 1e-5,
                atol: float = 0.0, restart: int = 20,
                maxiter: int | None = None,
                host_exits: bool = False) -> GmresLanes:
    """Solve ``A(x) = b`` for each of the B lanes of ``b`` (B, n) at once;
    ``A`` maps a (B, n) block to one and is lane-separable.  The arguments
    are ``gmres``'s, taken per lane.  With ``host_exits=False`` every loop
    runs its full static count, each lane masked by its own exits (no host
    read); with ``True`` a loop stops once no lane is live.  The results
    are the same either way."""
    with torch.no_grad():
        size = b.shape[1]
        maxiter = 10 * size if maxiter is None else int(maxiter)
        restart = min(int(restart), size)
        carry = GmresCarry(b)
        every = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
        carry.begin(A, b, every, tol=tol, atol=atol, x0=x0)
        for _ in range(maxiter):
            live = carry.live(maxiter)
            if host_exits and not bool(live.any()):
                break
            carry.cycle(A, live, restart, host_exits)
        info = torch.where(torch.isnan(_norm(carry.x)), -1, 0)
    return GmresLanes(carry.x, info, carry.cycles, carry.steps)


def gmres(A: Callable, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
          restart: int = 20, maxiter: int | None = None):
    """Solve ``A(x) = b`` for x; ``A`` maps a pytree shaped like ``b`` to
    one.  Returns ``(x, info)``, info a 0-d tensor: -1 when x holds a NaN,
    else 0 (JAX's convention).  See the module docstring for the
    algorithm and the meaning of ``tol``, ``atol``, ``restart`` and
    ``maxiter``.  The eager route: ``gmres_lanes`` on one lane with its
    exits read on the host."""
    leaves, spec = pytree.tree_flatten(b)
    shapes = [x.shape for x in leaves]
    sizes = [x.numel() for x in leaves]

    def flat(tree):
        return torch.cat([x.reshape(1, -1) for x in pytree.tree_leaves(tree)],
                         dim=1)

    def unflat(v):
        return pytree.tree_unflatten(
            [p.view(s) for p, s in zip(torch.split(v[0], sizes), shapes)],
            spec)

    res = gmres_lanes(lambda v: flat(A(unflat(v))), flat(b),
                      None if x0 is None else flat(x0), tol=tol, atol=atol,
                      restart=restart, maxiter=maxiter, host_exits=True)
    return unflat(res.x), res.info[0]
