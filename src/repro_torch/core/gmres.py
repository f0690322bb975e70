"""Matrix-free restarted GMRES on pytrees of tensors.

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

It works on the flattened vector of the pytree's leaves (one dtype).  The
loop exits are read on the host (one device-to-host read per inner
iteration and per cycle).  No graph is recorded: the implicit solvers never
differentiate through it.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

__all__ = ["gmres"]


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x))


def _safe_normalize(x: torch.Tensor, thresh=None):
    """x / ||x|| and ||x||, or zeros and 0 where ||x|| <= thresh (by default
    the dtype's machine epsilon)."""
    norm = _norm(x)
    if thresh is None:
        thresh = torch.finfo(norm.dtype).eps
    use = norm > thresh
    return torch.where(use, x / norm, 0.0), torch.where(use, norm, 0.0)


def _gram_schmidt(Q: torch.Tensor, x: torch.Tensor):
    """Orthogonalize x against the rows of Q by one classical Gram-Schmidt
    pass.  Returns q and the overlaps h."""
    h = Q @ x
    return x - Q.T @ h, h


def _arnoldi(k: int, A, V: torch.Tensor):
    """The k-th Arnoldi step: writes the new unit Krylov vector into
    ``V[k + 1]`` and returns the Hessenberg column (length restart + 1)."""
    eps = torch.finfo(V.dtype).eps
    v = A(V[k])
    _, v_norm_0 = _safe_normalize(v)
    v, h = _gram_schmidt(V, v)
    unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
    V[k + 1] = unit_v
    h[k + 1] = v_norm_1
    return h


def _rotate(H: torch.Tensor, i: int, cs, sn) -> None:
    x1, y1 = H[i].clone(), H[i + 1].clone()
    H[i] = cs * x1 - sn * y1
    H[i + 1] = sn * x1 + cs * y1


def _givens_rotation(a, b):
    b_zero = b.abs() == 0
    a_lt_b = a.abs() < b.abs()
    t = -torch.where(a_lt_b, a, b) / torch.where(a_lt_b, b, a)
    r = torch.rsqrt(1 + t.abs() ** 2)
    cs = torch.where(b_zero, 1.0, torch.where(a_lt_b, r * t, r))
    sn = torch.where(b_zero, 0.0, torch.where(a_lt_b, r, r * t))
    return cs, sn


def _gmres_cycle(A, b, x0, unit_residual, residual_norm, ptol, restart):
    """One restart cycle: build the Krylov basis with the QR factorization
    kept up to date by Givens rotations, then project."""
    n = b.shape[0]
    V = torch.zeros(restart + 1, n, dtype=b.dtype, device=b.device)
    V[0] = unit_residual
    # eye(): rows the early exit leaves unfilled keep the system regular
    R = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
    givens = torch.zeros(restart, 2, dtype=b.dtype, device=b.device)
    beta = torch.zeros(restart + 1, dtype=b.dtype, device=b.device)
    beta[0] = residual_norm
    k, err = 0, residual_norm
    while k < restart and bool(err > ptol):
        row = _arnoldi(k, A, V)
        for i in range(k):
            _rotate(row, i, givens[i, 0], givens[i, 1])
        cs, sn = _givens_rotation(row[k], row[k + 1])
        givens[k, 0], givens[k, 1] = cs, sn
        _rotate(row, k, cs, sn)
        R[k] = row
        _rotate(beta, k, cs, sn)
        err = beta[k + 1].abs()
        k += 1
    y = torch.linalg.solve_triangular(R[:, :-1].T, beta[:-1, None],
                                      upper=True)[:, 0]
    x = x0 + V[:-1].T @ y
    unit_residual, residual_norm = _safe_normalize(b - A(x))
    return x, unit_residual, residual_norm


def gmres(A: Callable, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
          restart: int = 20, maxiter: int | None = None):
    """Solve ``A(x) = b`` for x; ``A`` maps a pytree shaped like ``b`` to
    one.  Returns ``(x, info)``, info a 0-d tensor: -1 when x holds a NaN,
    else 0 (JAX's convention).  See the module docstring for the
    algorithm and the meaning of ``tol``, ``atol``, ``restart`` and
    ``maxiter``."""
    leaves, spec = pytree.tree_flatten(b)
    shapes = [x.shape for x in leaves]
    sizes = [x.numel() for x in leaves]

    def flat(tree):
        return torch.cat([x.reshape(-1) for x in pytree.tree_leaves(tree)])

    def unflat(v):
        return pytree.tree_unflatten(
            [p.view(s) for p, s in zip(torch.split(v, sizes), shapes)], spec)

    def A_flat(v):
        return flat(A(unflat(v)))

    with torch.no_grad():
        b_vec = flat(b)
        x = torch.zeros_like(b_vec) if x0 is None else flat(x0)
        size = b_vec.numel()
        maxiter = 10 * size if maxiter is None else int(maxiter)
        restart = min(int(restart), size)
        b_norm = _norm(b_vec)
        atol = torch.clamp(tol * b_norm, min=atol)
        ptol = b_norm * torch.clamp(atol / b_norm, max=1.0)

        unit_residual, residual_norm = _safe_normalize(b_vec - A_flat(x))
        k = 0
        while k < maxiter and bool(residual_norm > atol):
            x, unit_residual, residual_norm = _gmres_cycle(
                A_flat, b_vec, x, unit_residual, residual_norm, ptol, restart)
            k += 1
        info = torch.where(torch.isnan(_norm(x)), -1, 0)
    return unflat(x), info
