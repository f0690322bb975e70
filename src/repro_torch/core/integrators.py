"""Explicit Runge-Kutta stepping on pytrees + fixed-step forward solves.

The vector field signature everywhere in this framework is

    f(u, theta, t) -> du/dt

with ``u`` and ``theta`` pytrees of tensors (``torch.utils._pytree``:
tensors, tuples, lists and dicts) and ``t`` a Python float.

``rk_step`` computes one step and returns the stage derivatives so that the
high-level discrete adjoint (``core/adjoint.py``) can reconstruct stage
inputs without re-evaluating ``f`` — the paper's "checkpoint the states
*and stage values*" design (PNODE).  ``rk_adjoint_step`` implements the
discrete adjoint recursion (eq. 7 of the paper): one ``torch.func.vjp`` of
``f`` per stage, so the backpropagation graph depth is O(N_l),
independent of N_t.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.tableaus import ButcherTableau, get_tableau

PyTree = Any
VectorField = Callable[[PyTree, PyTree, float], PyTree]

tree_map = pytree.tree_map  # several trees of one structure: tree_map(fn, a, b)


# ---------------------------------------------------------------------------
# pytree arithmetic helpers
# ---------------------------------------------------------------------------

def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def tree_scale(s, a: PyTree) -> PyTree:
    return tree_map(lambda x: s * x, a)


def tree_axpy(s, x: PyTree, y: PyTree) -> PyTree:
    """y + s * x elementwise over the pytree (a multiply, then an add)."""
    return tree_map(lambda xi, yi: yi + s * xi, x, y)


def tree_zeros_like(a: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, a)


def tree_stage_lincomb(base: PyTree, pairs, scale=None,
                       base_coeff: float | None = None,
                       fused: bool = False) -> PyTree:
    """``base_coeff*base + sum (scale*w_i) * tree_i`` over (w_i, tree_i)
    ``pairs`` — the RK stage-update / stage-adjoint primitive.

    ``fused=False`` is one ``tree_axpy`` per pair.  ``fused=True`` makes the
    whole combination ONE launch of the Hopper kernel per leaf
    (``kernels.ops.fused_lincomb``; the plain version on CPU tensors) with
    the same accumulation order, so results are bitwise-identical on one
    device.  Callers must already have dropped zero-weight pairs.  No
    pairs means no launch.
    """
    if not fused:
        out = base if base_coeff is None else tree_scale(base_coeff, base)
        for w, tr in pairs:
            out = tree_axpy(w if scale is None else scale * w, tr, out)
        return out
    from repro_torch.kernels.ops import fused_lincomb
    weights = [w for w, _ in pairs]
    terms = [t for _, t in pairs]
    if not terms:
        return base if base_coeff is None else tree_scale(base_coeff, base)

    def leaf(b, *ts):
        if b.numel() == 0:  # degenerate leaf: nothing to fuse
            out = b if base_coeff is None else base_coeff * b
            for w, t in zip(weights, ts):
                out = out + (w if scale is None else scale * w) * t
            return out
        # the kernel takes contiguous leaves; autograd may hand the reverse
        # sweep an expanded gradient (of a sum, say), which is copied here
        # once (.contiguous() is a no-op on a contiguous leaf)
        return fused_lincomb(b.contiguous(), [t.contiguous() for t in ts],
                             weights, scale, base_coeff)

    return tree_map(leaf, base, *terms)


def tree_stack(trees) -> PyTree:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_unstack(tree, n) -> list:
    return [tree_map(lambda x: x[i], tree) for i in range(n)]


def tree_dot(a: PyTree, b: PyTree) -> torch.Tensor:
    """sum over leaves of sum(a * b), the leaves added left to right."""
    parts = [torch.sum(x * y) for x, y in zip(pytree.tree_leaves(a),
                                              pytree.tree_leaves(b))]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def tree_norm(a: PyTree) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a))


# ---------------------------------------------------------------------------
# explicit RK stepping
# ---------------------------------------------------------------------------

def rk_stages(f: VectorField, tab: ButcherTableau, u: PyTree, theta: PyTree,
              t, h, fused: bool = False) -> list:
    """Compute the stage derivatives k_1..k_s (list of pytrees).
    ``fused=True`` builds each stage input with one lincomb kernel launch
    per leaf instead of a tree_axpy chain (bitwise-identical)."""
    ks: list = []
    for i in range(tab.num_stages):
        pairs = [(float(tab.a[i, j]), ks[j]) for j in range(i)
                 if float(tab.a[i, j]) != 0.0]
        xi = tree_stage_lincomb(u, pairs, scale=h, fused=fused)
        ks.append(f(xi, theta, t + float(tab.c[i]) * h))
    return ks


def rk_combine(tab: ButcherTableau, u: PyTree, ks, h,
               fused: bool = False) -> PyTree:
    """u + h * sum_i b_i k_i."""
    pairs = [(float(tab.b[i]), ks[i]) for i in range(tab.num_stages)
             if float(tab.b[i]) != 0.0]
    return tree_stage_lincomb(u, pairs, scale=h, fused=fused)


def rk_step(f: VectorField, tab: ButcherTableau, u: PyTree, theta: PyTree,
            t, h, fused: bool = False) -> Tuple[PyTree, PyTree]:
    """One explicit RK step.  Returns (u_next, stages) with stages stacked
    along a new leading axis of size N_s (the checkpoint layout)."""
    ks = rk_stages(f, tab, u, theta, t, h, fused=fused)
    u_next = rk_combine(tab, u, ks, h, fused=fused)
    return u_next, tree_stack(ks)


def rk_stage_inputs(tab: ButcherTableau, u: PyTree, stages: PyTree, h,
                    fused: bool = False) -> list:
    """Reconstruct the stage inputs x_i = u + h*sum_j a_ij k_j from stored
    stage derivatives — no f evaluations (the PNODE trick)."""
    ks = tree_unstack(stages, tab.num_stages)
    xs = []
    for i in range(tab.num_stages):
        pairs = [(float(tab.a[i, j]), ks[j]) for j in range(i)
                 if float(tab.a[i, j]) != 0.0]
        xs.append(tree_stage_lincomb(u, pairs, scale=h, fused=fused))
    return xs


def rk_adjoint_step(f: VectorField, tab: ButcherTableau, u: PyTree,
                    stages: PyTree, theta: PyTree, t, h,
                    lam: PyTree, fused: bool = False) -> Tuple[PyTree, PyTree]:
    """Discrete adjoint of one explicit RK step (the paper's eq. 7).

    Given the step's initial state ``u``, its stored stage derivatives, and
    the incoming adjoint ``lam`` (= lambda_{n+1}), returns

        lam_prev  = (d u_{n+1} / d u_n)^T lam
        theta_bar = (d u_{n+1} / d theta)^T lam     (increment for mu)

    Implementation: reverse stage recursion
        v_i     = b_i * lam + sum_{j>i} a_ji * w_j
        (w_i, g_i) = vjp(f, x_i)(h * v_i)        # one torch.func.vjp per stage
        lam_prev = lam + sum_i w_i
        theta_bar = sum_i g_i
    """
    s = tab.num_stages
    xs = rk_stage_inputs(tab, u, stages, h, fused=fused)
    ws: list = [None] * s
    lam_prev = lam
    theta_bar = None
    for i in reversed(range(s)):
        if float(tab.b[i]) == 0.0 and all(
            float(tab.a[j, i]) == 0.0 for j in range(i + 1, s)
        ):
            ws[i] = None
            continue
        pairs = [(float(tab.a[j, i]), ws[j]) for j in range(i + 1, s)
                 if float(tab.a[j, i]) != 0.0 and ws[j] is not None]
        vi = tree_stage_lincomb(lam, pairs, base_coeff=float(tab.b[i]),
                                fused=fused)
        ti = t + float(tab.c[i]) * h
        _, vjp_fn = torch.func.vjp(lambda uu, th: f(uu, th, ti), xs[i], theta)
        wi, gi = vjp_fn(tree_scale(h, vi))
        ws[i] = wi
        lam_prev = tree_add(lam_prev, wi)
        theta_bar = gi if theta_bar is None else tree_add(theta_bar, gi)
    if theta_bar is None:
        theta_bar = tree_zeros_like(theta)
    return lam_prev, theta_bar


# ---------------------------------------------------------------------------
# fixed-step forward solves
# ---------------------------------------------------------------------------

def solve_fixed(f: VectorField, method: str, u0: PyTree, theta: PyTree,
                t0: float, h: float, n_steps: int,
                save_states: bool = False,
                save_stages: bool = False,
                fused: bool = False):
    """Integrate n_steps of size h with a fixed-step explicit RK method.

    Returns (u_final, saved) where ``saved`` is a dict possibly containing
    'states' (list of the N_t *pre-step* states u_0..u_{N_t-1}) and
    'stages' (list of N_t stacked stage pytrees).  Step n starts at
    ``t0 + n * h``, computed as a Python double.
    """
    tab = get_tableau(method)
    saved: dict = {}
    if save_states:
        saved["states"] = []
    if save_stages:
        saved["stages"] = []
    u = u0
    for n in range(n_steps):
        t = t0 + float(n) * h
        u_next, stages = rk_step(f, tab, u, theta, t, h, fused=fused)
        if save_states:
            saved["states"].append(u)
        if save_stages:
            saved["stages"].append(stages)
        u = u_next
    return u, saved


def solve_fixed_trajectory(f: VectorField, method: str, u0: PyTree,
                           theta: PyTree, t0: float, h: float, n_steps: int):
    """Like solve_fixed but returns the full trajectory u_1..u_{N_t}
    (stacked along a new leading axis), for plotting / loss-over-trajectory."""
    tab = get_tableau(method)
    traj = []
    u = u0
    for n in range(n_steps):
        u, _ = rk_step(f, tab, u, theta, t0 + float(n) * h, h)
        traj.append(u)
    return u, tree_stack(traj)
