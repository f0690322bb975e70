"""Binomial (revolve-style) checkpoint scheduling for multistage integrators.

Implements the checkpointing model of the paper (Zhang & Constantinescu,
"Revolve-based adjoint checkpointing for multistage time integration"):

* a checkpoint stores the step state AND the step's stage derivatives
  (N_s + 1 vectors), so the adjoint of a checkpointed step needs no
  recomputation at all;
* during the *forward sweep* up to N_c checkpoints may be placed for free;
* during the *reverse sweep*, freed slots are re-placed while re-advancing.

``optimal_extra_steps(n, c)`` computes the minimal number of recomputed
(extra forward) steps by exact dynamic programming, and Prop. 2 of the paper
gives the closed form it must match (tested in tests/test_revolve.py):

    p~(N_t, N_c) = (t-1) N_t - binom(N_c + t, t - 1) + 1,
    with t the unique integer s.t. binom(N_c+t-1, t-1) < N_t <= binom(N_c+t, t).

The schedule is produced at *trace time* (N_t and N_c are Python ints), so
the reverse pass is unrolled into segments of `lax.scan` — XLA sees a graph
whose live set is exactly the checkpoint set.
"""
from __future__ import annotations

import functools
from math import comb
from typing import List, Tuple

_INF = float("inf")


# ---------------------------------------------------------------------------
# Prop. 2 closed form
# ---------------------------------------------------------------------------

def prop2_optimal_extra_steps(n_t: int, n_c: int) -> int:
    """The paper's Prop. 2 closed form for the minimal recomputation count."""
    if n_t <= 1 or n_c >= n_t - 1:
        return 0
    if n_c == 0:
        # degenerate: only the segment-boundary state is held; classic
        # quadratic sweep (not covered by the binomial formula's domain).
        return n_t * (n_t - 1) // 2 - (n_t - 1)
    t = 1
    while not (comb(n_c + t - 1, t - 1) < n_t <= comb(n_c + t, t)):
        t += 1
        if t > 10_000:  # pragma: no cover
            raise RuntimeError("failed to bracket t in Prop. 2")
    return (t - 1) * n_t - comb(n_c + t, t - 1) + 1


# ---------------------------------------------------------------------------
# exact DP
#
# REV(n, c): segment of n steps whose boundary checkpoint (state + stages of
#   the segment's first step) is held; the forward sweep through the segment
#   has already happened and placed nothing inside; c slots are free.
#   Value = minimal extra forward steps to adjoint the whole segment.
#
# SWEEP(n, c): same, but the forward sweep through the segment has NOT yet
#   happened and may place checkpoints for free as it goes.  This is the
#   top-level problem for the initial forward pass of the ODE solve.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rev(n: int, c: int) -> float:
    if n <= 1:
        return 0.0
    if c <= 0:
        # classic Revolve accounting (and the paper's): re-advancing needs a
        # free slot to hold the advanced-to state, so a segment longer than
        # one step is infeasible with zero free checkpoints.
        return _INF
    best = _INF
    for m in range(1, n):
        cand = m + _rev(n - m, c - 1) + _rev(m, c)
        if cand < best:
            best = cand
    return best


@functools.lru_cache(maxsize=None)
def _rev_argmin(n: int, c: int) -> int:
    best, arg = _INF, 1
    for m in range(1, n):
        cand = m + _rev(n - m, c - 1) + _rev(m, c)
        if cand < best:
            best, arg = cand, m
    return arg


@functools.lru_cache(maxsize=None)
def _sweep(n: int, c: int) -> float:
    if n <= 1:
        return 0.0
    if c <= 0:
        return _INF
    best = _rev(n, c)  # place nothing during the sweep
    for m in range(1, n):
        cand = _sweep(n - m, c - 1) + _rev(m, c)
        if cand < best:
            best = cand
    return best


@functools.lru_cache(maxsize=None)
def _sweep_argmin(n: int, c: int) -> int:
    """0 means 'place nothing'; m>=1 means first sweep checkpoint at m."""
    best, arg = _rev(n, c), 0
    if c >= 1:
        for m in range(1, n):
            cand = _sweep(n - m, c - 1) + _rev(m, c)
            if cand < best:
                best, arg = cand, m
    return arg


def optimal_extra_steps(n_t: int, n_c: int) -> int:
    """Minimal recomputed forward steps (exact DP; == Prop. 2 on its domain)."""
    v = _sweep(n_t, n_c)
    if v == _INF:
        raise ValueError(f"infeasible: n_t={n_t}, n_c={n_c}")
    return int(v)


def sweep_checkpoint_positions(n_t: int, n_c: int) -> List[int]:
    """Positions (step indices) at which the initial forward sweep stores
    checkpoints (state + stages of the step starting there).  Position 0 is
    the segment boundary and is always held implicitly."""
    pos: List[int] = []
    off, n, c = 0, n_t, n_c
    while n > 1:
        m = _sweep_argmin(n, c)
        if m == 0:
            break
        pos.append(off + m)
        off, n, c = off + m, n - m, c - 1
    return pos


# ---------------------------------------------------------------------------
# schedule actions for the reverse pass
# ---------------------------------------------------------------------------
# The reverse executor works on segments between sweep checkpoints, right to
# left.  Within a segment it follows the REV policy recursively.  Actions:
#   ("advance", start, n)   re-run n forward steps from `start`, keeping the
#                           arrival state+stages as a new checkpoint
#   ("adjoint", idx)        adjoint one step at index idx (state+stages held)
# The executor in core/adjoint.py interprets these with traced values; this
# module only decides *what* to do (pure Python ints).


def reverse_schedule(n_t: int, n_c: int) -> List[Tuple]:
    """Full reverse schedule given the sweep placed checkpoints per
    ``sweep_checkpoint_positions``.  Returns a flat action list."""
    actions: List[Tuple] = []

    def rev_segment(start: int, n: int, c: int) -> None:
        # boundary checkpoint at `start` is held (with stages)
        if n <= 0:
            return
        if n == 1:
            actions.append(("adjoint", start))
            return
        if c == 0:  # pragma: no cover — the DP never schedules this
            raise RuntimeError(
                f"infeasible reverse segment: n={n} steps, 0 free slots")
        m = _rev_argmin(n, c)
        actions.append(("advance", start, m))
        rev_segment(start + m, n - m, c - 1)
        actions.append(("free", start + m))
        rev_segment(start, m, c)

    # segments defined by sweep checkpoints
    pos = [0] + sweep_checkpoint_positions(n_t, n_c)
    free_slots = n_c - (len(pos) - 1)  # slots not consumed by the sweep
    # process segments right to left; after each segment its boundary slot frees
    for i in range(len(pos) - 1, -1, -1):
        start = pos[i]
        end = pos[i + 1] if i + 1 < len(pos) else n_t
        rev_segment(start, end - start, free_slots)
        if i > 0:
            actions.append(("free", start))
        free_slots += 1
    return actions


def schedule_extra_steps(actions) -> int:
    """Count recomputed steps in an action list (for tests)."""
    return sum(a[2] for a in actions if a[0] == "advance")
