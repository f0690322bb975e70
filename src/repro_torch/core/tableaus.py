"""Butcher tableaus for the time integrators used in the paper.

Explicit methods: euler, midpoint, heun, bosh3, rk4, dopri5 (with embedded
4th-order solution for adaptivity).  Implicit methods: beuler (backward
Euler), cn (Crank-Nicolson / trapezoid), expressed as theta-methods.

A tableau is a small frozen dataclass of numpy arrays; everything here is
trace-time constant so plain numpy (not jnp) is deliberate.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    name: str
    a: np.ndarray          # (s, s) stage coefficients (strictly lower triangular if explicit)
    b: np.ndarray          # (s,) solution weights
    c: np.ndarray          # (s,) stage times
    b_err: Optional[np.ndarray] = None  # (s,) embedded-solution weights (for adaptivity)
    order: int = 1
    fsal: bool = False     # first-same-as-last (dopri5): stage s of step n == stage 1 of step n+1

    @property
    def num_stages(self) -> int:
        return len(self.b)

    @property
    def explicit(self) -> bool:
        return bool(np.allclose(self.a, np.tril(self.a, -1)))


def _tab(name, a, b, c, b_err=None, order=1, fsal=False):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    if b_err is not None:
        b_err = np.asarray(b_err, dtype=np.float64)
    return ButcherTableau(name=name, a=a, b=b, c=c, b_err=b_err, order=order, fsal=fsal)


EULER = _tab("euler", [[0.0]], [1.0], [0.0], order=1)

MIDPOINT = _tab(
    "midpoint",
    [[0.0, 0.0], [0.5, 0.0]],
    [0.0, 1.0],
    [0.0, 0.5],
    order=2,
)

HEUN = _tab(
    "heun",
    [[0.0, 0.0], [1.0, 0.0]],
    [0.5, 0.5],
    [0.0, 1.0],
    order=2,
)

# Bogacki-Shampine 3(2)
BOSH3 = _tab(
    "bosh3",
    [
        [0.0, 0.0, 0.0, 0.0],
        [1 / 2, 0.0, 0.0, 0.0],
        [0.0, 3 / 4, 0.0, 0.0],
        [2 / 9, 1 / 3, 4 / 9, 0.0],
    ],
    [2 / 9, 1 / 3, 4 / 9, 0.0],
    [0.0, 1 / 2, 3 / 4, 1.0],
    b_err=[7 / 24, 1 / 4, 1 / 3, 1 / 8],
    order=3,
    fsal=True,
)

RK4 = _tab(
    "rk4",
    [
        [0.0, 0.0, 0.0, 0.0],
        [0.5, 0.0, 0.0, 0.0],
        [0.0, 0.5, 0.0, 0.0],
        [0.0, 0.0, 1.0, 0.0],
    ],
    [1 / 6, 1 / 3, 1 / 3, 1 / 6],
    [0.0, 0.5, 0.5, 1.0],
    order=4,
)

# Dormand-Prince 5(4)
DOPRI5 = _tab(
    "dopri5",
    [
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [1 / 5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [3 / 40, 9 / 40, 0.0, 0.0, 0.0, 0.0, 0.0],
        [44 / 45, -56 / 15, 32 / 9, 0.0, 0.0, 0.0, 0.0],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0.0, 0.0, 0.0],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0.0, 0.0],
        [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0],
    ],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0],
    [0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0],
    b_err=[5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40],
    order=5,
    fsal=True,
)

# Theta methods (implicit): u_{n+1} = u_n + h*[(1-theta) f(u_n) + theta f(u_{n+1})]
# theta=1   -> backward Euler
# theta=1/2 -> Crank-Nicolson (trapezoid)
BEULER_THETA = 1.0
CN_THETA = 0.5

EXPLICIT_TABLEAUS = {
    "euler": EULER,
    "midpoint": MIDPOINT,
    "heun": HEUN,
    "bosh3": BOSH3,
    "rk4": RK4,
    "dopri5": DOPRI5,
}

IMPLICIT_METHODS = ("beuler", "cn")


def get_tableau(name: str) -> ButcherTableau:
    try:
        return EXPLICIT_TABLEAUS[name]
    except KeyError:
        raise ValueError(
            f"unknown explicit method {name!r}; available: {sorted(EXPLICIT_TABLEAUS)}"
        ) from None
