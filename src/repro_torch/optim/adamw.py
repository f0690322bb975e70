"""AdamW with fp32 moments over (possibly lower-precision) params, global-norm
clip and a warmup-cosine schedule: a port of the JAX package's optimizer,
not ``torch.optim.AdamW``, so that the update is the same function.

Params, gradients and moments are pytrees of tensors (nested dicts and
lists); ``update`` is functional and returns new trees.  ``update_`` is
the donated form (the JAX package's jitted step with ``donate_argnums``):
it writes the params and the moments in place, leaf by leaf, with the same
operations in the same order, so its bits are ``update``'s while it holds
one leaf's temporaries instead of a second tree of moments.  The step
count and the learning rate are host numbers, so a step never syncs the
card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    # cast gradients to this dtype (a config dtype name, e.g. "bfloat16")
    # and back to fp32 before the clip, as the JAX package does ahead of
    # its cross-pod reduction
    grad_dtype: str | None = None

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return AdamWState(step=0, m=pytree.tree_map(zeros, params),
                          v=pytree.tree_map(zeros, params))

    def schedule(self, step: int) -> float:
        warm = min(1.0, (step + 1) / max(1, self.warmup_steps))
        prog = min(max((step - self.warmup_steps)
                       / max(1, self.total_steps - self.warmup_steps), 0.0),
                   1.0)
        cos = 0.5 * (1 + math.cos(math.pi * prog))
        frac = self.min_lr_frac + (1 - self.min_lr_frac) * cos
        return self.lr * warm * frac

    def _grad32(self, g: torch.Tensor) -> torch.Tensor:
        """A gradient leaf as the update sees it before the clip: through
        ``grad_dtype`` when set, then fp32."""
        if self.grad_dtype:
            g = g.to(getattr(torch, self.grad_dtype))
        return g.to(torch.float32)

    def _step_terms(self, step: int):
        """(lr, b1c, b2c) of the update that makes ``step``: the bias
        corrections in float32, as the reference computes them."""
        b1c = float(np.float32(1) - np.float32(self.b1) ** np.float32(step))
        b2c = float(np.float32(1) - np.float32(self.b2) ** np.float32(step))
        return self.schedule(step - 1), b1c, b2c

    def update(self, grads, state: AdamWState, params):
        g_leaves = [self._grad32(g) for g in pytree.tree_leaves(grads)]
        # global-norm clip
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in g_leaves))
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        g_leaves = [g * scale for g in g_leaves]

        step = state.step + 1
        lr, b1c, b2c = self._step_terms(step)

        p_leaves, spec = pytree.tree_flatten(params)
        m_leaves = [self.b1 * m_ + (1 - self.b1) * g for m_, g in
                    zip(pytree.tree_leaves(state.m), g_leaves)]
        v_leaves = [self.b2 * v_ + (1 - self.b2) * g * g for v_, g in
                    zip(pytree.tree_leaves(state.v), g_leaves)]

        def upd(p, m_, v_):
            mh = m_ / b1c
            vh = v_ / b2c
            u = mh / (torch.sqrt(vh) + self.eps) + self.weight_decay \
                * p.to(torch.float32)
            return (p.to(torch.float32) - lr * u).to(p.dtype)

        new_params = [upd(p, m_, v_)
                      for p, m_, v_ in zip(p_leaves, m_leaves, v_leaves)]
        unflat = lambda xs: pytree.tree_unflatten(xs, spec)
        return (unflat(new_params),
                AdamWState(step=step, m=unflat(m_leaves), v=unflat(v_leaves)),
                {"grad_norm": gnorm, "lr": lr})

    def update_(self, grads, state: AdamWState, params, *, decode=None):
        """``update`` in place: the params and ``state``'s moments are
        overwritten; returns (params, the new state over the same moment
        tensors, metrics).  Bitwise ``update``: the clip's norm sums the
        leaves' squares in ``update``'s order in a first pass, then each
        leaf is cast, scaled and applied in a second pass, rounding every
        operation as ``update`` does (no ``alpha=``, ``addcmul_`` or
        ``lerp_``: they contract to an FMA on the card), its temporaries
        freed before the next leaf.

        ``grads`` is a tree like ``params``; with ``decode`` it is the list
        of ``tree_leaves(params)``'s gradients in some encoded form, and
        ``decode(leaf)`` gives each one (e.g. int8's dequantization)."""
        p_leaves = pytree.tree_leaves(params)
        g_leaves = list(grads) if decode is not None \
            else pytree.tree_leaves(grads)
        if len(g_leaves) != len(p_leaves):
            raise ValueError(f"{len(g_leaves)} gradient leaves for "
                             f"{len(p_leaves)} parameters")
        dec = decode or (lambda g: g)

        def grad32(g):
            return self._grad32(dec(g))

        # global-norm clip: the squares' sums in update's order
        gnorm = torch.sqrt(sum(torch.sum(torch.square(grad32(g)))
                               for g in g_leaves))
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)

        step = state.step + 1
        lr, b1c, b2c = self._step_terms(step)
        for p, g, m_, v_ in zip(p_leaves, g_leaves,
                                pytree.tree_leaves(state.m),
                                pytree.tree_leaves(state.v), strict=True):
            g = grad32(g) * scale
            t = (1 - self.b1) * g
            m_.mul_(self.b1).add_(t)
            t = (1 - self.b2) * g
            t.mul_(g)
            v_.mul_(self.b2).add_(t)
            del g, t
            u = m_ / b1c
            den = v_ / b2c
            den.sqrt_().add_(self.eps)
            u.div_(den)
            del den
            pf = p.to(torch.float32)
            u.add_(self.weight_decay * pf)
            u.mul_(lr)
            if pf is p:                       # fp32 params: in place
                p.sub_(u)
            else:
                p.copy_(pf.sub_(u))
            del u, pf
        return (params, AdamWState(step=step, m=state.m, v=state.v),
                {"grad_norm": gnorm, "lr": lr})
