"""AdamW with fp32 moments over (possibly lower-precision) params, global-norm
clip and a warmup-cosine schedule: a port of the JAX package's optimizer,
not ``torch.optim.AdamW``, so that the update is the same function.

Params, gradients and moments are pytrees of tensors (nested dicts and
lists); ``update`` is functional and returns new trees.  The step count
and the learning rate are host numbers, so a step never syncs the card.
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

    def update(self, grads, state: AdamWState, params):
        g_leaves = pytree.tree_leaves(grads)
        if self.grad_dtype:
            gd = getattr(torch, self.grad_dtype)
            g_leaves = [g.to(gd) for g in g_leaves]
        g_leaves = [g.to(torch.float32) for g in g_leaves]
        # global-norm clip
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in g_leaves))
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        g_leaves = [g * scale for g in g_leaves]

        step = state.step + 1
        lr = self.schedule(state.step)
        # bias corrections in float32, as the reference computes them
        b1c = float(np.float32(1) - np.float32(self.b1) ** np.float32(step))
        b2c = float(np.float32(1) - np.float32(self.b2) ** np.float32(step))

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
