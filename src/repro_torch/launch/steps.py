"""Step functions (train / prefill / decode), the port of
``repro/launch/steps.py``: pure functions of the config, called eagerly
(the JAX package jits them; ``launch/train.py`` and ``serve/`` call these).
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamW, AdamWState

_COMPRESS_TODO = ("gradient compression is not ported yet "
                  "(optim/compress.py, ROADMAP Queue 1 item 13)")


def global_grad_norm(grads) -> torch.Tensor:
    """Global L2 norm over every leaf: the per-step gradient-health scalar
    the metrics sink records."""
    leaves = pytree.tree_leaves(grads)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


def value_and_grad(cfg: ModelConfig, params, batch):
    """(loss, metrics, grads) of ``lm.loss_fn`` at ``params``: the grads
    are a tree like ``params``, each leaf in its parameter's dtype."""
    leaves, spec = pytree.tree_flatten(params)
    req = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = lm.loss_fn(cfg, pytree.tree_unflatten(req, spec), batch)
    grads = torch.autograd.grad(loss, req)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, pytree.tree_unflatten(list(grads), spec)


def make_train_step(cfg: ModelConfig, opt: AdamW, accum: int = 1,
                    compress: str | None = None, sentinel: bool = False):
    """Returns train_step(params, opt_state, batch, step, poison=False) ->
    (params, opt_state, metrics).  ``accum > 1`` splits the batch into
    ``accum`` microbatches along its first axis and sums their gradients
    and losses in order (fp32), then divides: live activation memory
    scales with B/accum.

    ``sentinel=True`` adds the non-finite step sentinel: ``poison`` (the
    fault-injection hook, a host bool) adds NaN to the loss and to every
    gradient; a poisoned or naturally non-finite loss/grad commits
    nothing: the new params and moments are selected leaf by leaf with
    ``torch.where`` against the old ones, and the optimizer's step count
    (a host int here, selected in-graph in JAX) does not advance, for which
    the step reads its finite flag once.  ``metrics["nonfinite"]`` reports
    the skip.  With no poison and finite grads the new params are bitwise
    those of a step without the sentinel.

    ``compress``: None and "none" run; "bf16" and "int8" are not ported yet
    (``NotImplementedError``, ROADMAP Queue 1 item 13); anything else is
    the JAX package's ``ValueError``."""
    if compress not in (None, "none", "bf16", "int8"):
        raise ValueError(f"unknown compression scheme {compress!r}; "
                         "one of (None, 'none', 'bf16', 'int8')")
    if compress in ("bf16", "int8"):
        raise NotImplementedError(f"compress={compress!r}: {_COMPRESS_TODO}")

    def grads_of(params, batch):
        if accum == 1:
            loss, metrics, grads = value_and_grad(cfg, params, batch)
            return loss, metrics, grads
        micro = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                 for k, v in batch.items()}
        gsum = pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        lsum = 0.0
        for i in range(accum):
            loss, _, g = value_and_grad(
                cfg, params, {k: v[i] for k, v in micro.items()})
            gsum = pytree.tree_map(torch.add, gsum, g)
            lsum = lsum + loss
        return lsum / accum, {}, pytree.tree_map(lambda g: g / accum, gsum)

    def train_step(params, opt_state: AdamWState, batch, step, poison=False):
        loss, metrics, grads = grads_of(params, batch)
        if sentinel and poison:
            loss = loss + float("nan")
            grads = pytree.tree_map(lambda g: g + float("nan"), grads)
        new_params, new_state, opt_metrics = opt.update(grads, opt_state,
                                                        params)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        if "grad_norm" not in metrics:
            metrics["grad_norm"] = global_grad_norm(grads)
        if sentinel:
            ok = torch.isfinite(loss)
            for g in pytree.tree_leaves(grads):
                ok = ok & torch.isfinite(g).all()

            def keep(new, old):
                return pytree.tree_map(
                    lambda a, b: torch.where(ok, a, b), new, old)

            committed = bool(ok)  # the host count: one read a step
            new_params = keep(new_params, params)
            new_state = AdamWState(
                step=new_state.step if committed else opt_state.step,
                m=keep(new_state.m, opt_state.m),
                v=keep(new_state.v, opt_state.v))
            metrics["nonfinite"] = (~ok).to(torch.int32)
        return new_params, new_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    def prefill_step(params, batch):
        return lm.prefill(cfg, params, batch, max_seq)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, state, token, pos):
        return lm.decode_step(cfg, params, state, token, pos)

    return decode_step
