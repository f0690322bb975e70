"""Top-k token-choice MoE, the port of ``repro/nn/moe.py``.

The function is the JAX package's, decision for decision: fp32 router
logits, softmax, top-k (ties to the lower expert index, as
``jax.lax.top_k``), the k gates renormalised by ``max(sum, 1e-9)``; the
Switch aux loss ``E * sum_e mean_t(p_e) * count_e / (T k)`` over every
choice, dropped ones included; contiguous token groups of
``_group_size`` tokens, each expert taking at most
``cap = int(max(k, cf * k * g / E))`` (token, slot) pairs a group, placed
in token-major, slot-minor order, so that a token's second choice queues
behind every earlier token's choices; the experts' GLU
``act(x W_gate) * (x W_up) W_down`` in the compute dtype; the output the
sum of each kept pair's expert output times its gate (cast to the compute
dtype, as the reference's combine mask is).

What differs is the formulation.  The reference dispatches with dense
(G, S, E, C) masks; at a dropless prefill of 16,384 tokens those would
build 7.5 GB intermediates and run 8x the routed rows' expert FLOPs.  Here
dispatch and combine are row gathers (``_Rows``) over one of two layouts:

* ``"slots"`` (training, decode): one row a (expert, group, capacity
  slot), ``E * G * cap`` rows, empty slots zero; the experts run as one
  ``bmm``.  Static shapes, no host read: a CUDA graph captures it.
* ``"sorted"`` (prefill): only the kept pairs, stably sorted by expert;
  one GEMM an expert over its rows.  Reads the E counts on the host once.

Both directions of each gather are gathers: the backward of a dispatch
sums a token's k slot rows in a fixed order and the backward of a combine
reads each slot's one pair, so no float atomics run and the gradient is
the same bits call after call (the depth remat policies stay bitwise).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import glu_mlp, normal


def init_moe(gen, d_model: int, d_ff: int, n_experts: int,
             dtype=torch.float32, *, device="cpu", lead=()):
    """The reference's layout: ``w_router`` (D, E) fp32, ``w_gate`` and
    ``w_up`` (E, D, F), ``w_down`` (E, F, D), each with ``lead`` axes in
    front (the depth stack's units)."""
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {
        "w_router": normal(gen, (*lead, d_model, n_experts), s_in,
                           torch.float32, device),
        "w_gate": normal(gen, (*lead, n_experts, d_model, d_ff), s_in, dtype,
                         device),
        "w_up": normal(gen, (*lead, n_experts, d_model, d_ff), s_in, dtype,
                       device),
        "w_down": normal(gen, (*lead, n_experts, d_ff, d_model), s_out,
                         dtype, device),
    }


def _group_size(t: int, requested: int) -> int:
    g = min(requested, t)
    while t % g:
        g -= 1
    return g


class Routing(NamedTuple):
    """One block's routing.  ``idx``/``gates``/``keep``/``pos`` are (T, K):
    each (token, slot) pair's expert, renormalised gate (differentiable),
    whether it fits its expert's capacity in its group, and its place in
    that queue; ``cum`` is (G, S*K, E), the inclusive count of each
    expert's pairs along a group."""
    idx: torch.Tensor
    gates: torch.Tensor
    keep: torch.Tensor
    pos: torch.Tensor
    cum: torch.Tensor
    aux: torch.Tensor
    group: int
    cap: int


def _top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.lax.top_k``'s indices: by descending value, ties to the lower
    index (``argmax`` returns the first maximum; k rounds, each masking the
    chosen expert).  ``torch.topk`` promises no order among ties."""
    p = probs.detach()
    out = []
    for _ in range(k):
        i = p.argmax(dim=-1)
        out.append(i)
        p = p.masked_fill(F.one_hot(i, p.shape[-1]).bool(), -math.inf)
    return torch.stack(out, dim=-1)


def route(w_router: torch.Tensor, xf: torch.Tensor, *, n_experts: int,
          top_k: int, capacity_factor: float,
          group_size: int = 1024) -> Routing:
    """The reference's routing of ``xf`` (T, D) (``repro/nn/moe.py``
    :56-84)."""
    t, e = xf.shape[0], n_experts
    # the reference's ``xf.astype(float32) @ w_router``: x rounded to fp32,
    # then both promoted to the wider type (fp64 under x64 with an fp64
    # router)
    dt = torch.promote_types(torch.float32, w_router.dtype)
    logits = xf.to(torch.float32).to(dt) @ w_router.to(dt)
    probs = torch.softmax(logits, dim=-1)
    idx = _top_k(probs, top_k)
    onehot = F.one_hot(idx, e)                                 # (T, K, E)
    # the chosen probabilities as a masked sum (adds exact zeros): its
    # gradient is a product, where a gather's would scatter
    gates = (probs[:, None, :] * onehot.to(probs.dtype)).sum(-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    counts = onehot.sum((0, 1)).float()
    aux = e * torch.sum(probs.mean(dim=0) * (counts / (t * top_k)))

    g_sz = _group_size(t, group_size)
    g = t // g_sz
    cap = int(max(top_k, capacity_factor * top_k * g_sz / e))
    oh = onehot.reshape(g, g_sz * top_k, e)
    cum = oh.cumsum(dim=1)
    pos = ((cum - oh) * oh).sum(-1).reshape(t, top_k)
    return Routing(idx=idx, gates=gates, keep=pos < cap, pos=pos, cum=cum,
                   aux=aux, group=g, cap=cap)


class _Rows(torch.autograd.Function):
    """``out[i] = src[fwd[i]]``, where index ``len(src)`` reads a row of
    zeros.  The gradient of ``src`` row r is the sum along ``bwd``'s second
    axis of the output gradient's rows ``bwd[r, :]`` (index ``len(out)``
    reads zeros): every output row that read r, in a fixed order."""

    @staticmethod
    def forward(ctx, src, fwd, bwd):
        ctx.save_for_backward(bwd)
        pad = torch.cat([src, src.new_zeros(1, src.shape[1])])
        return pad.index_select(0, fwd)

    @staticmethod
    def backward(ctx, grad):
        (bwd,) = ctx.saved_tensors
        pad = torch.cat([grad, grad.new_zeros(1, grad.shape[1])])
        rows = pad.index_select(0, bwd.reshape(-1))
        return rows.view(*bwd.shape, -1).sum(1), None, None


def _slot_maps(r: Routing, t: int, top_k: int, n_experts: int):
    """Slot s = (e G + g) cap + c holds the (c+1)-th pair of expert e in
    group g.  Returns (pair_slot (P,), slot_pair (N,)): each pair's slot
    (N where dropped) and each slot's pair (P where empty)."""
    g, cap, e = r.group, r.cap, n_experts
    sk = t * top_k // g
    n, p = e * g * cap, t * top_k
    dev = r.idx.device
    gi = torch.arange(g, device=dev)
    slot = ((r.idx.reshape(g, sk) * g + gi[:, None]) * cap
            + r.pos.reshape(g, sk))
    pair_slot = torch.where(r.keep.reshape(g, sk), slot, n).reshape(p)
    # the (c+1)-th pair of expert e in group g is where the inclusive
    # count first reaches c + 1
    seq = r.cum.transpose(1, 2).contiguous()                   # (G, E, SK)
    want = torch.arange(1, cap + 1, device=dev).expand(g, e, cap)
    at = torch.searchsorted(seq, want.contiguous())            # (G, E, cap)
    slot_pair = torch.where(at < sk, at + (gi * sk)[:, None, None], p)
    return pair_slot, slot_pair.transpose(0, 1).reshape(n)


def _experts(params, j=None):
    """The GLU weights of every expert (stacked: ``bmm`` over E) or of
    expert ``j``."""
    return {n: params[n] if j is None else params[n][j]
            for n in ("w_gate", "w_up", "w_down")}


def _combine(r: Routing, yg: torch.Tensor, t: int, top_k: int, cdt):
    """sum_j gate_j * y_j a token: the gates in the compute dtype, the
    products and the sum in fp32 at least (the reference's einsum
    accumulates), the result in the compute dtype.  Dropped pairs read
    zero rows."""
    acc = torch.promote_types(cdt, torch.float32)
    w = r.gates.to(cdt).to(acc)
    return (w[..., None] * yg.view(t, top_k, -1).to(acc)).sum(1).to(cdt)


def moe_block(params, x: torch.Tensor, *, n_experts: int, top_k: int,
              act: str = "silu", capacity_factor: float = 1.25,
              group_size: int = 1024, dispatch: str = "slots"):
    """x: (B, S, D) -> ((B, S, D), aux loss).  ``dispatch`` picks the
    layout (the module's note): ``"slots"`` for static shapes, ``"sorted"``
    for the routed rows only (one host read)."""
    b, s, d = x.shape
    t, k, e = b * s, top_k, n_experts
    xf = x.reshape(t, d)
    cdt = x.dtype
    r = route(params["w_router"], xf, n_experts=e, top_k=k,
              capacity_factor=capacity_factor, group_size=group_size)
    if dispatch == "slots":
        pair_slot, slot_pair = _slot_maps(r, t, k, e)
        n = slot_pair.shape[0]
        buf = _Rows.apply(xf, slot_pair // k, pair_slot.view(t, k))
        y = glu_mlp(_experts(params), buf.view(e, n // e, d),
                    act).reshape(n, d)
        yg = _Rows.apply(y, pair_slot, slot_pair.view(n, 1))
    elif dispatch == "sorted":
        p = t * k
        key = torch.where(r.keep, r.idx, e).reshape(p)
        order = torch.sort(key, stable=True).indices           # kept first
        counts = (key[:, None] == torch.arange(e, device=x.device)).sum(0)
        counts = counts.tolist()                               # host read
        rows = order[:sum(counts)]
        inv = torch.argsort(order)
        pair_row = torch.where(inv < rows.shape[0], inv, rows.shape[0])
        buf = _Rows.apply(xf, rows // k, pair_row.view(t, k))
        y = torch.cat([glu_mlp(_experts(params, j), h, act) for j, h in
                       enumerate(torch.split(buf, counts))])
        yg = _Rows.apply(y, pair_row, rows.view(-1, 1))
    else:
        raise ValueError(f"dispatch {dispatch!r}: 'slots' or 'sorted'")
    out = _combine(r, yg, t, k, cdt)
    return out.reshape(b, s, d), r.aux


def moe_plain(params, x: torch.Tensor, r: Routing, act: str = "silu"):
    """The plain version the block is held to: a per-expert loop in fp32
    over the tokens that ``r`` routes to each expert and keeps (host
    reads), weighted by the fp32 gates.  Returns (B, S, D) fp32."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d).float()
    out = torch.zeros_like(xf)
    for j in range(params["w_gate"].shape[0]):
        hit = (r.idx == j) & r.keep                            # (T, K)
        tok = hit.any(-1).nonzero()[:, 0]
        if tok.numel() == 0:
            continue
        w = (r.gates.detach() * hit).sum(-1)[tok]
        y = glu_mlp({n: w.float() for n, w in _experts(params, j).items()},
                    xf[tok], act)
        out[tok] += w[:, None] * y
    return out.reshape(b, s, d)
