"""Vector-field networks for the paper's experiments.

Three families, matching §5 of the paper:
  * ``mlp_vf``      — small MLP f(u, t): Robertson / stiff-dynamics learning
                      (5 hidden GELU layers, as in Kim et al. / the paper).
  * ``cnf_vf``      — concatsquash-style MLP used by FFJORD CNF density
                      estimation (hidden widths from the FFJORD configs).
  * ``conv_vf``     — 3x3 conv ODE block for image classification
                      (SqueezeNext-style channel mixing), NHWC layout.

All are plain functions with the framework-wide vector-field signature
``f(u, theta, t) -> du/dt``; ``theta`` is a nested dict of tensors made by
the matching ``*_init`` from a ``torch.Generator``.  Layouts at these
functions are the JAX package's (images NHWC, dense ``w`` as (d_in, d_out))
except conv kernels, which are stored OIHW as ``torch.nn.functional.conv2d``
takes them (``repro_torch.convert`` carries JAX weights across).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

_ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "tanh": torch.tanh,
    "silu": F.silu,
    # jax.nn.softplus is logaddexp(x, 0); F.softplus switches to x above 20
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "relu": F.relu,
}


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  The port runs on the card unless
    the caller asks for the CPU, so a missing card is an error, never a
    silent fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return device


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    # drawn on the generator's (CPU) device, then moved: the same seed gives
    # the same weights on the card and on the CPU
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device)


def _dense_init(gen, d_in: int, d_out: int, device, scale: float | None = None):
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    return {"w": scale * _randn(gen, (d_in, d_out), device),
            "b": torch.zeros((d_out,), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# MLP vector field (Robertson / stiff dynamics)
# ---------------------------------------------------------------------------

def mlp_vf_init(gen: torch.Generator, dim: int, hidden: int = 50,
                n_hidden: int = 5, *, device="cuda"):
    device = resolve_device(device)
    sizes = [dim] + [hidden] * n_hidden + [dim]
    layers = [_dense_init(gen, sizes[i], sizes[i + 1], device)
              for i in range(len(sizes) - 1)]
    # near-zero last layer: f ~ 0 at init so the ODE starts near-identity
    layers[-1]["w"] = layers[-1]["w"] * 1e-2
    return {"layers": layers}


def mlp_vf(u, theta, t, act: str = "gelu"):
    """f(u, theta, t) for a plain MLP; u may be (D,) or (B, D)."""
    a = _ACTS[act]
    x = u
    layers = theta["layers"]
    for lyr in layers[:-1]:
        x = a(x @ lyr["w"] + lyr["b"])
    lyr = layers[-1]
    return x @ lyr["w"] + lyr["b"]


# ---------------------------------------------------------------------------
# concatsquash MLP (FFJORD CNF)
# ---------------------------------------------------------------------------

def cnf_vf_init(gen: torch.Generator, dim: int,
                hidden: Sequence[int] = (64, 64, 64), *, device="cuda"):
    """FFJORD concatsquash layers: y = (Wx+b) * sigmoid(a_t t + c) + g_t t."""
    device = resolve_device(device)
    sizes = [dim] + list(hidden) + [dim]
    layers = []
    for i in range(len(sizes) - 1):
        lyr = _dense_init(gen, sizes[i], sizes[i + 1], device)
        for name in ("t_gate", "t_gate_b", "t_bias"):
            lyr[name] = torch.zeros((sizes[i + 1],), dtype=torch.float32,
                                    device=device)
        layers.append(lyr)
    layers[-1]["w"] = layers[-1]["w"] * 1e-2
    return {"layers": layers}


def _f32_time(t):
    """t rounded to float32, as the reference casts it (even under x64).
    A Python float stays a Python float (the f32 value, exactly), so no
    scalar tensor is copied to the card per call."""
    if torch.is_tensor(t):
        return t.to(torch.float32)
    return float(np.float32(t))


def cnf_vf(u, theta, t, act: str = "tanh"):
    a = _ACTS[act]
    x = u
    t = _f32_time(t)
    layers = theta["layers"]
    for i, lyr in enumerate(layers):
        y = x @ lyr["w"] + lyr["b"]
        gate = torch.sigmoid(lyr["t_gate"] * t + lyr["t_gate_b"])
        y = y * gate + lyr["t_bias"] * t
        x = a(y) if i < len(layers) - 1 else y
    return x


# ---------------------------------------------------------------------------
# conv vector field + classifier head (image classification, §5.1)
# ---------------------------------------------------------------------------

def _conv_init(gen, kh: int, kw: int, c_in: int, c_out: int, device):
    scale = (1.0 / (kh * kw * c_in)) ** 0.5
    return {"w": scale * _randn(gen, (c_out, c_in, kh, kw), device),
            "b": torch.zeros((c_out,), dtype=torch.float32, device=device)}


def _conv(p, x):
    """3x3 stride-1 'SAME' conv on NHWC x with an OIHW kernel; the bias is
    added after the conv, as the reference does.  The NCHW view of a
    contiguous NHWC tensor is channels_last, which the conv keeps; the
    result is made contiguous NHWC (a no-op when it already is), as the
    fused stage kernel takes only contiguous leaves."""
    w = p["w"]
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=w.shape[-1] // 2)
    return (y.permute(0, 2, 3, 1) + p["b"]).contiguous()


def conv_vf_init(gen: torch.Generator, channels: int, *, device="cuda"):
    device = resolve_device(device)
    p = {"conv1": _conv_init(gen, 3, 3, channels + 1, channels, device),
         "conv2": _conv_init(gen, 3, 3, channels + 1, channels, device),
         "gn_scale": torch.ones((channels,), dtype=torch.float32,
                                device=device),
         "gn_bias": torch.zeros((channels,), dtype=torch.float32,
                                device=device)}
    p["conv2"]["w"] = p["conv2"]["w"] * 1e-2
    return p


def _group_norm(x, scale, bias, groups: int = 8):
    """Consecutive-channel groups, min(8, C) of them, biased variance,
    eps 1e-5 (the reference's NHWC group norm)."""
    b, h, w, c = x.shape
    g = min(groups, c)
    xg = x.reshape(b, h, w, g, c // g)
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), keepdim=True, correction=0)
    xg = (xg - mu) / torch.sqrt(var + 1e-5)
    return xg.reshape(b, h, w, c) * scale + bias


def _time_channel(t, u):
    b, h, w, _ = u.shape
    if torch.is_tensor(t):
        return t.to(u.dtype).expand(b, h, w, 1)
    return u.new_full((b, h, w, 1), float(t))  # t cast to u's dtype


def conv_vf(u, theta, t):
    """ODE-block conv vector field with time concatenated as the LAST
    channel (the standard Chen et al. 'concat' conv).  u: (B, H, W, C)."""
    tt = _time_channel(t, u)
    x = _group_norm(u, theta["gn_scale"], theta["gn_bias"])
    x = F.relu(x)
    x = _conv(theta["conv1"], torch.cat([x, tt], dim=-1))
    x = F.relu(x)
    x = _conv(theta["conv2"], torch.cat([x, tt], dim=-1))
    return x


def classifier_init(gen: torch.Generator, channels: int = 32,
                    n_classes: int = 10, in_channels: int = 3, *,
                    device="cuda"):
    device = resolve_device(device)
    return {
        "stem": _conv_init(gen, 3, 3, in_channels, channels, device),
        "ode": conv_vf_init(gen, channels, device=device),
        "head": _dense_init(gen, channels, n_classes, device),
    }


def classifier_apply(params, images, *, odeint_fn):
    """stem conv -> ODE block (via the caller-supplied odeint closure)
    -> global average pool -> linear head.  images: (B, H, W, C_in)."""
    x = F.relu(_conv(params["stem"], images))
    x = odeint_fn(conv_vf, x, params["ode"])
    x = x.mean(dim=(1, 2))
    return x @ params["head"]["w"] + params["head"]["b"]


def softmax_xent(logits, labels) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    # the gold logit as a one-hot sum: adding exact zeros rounds nothing, so
    # this equals a gather, and unlike gather (whose backward is a
    # scatter-add) it runs under torch.use_deterministic_algorithms and
    # with no host sync (F.one_hot checks its labels on the host)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (labels[:, None] == classes).to(logits.dtype)
    gold = (logits * onehot).sum(dim=-1)
    return (logz - gold).mean()
