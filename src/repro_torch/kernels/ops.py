"""Wrappers for the port's hand-written Hopper kernels.

``flash_attention_bhsd`` (and its model-layout front ``flash_attention``)
is the forward online-softmax attention of the LM prefill
(``csrc/flash_attention.cu``).

``fused_lincomb`` is the RK stage-update / stage-adjoint primitive:

    forward stage inputs   x_i = u + h * sum_j a_ij k_j
    forward combine        u'  = u + h * sum_i b_i  k_i
    adjoint stage weights  v_i = b_i * lam + sum_{j>i} a_ji w_j

i.e. ``out = base_coeff*base + sum_i c_i*term_i`` with tableau weights, in
one kernel launch per leaf (``csrc/lincomb.cu``) with the accumulation
order of the unfused chain.  A CUDA tensor launches the kernel or raises;
only a CPU tensor takes the plain version (``kernels/ref.py``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.ref import attention_plain, lincomb_plain

MAX_TERMS = 8

#: kernel launches made by ``fused_lincomb`` (CUDA tensors)
launches = 0
#: calls that ``fused_lincomb`` served with the plain version (CPU tensors)
plain_calls = 0
#: kernel launches made by ``flash_attention_bhsd`` (CUDA tensors)
flash_launches = 0
#: calls that ``flash_attention_bhsd`` served with ``attention_plain`` (CPU)
flash_plain_calls = 0


def reset_counts() -> None:
    global launches, plain_calls, flash_launches, flash_plain_calls
    launches = 0
    plain_calls = 0
    flash_launches = 0
    flash_plain_calls = 0


def _args_type(ctype):
    class LincombArgs(ctypes.Structure):
        _fields_ = [("base", ctypes.c_void_p),
                    ("terms", ctypes.c_void_p * MAX_TERMS),
                    ("coeffs", ctype * MAX_TERMS),
                    ("base_coeff", ctype),
                    ("h", ctypes.c_void_p),
                    ("out", ctypes.c_void_p),
                    ("n", ctypes.c_longlong),
                    ("n_terms", ctypes.c_int),
                    ("has_base_coeff", ctypes.c_int)]
    return LincombArgs


_ARGS = {torch.float32: _args_type(ctypes.c_float),
         torch.float64: _args_type(ctypes.c_double)}
_FN = {torch.float32: "repro_lincomb_f32", torch.float64: "repro_lincomb_f64"}
_bound: dict = {}


def _kernel(dtype):
    fn = _bound.get(dtype)
    if fn is None:
        from repro_torch.kernels import _build  # builds on first launch
        fn = getattr(_build.load("lincomb"), _FN[dtype])
        fn.argtypes = [_ARGS[dtype], ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[dtype] = fn
    return fn


def _check(base, terms, scale):
    for t in terms:
        if (t.device != base.device or t.dtype != base.dtype
                or t.shape != base.shape):
            raise ValueError(
                "fused_lincomb: every term must match base in device, dtype "
                f"and shape; base {base.device}/{base.dtype}/"
                f"{tuple(base.shape)}, term {t.device}/{t.dtype}/"
                f"{tuple(t.shape)}")
    for t in (base, *terms):
        if not t.is_contiguous():
            raise ValueError("fused_lincomb: leaves must be contiguous")
    if torch.is_tensor(scale) and (scale.numel() != 1
                                   or scale.device != base.device
                                   or scale.dtype != base.dtype):
        raise ValueError(
            "fused_lincomb: a tensor scale must be one element on the "
            f"leaves' device and dtype; got {scale.device}/{scale.dtype}/"
            f"{tuple(scale.shape)}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (base, *terms)):
        raise RuntimeError(
            "fused_lincomb has no autograd rule; call it where no graph is "
            "recorded (the checkpointing adjoint policies do)")


def fused_lincomb(base: torch.Tensor, terms, weights, scale=None,
                  base_coeff: float | None = None) -> torch.Tensor:
    """One-launch ``base_coeff*base + sum_i (scale*weights[i]) * terms[i]``.

    ``weights`` are Python floats (tableau entries, zero weights already
    dropped by the caller).  ``scale`` is None, a Python number (folded into
    the coefficients on the host: the static form) or a one-element tensor
    h on the leaves' device (``h*w_i`` formed in the kernel: the scaled
    form).  ``base_coeff=None`` adds the base unscaled; a float, 0.0
    included, multiplies it first.  fp32 and fp64, up to 8 terms.
    """
    global launches, plain_calls
    terms = list(terms)
    weights = [float(w) for w in weights]
    if len(weights) != len(terms):
        raise ValueError("fused_lincomb: one weight per term")
    _check(base, terms, scale)
    if base.device.type == "cpu":
        plain_calls += 1
        return lincomb_plain(base, terms, weights, scale, base_coeff)
    if base.device.type != "cuda":
        raise ValueError(f"fused_lincomb: unsupported device {base.device}")
    if base.dtype not in _ARGS:
        raise TypeError(f"fused_lincomb: fp32 or fp64 only, got {base.dtype}")
    if len(terms) > MAX_TERMS:
        raise ValueError(f"fused_lincomb: at most {MAX_TERMS} terms, "
                         f"got {len(terms)}")
    flat = base.reshape(-1)
    out = torch.empty_like(flat)
    args = _ARGS[base.dtype]()
    args.base = flat.data_ptr()
    for j, t in enumerate(terms):
        args.terms[j] = t.data_ptr()
    if torch.is_tensor(scale):
        args.coeffs[:len(weights)] = weights
        args.h = scale.data_ptr()
    else:
        # the Python double scale*w, cast to T as PyTorch casts a scalar
        args.coeffs[:len(weights)] = [w if scale is None else float(scale) * w
                                      for w in weights]
        args.h = None
    args.has_base_coeff = base_coeff is not None
    args.base_coeff = 0.0 if base_coeff is None else float(base_coeff)
    args.out = out.data_ptr()
    args.n = flat.numel()
    args.n_terms = len(terms)
    with torch.cuda.device(base.device):
        stream = torch.cuda.current_stream(base.device).cuda_stream
        err = _kernel(base.dtype)(args, stream)
    if err != 0:
        raise RuntimeError(f"fused_lincomb: CUDA launch failed with error {err}")
    launches += 1
    return out.view(base.shape)


# ---------------------------------------------------------------------------
# flash attention (forward only, like the TPU kernel it replaces)
# ---------------------------------------------------------------------------

#: head dims the kernel is instantiated for (the repo's configs and tests)
FLASH_HEAD_DIMS = (16, 32, 64, 96, 128, 256)
_FLASH_FN = {torch.float32: "repro_flash_attention_f32",
             torch.bfloat16: "repro_flash_attention_bf16"}


class FlashArgs(ctypes.Structure):
    _fields_ = [("q", ctypes.c_void_p), ("k", ctypes.c_void_p),
                ("v", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("b", ctypes.c_int), ("h", ctypes.c_int),
                ("hkv", ctypes.c_int), ("sq", ctypes.c_int),
                ("sk", ctypes.c_int), ("causal", ctypes.c_int),
                ("window", ctypes.c_int), ("scale", ctypes.c_float)]


def _flash_kernel(dtype):
    fn = _bound.get(("flash", dtype))
    if fn is None:
        from repro_torch.kernels import _build  # builds on first launch
        fn = getattr(_build.load("flash_attention"), _FLASH_FN[dtype])
        fn.argtypes = [FlashArgs, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[("flash", dtype)] = fn
    return fn


def _check_flash(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            "flash_attention_bhsd: q (B,H,Sq,Dh), k and v (B,Hkv,Sk,Dh); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh:
        raise ValueError("flash_attention_bhsd: q and k/v differ in batch "
                         f"or head dim: {tuple(q.shape)} vs {tuple(k.shape)}")
    if k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(f"flash_attention_bhsd: H={h} is not a multiple of "
                         f"Hkv={k.shape[1]}")
    if dh not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention_bhsd: head dim {dh} not in "
                         f"{FLASH_HEAD_DIMS}")
    if q.dtype not in _FLASH_FN or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_bhsd: q, k and v must share one "
                        "dtype, fp32 or bf16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_bhsd: q, k and v on different "
                         f"devices: {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_bhsd: q, k and v must be "
                         "contiguous")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_bhsd has no autograd rule (the TPU kernel has "
            "no backward either); call it under torch.no_grad()")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Forward online-softmax attention.  q: (B,H,Sq,Dh); k, v:
    (B,Hkv,Sk,Dh) with H % Hkv == 0, contiguous, one dtype (fp32 or bf16),
    Dh in ``FLASH_HEAD_DIMS``.  Masks: causal (key <= query) and, for
    ``window > 0``, key > query - window.  Returns (B,H,Sq,Dh) in q's
    dtype.  A CUDA tensor launches ``csrc/flash_attention.cu`` or raises;
    only a CPU tensor takes ``attention_plain``."""
    global flash_launches, flash_plain_calls
    _check_flash(q, k, v)
    window = int(window)
    if q.device.type == "cpu":
        flash_plain_calls += 1
        return attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bhsd: unsupported device "
                         f"{q.device}")
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if sq == 0 or sk == 0 or b == 0:
        raise ValueError("flash_attention_bhsd: empty sequence or batch")
    out = torch.empty_like(q)
    args = FlashArgs(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, h, hkv, sq, sk, int(bool(causal)),
                     max(window, 0), 1.0 / math.sqrt(dh))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _flash_kernel(q.dtype)(args, dh, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bhsd: CUDA launch failed with error {err}")
    flash_launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Model layout: q (B,S,H,Dh), k/v (B,S,Hkv,Dh) -> (B,S,H,Dh), as the
    JAX package's ``ops.flash_attention``.  The kernel takes contiguous
    (B,H,S,Dh), so this makes transposed copies of q, k and v (taking
    strides in the kernel is later work) and returns a (B,S,H,Dh) view of
    the kernel's output."""
    o = flash_attention_bhsd(q.transpose(1, 2).contiguous(),
                             k.transpose(1, 2).contiguous(),
                             v.transpose(1, 2).contiguous(),
                             causal=causal, window=window)
    return o.transpose(1, 2)
