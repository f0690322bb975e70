"""Wrappers for the port's hand-written Hopper kernels.

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

import torch

from repro_torch.kernels.ref import lincomb_plain

MAX_TERMS = 8

#: kernel launches made by ``fused_lincomb`` (CUDA tensors)
launches = 0
#: calls that ``fused_lincomb`` served with the plain version (CPU tensors)
plain_calls = 0


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


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
