"""Wrappers for the port's hand-written Hopper kernels.

``flash_attention_bhsd`` (and its model-layout front ``flash_attention``)
is the forward online-softmax attention of the LM prefill
(``csrc/flash_attention.cu``).

``rwkv6_chunked_bhsd`` (and its model-layout front ``rwkv6_chunked``, both
in r's dtype, as the JAX package's) and ``rwkv6_chunked_fp32`` (the RWKV6
prefill's: the model's (B,S,H,dh) projections read in place, fp32 out)
are the chunked RWKV6 recurrence (``csrc/rwkv6_scan.cuh``), one kernel.

``rwkv6_chunked_bwd_fp32`` is that recurrence's gradient
(``csrc/rwkv6_scan_bwd.cuh``), the backward of ``rwkv6_chunked_fp32`` in
training; it replaces no TPU kernel (the TPU kernel is forward only).

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
import torch.nn.functional as F

from repro_torch.kernels.ref import (attention_plain, lincomb_plain,
                                    rwkv6_plain, rwkv6_plain_vjp)

MAX_TERMS = 8

#: kernel launches made by ``fused_lincomb`` (CUDA tensors)
launches = 0
#: calls that ``fused_lincomb`` served with the plain version (CPU tensors)
plain_calls = 0
#: kernel launches made by ``flash_attention_bhsd`` (CUDA tensors)
flash_launches = 0
#: calls that ``flash_attention_bhsd`` served with ``attention_plain`` (CPU)
flash_plain_calls = 0
#: RWKV6 kernel launches, by ``rwkv6_chunked_bhsd`` and
#: ``rwkv6_chunked_fp32`` (CUDA tensors)
rwkv6_launches = 0
#: calls that ``rwkv6_chunked_bhsd`` served with ``rwkv6_plain`` (CPU)
rwkv6_plain_calls = 0
#: launches of the RWKV6 backward kernel by ``rwkv6_chunked_bwd_fp32``
rwkv6_bwd_launches = 0
#: calls that ``rwkv6_chunked_bwd_fp32`` served with ``rwkv6_plain_vjp``
rwkv6_bwd_plain_calls = 0


def reset_counts() -> None:
    global launches, plain_calls, flash_launches, flash_plain_calls
    global rwkv6_launches, rwkv6_plain_calls
    global rwkv6_bwd_launches, rwkv6_bwd_plain_calls
    launches = 0
    plain_calls = 0
    flash_launches = 0
    flash_plain_calls = 0
    rwkv6_launches = 0
    rwkv6_plain_calls = 0
    rwkv6_bwd_launches = 0
    rwkv6_bwd_plain_calls = 0


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

#: head dims the kernels are instantiated for (the repo's configs and tests)
FLASH_HEAD_DIMS = (16, 32, 64, 96, 128, 256)
#: fp32: the CUDA-core kernel; bf16: the tensor-core (wgmma + TMA) kernel
_FLASH_FN = {torch.float32: "repro_flash_attention_f32",
             torch.bfloat16: "repro_flash_attention_bf16"}
#: the bf16 kernel's tensor maps need 16-byte bases and strides (TMA)
TMA_ALIGN = 16
#: the fp32 kernel offsets a row inside its 64-row tiles with an int
F32_MAX_ROW_STRIDE = 2 ** 31 // 64
# error codes of csrc/flash_attention.cu beside cudaError_t's
_FLASH_ERRORS = {100000: "the driver has no cuTensorMapEncodeTiled",
                 200000: "cuTensorMapEncodeTiled refused the operand"}


class FlashArgs(ctypes.Structure):
    _fields_ = [("q", ctypes.c_void_p), ("k", ctypes.c_void_p),
                ("v", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("q_stride", ctypes.c_longlong * 3),
                ("k_stride", ctypes.c_longlong * 3),
                ("v_stride", ctypes.c_longlong * 3),
                ("o_stride", ctypes.c_longlong * 3),
                ("b", ctypes.c_int), ("h", ctypes.c_int),
                ("hkv", ctypes.c_int), ("sq", ctypes.c_int),
                ("sk", ctypes.c_int), ("dh", ctypes.c_int),
                ("causal", ctypes.c_int), ("window", ctypes.c_int),
                ("scale", ctypes.c_float)]


def _flash_kernel(dtype):
    fn = _bound.get(("flash", dtype))
    if fn is None:
        from repro_torch.kernels import _build  # builds on first launch
        fn = getattr(_build.load("flash_attention"), _FLASH_FN[dtype])
        fn.argtypes = [FlashArgs, ctypes.c_void_p]
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
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_bhsd: the head dim of q, k and v "
                         "must be contiguous (stride 1); got strides "
                         f"{q.stride()}, {k.stride()}, {v.stride()}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_bhsd has no autograd rule (the TPU kernel has "
            "no backward either); call it under torch.no_grad()")


def _check_tma(*tensors):
    """The bf16 kernel reads q, k and v through TMA tensor maps: 16-byte
    base pointers and 16-byte batch, head and sequence strides (a dim of
    extent 1 is never stepped, so its stride is free)."""
    for name, t in zip("qkv", tensors):
        step = TMA_ALIGN // t.element_size()
        bad = [s for s, n in zip(t.stride()[:3], t.shape[:3])
               if n > 1 and s % step]
        if t.data_ptr() % TMA_ALIGN or bad:
            raise ValueError(
                f"flash_attention_bhsd: bf16 {name} needs a {TMA_ALIGN}-byte "
                f"aligned base and batch/head/sequence strides that are "
                f"multiples of {step} elements (TMA); got pointer % "
                f"{TMA_ALIGN} = {t.data_ptr() % TMA_ALIGN}, strides "
                f"{t.stride()}")


def _check_row_strides(*tensors):
    """The fp32 kernel steps from row to row inside a 64-row tile with a
    32-bit offset: sequence strides below ``F32_MAX_ROW_STRIDE`` elements
    (a sequence of length 1 is never stepped)."""
    for name, t in zip(("q", "k", "v", "out"), tensors):
        if t.shape[2] > 1 and t.stride(2) >= F32_MAX_ROW_STRIDE:
            raise ValueError(
                f"flash_attention_bhsd: fp32 {name} has a sequence stride "
                f"of {t.stride(2)} elements; the kernel takes strides below "
                f"{F32_MAX_ROW_STRIDE}")


def _flash(q, k, v, out, causal, window):
    """The counted launch behind both wrappers: q, k, v and ``out`` are
    indexed (B,H,S,Dh) with any strides whose head dim has stride 1;
    ``out=None`` allocates a contiguous (B,H,Sq,Dh) output."""
    global flash_launches, flash_plain_calls
    _check_flash(q, k, v)
    window = int(window)
    if q.device.type == "cpu":
        flash_plain_calls += 1
        res = attention_plain(q, k, v, causal=causal, window=window)
        return res if out is None else out.copy_(res)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bhsd: unsupported device "
                         f"{q.device}")
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if sq == 0 or sk == 0 or b == 0:
        raise ValueError("flash_attention_bhsd: empty sequence or batch")
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16:
        _check_tma(q, k, v)
    else:
        _check_row_strides(q, k, v, out)
    args = FlashArgs(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), q.stride()[:3], k.stride()[:3],
                     v.stride()[:3], out.stride()[:3], b, h, hkv, sq, sk,
                     dh, int(bool(causal)), max(window, 0),
                     1.0 / math.sqrt(dh))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _flash_kernel(q.dtype)(args, stream)
    if err != 0:
        what = _FLASH_ERRORS.get(err - err % 100000, "CUDA error")
        raise RuntimeError(f"flash_attention_bhsd: launch failed with error "
                           f"{err} ({what})")
    flash_launches += 1
    return out


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Forward online-softmax attention.  q: (B,H,Sq,Dh); k, v:
    (B,Hkv,Sk,Dh) with H % Hkv == 0, one dtype (fp32 or bf16), Dh in
    ``FLASH_HEAD_DIMS``, any strides whose head dim has stride 1 (bf16:
    16-byte aligned, for TMA).  Masks: causal (key <= query) and, for
    ``window > 0``, key > query - window.  Returns a contiguous
    (B,H,Sq,Dh) tensor in q's dtype.  A CUDA tensor launches
    ``csrc/flash_attention.cu`` (bf16: the tensor-core kernel; fp32: the
    CUDA-core kernel) or raises; only a CPU tensor takes
    ``attention_plain``."""
    return _flash(q, k, v, None, causal, window)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Model layout: q (B,S,H,Dh), k/v (B,S,Hkv,Dh) -> (B,S,H,Dh), as the
    JAX package's ``ops.flash_attention``.  The kernel reads the views in
    place through their strides and writes a (B,S,H,Dh) tensor allocated
    in that layout: no copies."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q (B,S,H,Dh), got "
                         f"{tuple(q.shape)}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _flash(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
           out.transpose(1, 2), causal, window)
    return out


# ---------------------------------------------------------------------------
# chunked RWKV6 recurrence (forward only, like the TPU kernel it replaces)
# ---------------------------------------------------------------------------

#: head dims and chunk lengths the kernel is instantiated for
RWKV6_HEAD_DIMS = (16, 32, 64, 128)
RWKV6_CHUNKS = (16, 32, 64)
#: (r/k/v dtype, logw/u/out dtype) -> (source, C entry) of the kernel's
#: instantiation for it
_RWKV6_FN = {(torch.float32, torch.float32):
             ("rwkv6_scan", "repro_rwkv6_chunked_f32"),
             (torch.bfloat16, torch.bfloat16):
             ("rwkv6_scan_bf16", "repro_rwkv6_chunked_bf16"),
             (torch.bfloat16, torch.float32):
             ("rwkv6_scan_bf16_f32", "repro_rwkv6_chunked_bf16_f32")}
#: the kernel copies r, k, v and logw into shared memory 16 bytes at a time
#: (cp.async): 16-byte bases and batch, sequence and head strides
CP_ASYNC_ALIGN = 16


class Rwkv6Args(ctypes.Structure):
    _fields_ = [("r", ctypes.c_void_p), ("k", ctypes.c_void_p),
                ("v", ctypes.c_void_p), ("logw", ctypes.c_void_p),
                ("u", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("state", ctypes.c_void_p),
                ("r_stride", ctypes.c_longlong * 3),
                ("k_stride", ctypes.c_longlong * 3),
                ("v_stride", ctypes.c_longlong * 3),
                ("w_stride", ctypes.c_longlong * 3),
                ("o_stride", ctypes.c_longlong * 3),
                ("b", ctypes.c_int), ("h", ctypes.c_int), ("s", ctypes.c_int)]


def _rwkv6_kernel(dtypes):
    fn = _bound.get(("rwkv6", dtypes))
    if fn is None:
        from repro_torch.kernels import _build  # builds on first launch
        stem, name = _RWKV6_FN[dtypes]
        fn = getattr(_build.load(stem), name)
        fn.argtypes = [Rwkv6Args, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[("rwkv6", dtypes)] = fn
    return fn


def _check_rwkv6_operands(name, layout, r, k, v, logw, u, w_dtype):
    """The rules both RWKV6 entries share: r, k, v and logw of one 4-D
    shape, whose dims ``layout`` names ("B,H,S,dh" or "B,S,H,dh"), u (H,dh),
    r/k/v fp32 or bf16, logw and u of ``w_dtype`` (None: r's dtype), one
    device, and no autograd."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(
            f"{name}: r, k, v and logw must all be ({layout}); got "
            f"{tuple(r.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
            f"{tuple(logw.shape)}")
    hd = (r.shape[layout.split(",").index("H")], r.shape[3])
    if u.shape != hd:
        raise ValueError(f"{name}: u must be (H,dh) = {hd}, got "
                         f"{tuple(u.shape)}")
    want = r.dtype if w_dtype is None else w_dtype
    if (r.dtype not in (torch.float32, torch.bfloat16)
            or k.dtype != r.dtype or v.dtype != r.dtype
            or logw.dtype != want or u.dtype != want):
        rule = ("r, k, v, logw and u must share one dtype, fp32 or bf16"
                if w_dtype is None else
                "r, k and v of one dtype (fp32 or bf16), logw and u fp32")
        raise TypeError(f"{name}: {rule}; got "
                        f"{[str(t.dtype) for t in (r, k, v, logw, u)]}")
    if any(t.device != r.device for t in (k, v, logw, u)):
        raise ValueError(f"{name}: operands on different devices: "
                         f"{[str(t.device) for t in (r, k, v, logw, u)]}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, logw, u)):
        raise RuntimeError(
            f"{name} has no autograd rule (the TPU kernel has no backward "
            "either); call it under torch.no_grad()")


def _check_rwkv6(r, k, v, logw, u, chunk):
    name = "rwkv6_chunked_bhsd"
    _check_rwkv6_operands(name, "B,H,S,dh", r, k, v, logw, u, None)
    if not all(t.is_contiguous() for t in (r, k, v, logw, u)):
        raise ValueError(f"{name}: operands must be contiguous")
    if chunk <= 0 or r.shape[2] % chunk:
        raise ValueError(f"{name}: S={r.shape[2]} is not a multiple of "
                         f"the chunk {chunk} (rwkv6_chunked pads)")


def _check_cp_async(name, **tensors):
    """r, k, v and logw (indexed (B,S,H,dh)) reach shared memory through
    16-byte copies: a 16-byte base and batch, sequence and head strides
    that are multiples of 16 bytes (a dim of extent 1 is never stepped,
    so its stride is free)."""
    for what, t in tensors.items():
        size = t.element_size()
        bad = [st for st, n in zip(t.stride()[:3], t.shape[:3])
               if n > 1 and st * size % CP_ASYNC_ALIGN]
        if t.data_ptr() % CP_ASYNC_ALIGN or bad:
            raise ValueError(
                f"{name}: {what} needs a {CP_ASYNC_ALIGN}-byte aligned base "
                f"and batch/sequence/head strides of {CP_ASYNC_ALIGN}-byte "
                f"multiples (the kernel's cp.async copies); got pointer % "
                f"{CP_ASYNC_ALIGN} = {t.data_ptr() % CP_ASYNC_ALIGN}, strides "
                f"{t.stride()} of {size}-byte elements")


def _rwkv6_launch(name, r, k, v, logw, u, out, chunk):
    """The counted launch behind the wrappers: r, k, v, logw and ``out``
    indexed (B,S,H,dh) with any strides whose dh has stride 1 (r/k/v/logw:
    16-byte multiples), u (H,dh).  Returns (out, fp32 state (B,H,dh,dh))."""
    global rwkv6_launches
    b, s, h, dh = r.shape
    if dh not in RWKV6_HEAD_DIMS or chunk not in RWKV6_CHUNKS:
        raise ValueError(f"{name}: head dim {dh} / chunk {chunk} not in "
                         f"{RWKV6_HEAD_DIMS} / {RWKV6_CHUNKS}")
    if b * h == 0 or s == 0:
        raise ValueError(f"{name}: empty batch, heads or sequence")
    _check_cp_async(name, r=r, k=k, v=v, logw=logw)
    u = u.contiguous()
    state = torch.empty((b, h, dh, dh), dtype=torch.float32, device=r.device)

    def strides(t):
        return (t.stride(0), t.stride(1), t.stride(2))

    args = Rwkv6Args(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                     logw.data_ptr(), u.data_ptr(), out.data_ptr(),
                     state.data_ptr(), strides(r), strides(k), strides(v),
                     strides(logw), strides(out), b, h, s)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _rwkv6_kernel((r.dtype, logw.dtype))(args, dh, chunk, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    rwkv6_launches += 1
    return out, state


def rwkv6_chunked_bhsd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       logw: torch.Tensor, u: torch.Tensor, *,
                       chunk: int = 64):
    """Chunked RWKV6 recurrence from a zero state.  r/k/v/logw: (B,H,S,dh)
    with S a multiple of ``chunk``, u: (H,dh), all contiguous and of one
    dtype (fp32 or bf16).  Returns (out (B,H,S,dh) in r's dtype, final
    state (B,H,dh,dh) fp32).  A CUDA tensor launches ``csrc/rwkv6_scan.cuh``
    (dh in ``RWKV6_HEAD_DIMS``, chunk in ``RWKV6_CHUNKS``, 16-byte aligned
    bases) or raises; only a CPU tensor takes ``rwkv6_plain``."""
    global rwkv6_plain_calls
    chunk = int(chunk)
    _check_rwkv6(r, k, v, logw, u, chunk)
    if r.device.type == "cpu":
        rwkv6_plain_calls += 1
        return rwkv6_plain(r, k, v, logw, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_chunked_bhsd: unsupported device {r.device}")
    out = torch.empty_like(r)
    _, state = _rwkv6_launch("rwkv6_chunked_bhsd",
                             *(t.transpose(1, 2) for t in (r, k, v, logw)),
                             u, out.transpose(1, 2), chunk)
    return out, state


def bhsd_padded(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B,S,H,dh) -> contiguous (B,H,S',dh), zero-padded along S to S' a
    multiple of ``chunk`` (a zero logw step decays nothing and a zero k or
    v adds nothing, so the padding leaves the state as it was)."""
    tt = t.transpose(1, 2)
    pad = (-tt.shape[2]) % chunk
    return (F.pad(tt, (0, 0, 0, pad)) if pad else tt).contiguous()


def rwkv6_chunked(r, k, v, logw, u, *, chunk: int = 64):
    """Model layout: r/k/v/logw (B,S,H,dh), u (H,dh) -> (out (B,S,H,dh),
    final state (B,H,dk,dv)), as the JAX package's ``ops.rwkv6_chunked``:
    S is zero-padded to a multiple of ``chunk`` and the padding stripped
    from the output, which is a (B,S,H,dh) view of the kernel's, in r's
    dtype."""
    s = r.shape[1]
    out, state = rwkv6_chunked_bhsd(*(bhsd_padded(t, chunk)
                                      for t in (r, k, v, logw)),
                                    u.contiguous(), chunk=chunk)
    return out.transpose(1, 2)[:, :s], state


def _check_rwkv6_fp32(r, k, v, logw, u, chunk, name="rwkv6_chunked_fp32"):
    _check_rwkv6_operands(name, "B,S,H,dh", r, k, v, logw, u, torch.float32)
    if any(t.stride(-1) != 1 for t in (r, k, v, logw, u)):
        raise ValueError(f"{name}: the innermost (dh) stride of every "
                         "operand must be 1; got strides "
                         f"{[t.stride() for t in (r, k, v, logw, u)]}")
    if chunk <= 0:
        raise ValueError(f"{name}: chunk {chunk} must be positive")


def rwkv6_chunked_fp32(r, k, v, logw, u, *, chunk: int = 64):
    """The model path's RWKV6 recurrence (``nn/ssm.py::rwkv6_mix_chunked``),
    reading the projections where they lie: r/k/v (B,S,H,dh) fp32 or bf16
    (one dtype), logw (B,S,H,dh) fp32, u (H,dh) fp32, any S; each with a
    unit dh stride.  Returns (out (B,S,H,dh) fp32, contiguous, final state
    (B,H,dh,dh) fp32), bit for bit

        rwkv6_chunked(*(t.float() for t in (r, k, v, logw)), u, chunk=chunk)

    which is what a CPU tensor takes.  A CUDA tensor launches
    ``csrc/rwkv6_scan.cuh`` on the views in place (bf16 upcast on load, the
    ragged last chunk masked, out written in (B,S,H,dh)) or raises.  (The
    name says what differs from ``rwkv6_chunked``: the output is fp32
    whatever r's dtype, as the JAX model path computes it.)"""
    chunk = int(chunk)
    _check_rwkv6_fp32(r, k, v, logw, u, chunk)
    if r.device.type == "cpu":
        out, state = rwkv6_chunked(*(t.float() for t in (r, k, v, logw)),
                                   u, chunk=chunk)
        return out.contiguous(), state
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_chunked_fp32: unsupported device {r.device}")
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    return _rwkv6_launch("rwkv6_chunked_fp32", r, k, v, logw, u, out, chunk)


# ---------------------------------------------------------------------------
# the gradient of the chunked RWKV6 recurrence (the model path's backward)
# ---------------------------------------------------------------------------

#: head dims and chunk lengths the backward kernel is instantiated for
RWKV6_BWD_HEAD_DIMS = (16, 32, 64)
RWKV6_BWD_CHUNKS = (16, 32, 64)
#: r/k/v dtype -> the C entry of the backward kernel's instantiation
_RWKV6_BWD_FN = {torch.float32: "repro_rwkv6_chunked_bwd_f32",
                 torch.bfloat16: "repro_rwkv6_chunked_bwd_bf16"}


class Rwkv6BwdArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("r", "k", "v", "logw", "u", "dy", "dr", "dk", "dv",
                  "dlogw", "du", "ws")]
                + [(n, ctypes.c_longlong * 3) for n in
                   ("r_stride", "k_stride", "v_stride", "w_stride",
                    "y_stride", "dr_stride", "dk_stride", "dv_stride",
                    "dw_stride")]
                + [("b", ctypes.c_int), ("h", ctypes.c_int),
                   ("s", ctypes.c_int)])


def _rwkv6_bwd_kernel(dtype):
    fn = _bound.get(("rwkv6_bwd", dtype))
    if fn is None:
        from repro_torch.kernels import _build  # builds on first launch
        fn = getattr(_build.load("rwkv6_scan_bwd"), _RWKV6_BWD_FN[dtype])
        fn.argtypes = [Rwkv6BwdArgs, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[("rwkv6_bwd", dtype)] = fn
    return fn


def _cp_async_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its base and its batch, sequence and head strides
    are 16-byte multiples (``_check_cp_async``'s rule), else a contiguous
    copy, which is: the backward's kernels copy every operand 16 bytes at
    a time (the model path's operands are aligned views, never copied)."""
    size = t.element_size()
    if t.data_ptr() % CP_ASYNC_ALIGN == 0 and all(
            n == 1 or st * size % CP_ASYNC_ALIGN == 0
            for st, n in zip(t.stride()[:3], t.shape[:3])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _rwkv6_bwd_workspace_floats(chunks: int, dh: int) -> tuple[int, int]:
    """fp32 elements of the backward's scratch for ``chunks`` (b, h, chunk)
    triples: the kernels' workspace (the state entering and the state
    gradient leaving every chunk, 2 dh^2, and e^{total}, dh) and the
    chunks' parts of du (dh each)."""
    return chunks * (2 * dh * dh + dh), chunks * dh


def rwkv6_bwd_workspace_bytes(b: int, s: int, h: int, dh: int,
                              chunk: int = 64) -> int:
    """Bytes of the scratch ``rwkv6_chunked_bwd_fp32`` allocates on the
    card a call (``_rwkv6_bwd_workspace_floats``, one fp32 buffer)."""
    return 4 * sum(_rwkv6_bwd_workspace_floats(b * h * -(-s // chunk), dh))


def rwkv6_chunked_bwd_fp32(r, k, v, logw, u, dy, *, chunk: int = 64):
    """The gradient of ``rwkv6_chunked_fp32`` (out only: the final state
    gets none) with respect to its operands: r/k/v (B,S,H,dh) of one dtype
    (fp32 or bf16), logw and dy (B,S,H,dh) fp32, u (H,dh) fp32, any S,
    each with a unit dh stride.  Returns (dr, dk, dv, dlogw, du), each
    contiguous in its operand's shape and dtype.

    A CUDA tensor launches ``csrc/rwkv6_scan_bwd.cuh`` (dh in
    ``RWKV6_BWD_HEAD_DIMS``, chunk in ``RWKV6_BWD_CHUNKS``) on the views
    in place, or raises: three kernels on the current stream, one call
    (counted once in ``rwkv6_bwd_launches``): the products of every
    chunk, the two recurrences over the chunks, the gradients of every
    chunk.  Its workspace (``rwkv6_bwd_workspace_bytes``) holds the state
    entering and the state gradient leaving every chunk; ``du`` is one
    torch sum of the chunks' parts.  An operand whose base or strides are
    not 16-byte multiples is copied first.  A CPU tensor takes
    ``rwkv6_plain_vjp`` (autograd of ``rwkv6_plain`` on upcast,
    zero-padded copies)."""
    global rwkv6_bwd_launches, rwkv6_bwd_plain_calls
    name = "rwkv6_chunked_bwd_fp32"
    chunk = int(chunk)
    _check_rwkv6_fp32(r, k, v, logw, u, chunk, name)
    if dy.shape != r.shape or dy.dtype != torch.float32 \
            or dy.device != r.device:
        raise ValueError(f"{name}: dy must be fp32 of r's shape and device; "
                         f"got {dy.dtype}/{tuple(dy.shape)}/{dy.device}")
    if r.device.type == "cpu":
        rwkv6_bwd_plain_calls += 1
        return rwkv6_plain_vjp(r, k, v, logw, u, dy, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {r.device}")
    b, s, h, dh = r.shape
    if dh not in RWKV6_BWD_HEAD_DIMS or chunk not in RWKV6_BWD_CHUNKS:
        raise ValueError(f"{name}: head dim {dh} / chunk {chunk} not in "
                         f"{RWKV6_BWD_HEAD_DIMS} / {RWKV6_BWD_CHUNKS}")
    if b * h == 0 or s == 0:
        raise ValueError(f"{name}: empty batch, heads or sequence")
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    r, k, v, logw, dy = (_cp_async_ready(t) for t in (r, k, v, logw, dy))
    u = u.contiguous()
    nc = -(-s // chunk)
    dev = r.device
    grads = [torch.empty(t.shape, dtype=t.dtype, device=dev)
             for t in (r, k, v, logw)]
    n_ws, n_du = _rwkv6_bwd_workspace_floats(b * h * nc, dh)
    scratch = torch.empty(n_ws + n_du, dtype=torch.float32, device=dev)
    ws, du_part = scratch[:n_ws], scratch[n_ws:]

    def strides(t):
        return (t.stride(0), t.stride(1), t.stride(2))

    dr, dk, dv, dlogw = grads
    args = Rwkv6BwdArgs(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), dy.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dlogw.data_ptr(), du_part.data_ptr(), ws.data_ptr(),
        strides(r), strides(k), strides(v), strides(logw), strides(dy),
        strides(dr), strides(dk), strides(dv), strides(dlogw), b, h, s)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _rwkv6_bwd_kernel(r.dtype)(args, dh, chunk, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    rwkv6_bwd_launches += 1
    return dr, dk, dv, dlogw, du_part.view(b, h, nc, dh).sum((0, 2))


def rwkv6_bwd_kernel_info(dtype, dh: int, chunk: int) -> dict:
    """What the card reports for the backward's three kernels at (r/k/v
    ``dtype``, ``dh``, ``chunk``): resident blocks an SM and dynamic shared
    bytes (registers and spills are in ptxas's log of the build).  Builds
    the kernels; needs a card."""
    from repro_torch.kernels import _build
    fn = _build.load("rwkv6_scan_bwd").repro_rwkv6_chunked_bwd_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    err = fn(int(dtype == torch.bfloat16), dh, chunk, out)
    if err != 0:
        raise RuntimeError(f"rwkv6_bwd_kernel_info: CUDA error {err}")
    names = ("chunk_products", "state_scans", "chunk_grads")
    return {n: dict(blocks_per_sm=out[i], smem_bytes=(out[3], 0, out[4])[i])
            for i, n in enumerate(names)}
