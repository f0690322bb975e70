"""The model path's RWKV6 wrapper ``ops.rwkv6_chunked_fp32`` on the CPU.

On a CPU tensor it is, by contract, the composition it replaces on the
card: ``ops.rwkv6_chunked`` on fp32 copies of r, k, v and logw (zero
padding to a multiple of the chunk, ``rwkv6_plain``, the padding
stripped), bit for bit, for bf16 and fp32 r/k/v and ragged S; its output
is fp32 and contiguous in (B,S,H,dh).  It refuses what the kernel cannot
take on any device (a dtype mix, operands on two devices, a bad shape, a
non-unit innermost stride, a graph to record); the 16-byte rule of the
kernel's copies is checked here on CPU tensors.  The ctypes argument
struct mirrors the CUDA source, and ``launch/rwkv6_ab.py`` needs two
checkouts.  The card-side checks are in ``tests/test_torch_gpu.py``.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_cases import rwkv6_inputs

ROOT = Path(__file__).resolve().parents[1]


def _inputs(b, s, h, dh, dtype, seed=0):
    """The kernel-test inputs in the model's (B,S,H,dh) layout, from a numpy
    seed: r, k, v in ``dtype``, logw and u fp32."""
    r, k, v, logw, u = rwkv6_inputs(b, h, s, dh, np.random.RandomState(seed),
                                    layout="bshd")
    return r.to(dtype), k.to(dtype), v.to(dtype), logw, u


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 31, 64, 65, 100, 300])
def test_inplace_wrapper_is_the_composition_bitwise(dtype, s):
    r, k, v, logw, u = _inputs(2, s, 3, 16, dtype, seed=s)
    ops.reset_counts()
    out, state = ops.rwkv6_chunked_fp32(r, k, v, logw, u, chunk=32)
    ref_out, ref_state = ops.rwkv6_chunked(
        *(t.float() for t in (r, k, v, logw)), u, chunk=32)
    assert out.dtype == torch.float32 and out.shape == r.shape
    assert out.is_contiguous() and state.shape == (2, 3, 16, 16)
    assert torch.equal(_bits(out), _bits(ref_out))
    assert torch.equal(_bits(state), _bits(ref_state))
    assert (ops.rwkv6_plain_calls, ops.rwkv6_launches) == (2, 0)


def test_inplace_wrapper_reads_views_with_any_outer_strides():
    """A (B,S,H,dh) view sliced out of larger tensors gives the bits of its
    contiguous copy."""
    r, k, v, logw, u = _inputs(3, 70, 5, 16, torch.bfloat16, seed=1)
    views = [t[1:, 3:68, 2:4] for t in (r, k, v, logw)]
    out, state = ops.rwkv6_chunked_fp32(*views, u[2:4], chunk=16)
    ref_out, ref_state = ops.rwkv6_chunked_fp32(
        *(t.contiguous() for t in views), u[2:4].contiguous(), chunk=16)
    assert torch.equal(_bits(out), _bits(ref_out))
    assert torch.equal(_bits(state), _bits(ref_state))


@pytest.mark.parametrize("case,exc,match", [
    ("rk_dtypes", TypeError, "one dtype"),
    ("logw_bf16", TypeError, "logw and u fp32"),
    ("u_bf16", TypeError, "logw and u fp32"),
    ("fp64", TypeError, "one dtype"),
    ("devices", ValueError, "different devices"),
    ("rank", ValueError, "B,S,H,dh"),
    ("logw_shape", ValueError, "B,S,H,dh"),
    ("u_shape", ValueError, "u must be"),
    ("inner_stride", ValueError, "innermost"),
    ("chunk", ValueError, "positive"),
    ("autograd", RuntimeError, "autograd"),
])
def test_inplace_wrapper_refusals(case, exc, match):
    r, k, v, logw, u = _inputs(1, 20, 2, 16, torch.bfloat16)
    chunk = 16
    if case == "rk_dtypes":
        k = k.float()
    elif case == "logw_bf16":
        logw = logw.bfloat16()
    elif case == "u_bf16":
        u = u.bfloat16()
    elif case == "fp64":
        r, k, v = (t.double() for t in (r, k, v))
    elif case == "devices":
        u = torch.empty(2, 16, device="meta")
    elif case == "rank":
        r = r[0]
    elif case == "logw_shape":
        logw = logw[:, :10]
    elif case == "u_shape":
        u = u[:1]
    elif case == "inner_stride":
        v = torch.zeros(1, 20, 2, 32, dtype=torch.bfloat16)[..., ::2]
    elif case == "chunk":
        chunk = 0
    elif case == "autograd":
        logw.requires_grad_(True)
    with pytest.raises(exc, match=match):
        ops.rwkv6_chunked_fp32(r, k, v, logw, u, chunk=chunk)
    if case == "autograd":
        with torch.no_grad():
            ops.rwkv6_chunked_fp32(r, k, v, logw, u, chunk=chunk)  # allowed


def test_check_cp_async_refuses_what_16_byte_copies_cannot_step():
    flat = torch.zeros(4096, dtype=torch.bfloat16)
    ok = flat.as_strided((2, 8, 2, 16), (512, 64, 32, 1))
    ops._check_cp_async("t", r=ok)
    with pytest.raises(ValueError, match="16-byte aligned base"):
        ops._check_cp_async("t", r=flat.as_strided((2, 8, 2, 16),
                                                   (512, 64, 32, 1), 1))
    with pytest.raises(ValueError, match="strides"):
        ops._check_cp_async("t", r=flat.as_strided((2, 8, 2, 16),
                                                   (512, 68, 34, 1)))
    # a dim of extent 1 is never stepped: its stride is free
    ops._check_cp_async("t", r=flat.as_strided((1, 8, 2, 16),
                                               (3, 64, 32, 1)))


def test_rwkv6_args_mirror_the_source():
    """The ctypes Rwkv6Args has the C struct's fields in its order."""
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    src = (csrc / "rwkv6_scan.cuh").read_text()
    body = re.search(r"struct Rwkv6Args \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [re.sub(r"\[.*\]", "", n).strip(" *").split()[-1]
                      for n in decl.split(",")]
    assert names == [f for f, _ in ops.Rwkv6Args._fields_]
    # 7 pointers, 15 strides and 3 ints, padded to 8 bytes
    assert ctypes.sizeof(ops.Rwkv6Args) == 7 * 8 + 15 * 8 + 3 * 4 + 4
    for stem, name in ops._RWKV6_FN.values():   # one source an instantiation
        assert f"int {name}(" in (csrc / f"{stem}.cu").read_text()


def test_rwkv6_ab_needs_two_checkouts():
    from repro_torch.launch import rwkv6_ab
    with pytest.raises(SystemExit):
        rwkv6_ab.main(["only-one-root"])
