"""The flash kernels' limits on the CPU (``repro_torch.kernels.flash_cases``)
and the model-layout front ``flash_attention``.

The bf16 tensor-core kernel rounds p to bf16 before P.V, so it is held to
an elementwise limit derived from that arithmetic.  Here, at small sizes:
the kernel's rounding, emulated in plain torch (``flash_tc_emulated``),
lies within the limit on the whole grid at diffuse and sharp scores; so do
the exact answer rounded to bf16 and the JAX package's Pallas kernel in
bf16 (interpret mode); and every deliberately wrong answer exceeds it by
``WRONG_MARGIN``.  ``flash_attention`` on strided (B,S,H,Dh) views gives
the same bits as the copy-then-call path, and the wrapper refuses what
the kernels cannot read.
"""
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_bhsd as j_flash
from repro_torch.kernels import flash_cases as fc
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_plain

ROOT = Path(__file__).resolve().parent.parent
BF16 = torch.bfloat16


def _inputs(shape, sharpness=1.0, seed=0, **kw):
    return fc.flash_inputs(*shape, np.random.RandomState(seed), dtype=BF16,
                           sharpness=sharpness, **kw)


def _exact(q, k, v, causal, window):
    """The attention of the bf16 inputs in fp64."""
    return attention_plain(q.double(), k.double(), v.double(), causal=causal,
                           window=window)


@pytest.mark.parametrize("sharpness", fc.FLASH_SHARPNESS)
@pytest.mark.parametrize("shape", fc.FLASH_SHAPES)
def test_flash_tc_emulated_within_bf16_limit(shape, sharpness):
    worst = 0.0
    for causal, window in fc.FLASH_MASKS:
        q, k, v = _inputs(shape, sharpness)
        out = fc.flash_tc_emulated(q, k, v, causal=causal, window=window)
        assert out.dtype == BF16 and out.shape == q.shape
        worst = max(worst, fc.bf16_ratio(out, q, k, v, causal=causal,
                                         window=window))
    print(f"{shape} sharpness {sharpness}: worst ratio {worst:.4f}")
    assert worst <= 1, worst


@pytest.mark.parametrize("shape,causal,window", fc.FLASH_RAGGED)
def test_flash_tc_emulated_within_bf16_limit_ragged(shape, causal, window):
    for sharpness in fc.FLASH_SHARPNESS:
        q, k, v = _inputs(shape, sharpness)
        out = fc.flash_tc_emulated(q, k, v, causal=causal, window=window)
        assert fc.bf16_ratio(out, q, k, v, causal=causal,
                             window=window) <= 1


@pytest.mark.parametrize("b,h,hkv,s,dh", fc.FLASH_GRID)
def test_plain_exact_and_jax_kernel_within_bf16_limit(b, h, hkv, s, dh):
    """attention_plain in bf16 against the exact answer rounded to bf16,
    and the TPU kernel (interpret mode) in bf16: both inside the limit."""
    for causal, window in fc.FLASH_MASKS[:3]:
        q, k, v = _inputs((b, h, hkv, s, s, dh), sharpness=8.0)
        plain = attention_plain(q, k, v, causal=causal, window=window)
        assert plain.dtype == BF16
        exact = _exact(q, k, v, causal, window).to(BF16)
        assert fc.bf16_ratio(exact, q, k, v, causal=causal, window=window,
                             plain=plain) <= 1
        with jax.enable_x64(False):
            j = j_flash(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                          for t in (q, k, v)), causal=causal, window=window,
                        block_q=64, block_k=64, interpret=True)
        j = torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16)
        assert fc.bf16_ratio(j, q, k, v, causal=causal, window=window,
                             plain=plain) <= 1


@pytest.mark.parametrize("name", list(fc.WRONG_ANSWERS))
def test_wrong_answers_exceed_bf16_limit(name):
    wrong, worst = fc.WRONG_ANSWERS[name], 0.0
    for sharpness in fc.FLASH_SHARPNESS:
        for shape in fc.FLASH_SHAPES:
            for causal, window in fc.FLASH_MASKS:
                q, k, v = _inputs(shape, sharpness)
                worst = max(worst, fc.bf16_ratio(
                    wrong(q, k, v, causal=causal, window=window), q, k, v,
                    causal=causal, window=window))
            if worst >= fc.WRONG_MARGIN:
                break
    print(f"{name}: {worst:.1f}x the limit")
    assert worst >= fc.WRONG_MARGIN, worst


def test_bf16_limit_terms():
    """ulp_bf16 is one bf16 ulp; the reorder term is a small fraction of
    the rounding term at the slice's sum lengths."""
    x = torch.tensor([1.0, 1.5, -3.0, 0.3, 0.0])
    ulp = fc.ulp_bf16(x)
    assert ulp[:3].tolist() == [2.0 ** -7, 2.0 ** -7, 2.0 ** -6]
    assert float(ulp[3]) == 2.0 ** -9 and 0 < float(ulp[4]) < 1e-38
    b, h, hkv, s, dh = fc.FLASH_SLICE
    q, k, _ = _inputs((1, 2, 1, 64, 64, dh))
    c = fc.reorder_c(q, k)
    c_slice = c + 3 * (s - 64) / 8    # Sk = 1920 at the same score bound
    assert 0 < c_slice * 2.0 ** -20 < 2.0 ** -9


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_flash_attention_strided_views_match_copy_path_bitwise(dtype):
    q, k, v = (t.to(dtype) for t in _inputs((2, 4, 2, 40, 40, 32),
                                            layout="bshd"))
    ops.reset_counts()
    out = ops.flash_attention(q, k, v, causal=True, window=8)
    # the path before the kernel read strides: contiguous BHSD copies
    ref = attention_plain(*(t.transpose(1, 2).contiguous() for t in
                            (q, k, v)), causal=True,
                          window=8).transpose(1, 2)
    assert out.shape == q.shape and out.is_contiguous()
    assert torch.equal(out, ref)
    assert (ops.flash_plain_calls, ops.flash_launches) == (1, 0)


def test_check_flash_refuses_a_non_unit_head_dim_stride():
    q = torch.zeros(1, 4, 16, 8).transpose(2, 3)        # (1, 4, 8, 16)
    k = v = torch.zeros(1, 2, 8, 16)
    assert q.stride(3) != 1
    with pytest.raises(ValueError, match="stride 1"):
        ops._check_flash(q, k, v)
    ops._check_flash(q.contiguous(), k, v)
    # any other stride is read in place
    ops._check_flash(torch.zeros(1, 8, 4, 16).transpose(1, 2), k, v)


def test_check_tma_refuses_unaligned_operands():
    good = torch.zeros(1, 2, 8, 64, dtype=BF16)
    ops._check_tma(good, good, good)
    ops._check_tma(torch.zeros(1, 8, 2, 128, dtype=BF16)[..., 64:]
                   .transpose(1, 2), good, good)
    with pytest.raises(ValueError, match="TMA"):   # 68 * 2 B sequence stride
        ops._check_tma(torch.zeros(1, 2, 8, 68, dtype=BF16)[..., :64],
                       good, good)
    flat = torch.zeros(1 + good.numel(), dtype=BF16)
    with pytest.raises(ValueError, match="TMA"):   # base 2 B off 16
        ops._check_tma(good, flat[1:].view(good.shape), good)
    # a dim of extent 1 is never stepped: its stride does not matter
    ops._check_tma(good[:, :1], good[:, :1], good[:, :1])


def test_check_row_strides_refuses_what_an_int_row_offset_cannot_step():
    def t(s, stride):
        return torch.empty_strided((1, 2, s, 16), (0, 0, stride, 1),
                                   device="meta")
    big = ops.F32_MAX_ROW_STRIDE
    ops._check_row_strides(t(8, 16), t(8, big - 1), t(8, 16), t(8, 16))
    with pytest.raises(ValueError, match="sequence stride"):
        ops._check_row_strides(t(8, 16), t(8, big), t(8, 16), t(8, 16))
    # a sequence of length 1 is never stepped
    ops._check_row_strides(t(1, 2 ** 40), t(8, 16), t(8, 16), t(1, 2 ** 40))


def test_flash_args_mirror_the_source():
    """The ctypes FlashArgs has the C struct's fields in its order."""
    src = (ROOT / "src" / "repro_torch" / "csrc" /
           "flash_attention.cu").read_text()
    body = re.search(r"struct FlashArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [re.sub(r"\[.*\]", "", n).strip(" *").split()[-1]
                      for n in decl.split(",")]
    assert names == [f for f, _ in ops.FlashArgs._fields_]
    # 4 pointers, 12 strides, 8 ints and a float, padded to 8 bytes
    assert ctypes.sizeof(ops.FlashArgs) == 4 * 8 + 12 * 8 + 9 * 4 + 4


def test_flash_cases_imports_no_jax_and_no_reference():
    code = ("import sys, repro_torch.kernels.flash_cases; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_flash_ab_needs_two_checkouts():
    from repro_torch.launch import flash_ab
    with pytest.raises(SystemExit):
        flash_ab.main(["only-one-root"])
