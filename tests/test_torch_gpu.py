"""The port's kernels on the card: ``fused_lincomb`` bitwise against its
plain version, and fused against unfused adjoint gradients bitwise on the
same card; ``flash_attention_bhsd`` against ``attention_plain`` with the
limits of ``repro_torch.kernels.flash_cases`` (bf16, the tensor-core
kernel: the elementwise limit derived from its arithmetic; fp32, the
CUDA-core kernel: rtol = atol = 2e-5, as ``tests/test_kernels.py``), on
ragged shapes and every head dim, the model layout read in place, its
refusals, its launch
count on an LM prefill, and the kernel's prefill against the naive one;
``rwkv6_chunked_bhsd`` against ``rwkv6_plain`` (the limits of
``repro_torch.kernels.rwkv6_cases``) and against the
sequential ``rwkv6_ref`` at the JAX package's limits, its refusals, and
its launch count on an RWKV6 prefill; the model path's in-place
``rwkv6_chunked_fp32`` bitwise equal to the kernel on upcast, padded
copies (ragged S, strided views, under ``rwkv6_mix_chunked``); and
CUDA-graph replay
(``repro_torch.launch.graphs.StepGraph``) bitwise equal to eager PyTorch:
decode of both LM families, the fixed-step gradient under every adjoint
policy, the CNF request, ``LMEngine`` sampling at temperature > 0, and
the refusals (a changed held tensor, a capture that fails); adaptive
Dopri5 (``fused_lincomb``'s scaled form at the adaptive CNF's leaf
shapes, the adaptive CNF request fused == unfused and captured == eager
bitwise, with the expected launches) and the implicit theta-method (the
three policies bitwise equal), each against the port's CPU run in fp64;
the offload tiers (every tier's gradient bitwise its device tier's
with its copies made on the card, the spill peak below the device
tier's, the planner's spill fallback, the adaptive ring and the eager
implicit route on spill/disk/host); and ``ODEEngine`` (captured == eager
on the device tier and the adaptive path, spill and disk == the device
tier, bitwise); LM training (the RWKV6 backward kernel against
``rwkv6_plain_vjp`` within ``RWKV6_BWD_TOL`` and its wrong answers beyond
10x, bitwise run to run; the depth remat policies' gradients bitwise
equal; a reduced RWKV6 train step against the port on the CPU); the MoE
block (reduced Mixtral's, card against the CPU on equal routing; two
backward calls bitwise equal; captured Mixtral decode bitwise eager) and
``int8_compress`` bitwise equal to the CPU's; RecurrentGemma's flash
case, the RG-LRU doubling scan, and the donated train step (`AdamW.update_`,
the donating step and a checkpoint before it) bitwise the functional one.
Marked ``gpu``; every test skips (inside a fixture) where there is no CUDA
device.  On the card:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import os

import numpy as np
import pytest
import torch

import dataclasses

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_arch
from repro_torch.core import adaptive as tad
from repro_torch.core import adjoint as tadj
from repro_torch.core import implicit as timp
from repro_torch.core.depth_ode import ODEBlock
from repro_torch.kernels import ops
from repro_torch.kernels.flash_cases import (FLASH_MASKS, FLASH_RAGGED,
                                             FLASH_SHAPES, FLASH_SHARPNESS,
                                             FLASH_TOL, bf16_ratio,
                                             flash_inputs)
from repro_torch.kernels.ref import (attention_plain, limit_ratio,
                                     lincomb_plain, rwkv6_plain, rwkv6_ref)
from repro_torch.kernels.rwkv6_cases import (RWKV6_GRID, RWKV6_REF_TOL,
                                             RWKV6_TOL, rwkv6_inputs)
from repro_torch.core.cnf import AdaptiveCNF, cnf_log_prob
from repro_torch.launch.graphs import StepGraph
from repro_torch.models import lm, ode_nets
from repro_torch.nn import ssm
from repro_torch.serve import LMEngine

# deterministic cuBLAS needs this before CUDA starts; harmless elsewhere
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

pytestmark = pytest.mark.gpu

WEIGHTS = [0.5, -0.25, 1 / 3, 2.0, -7 / 9, 0.1, 1e-3, 3.5]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "`python -m pytest -m gpu tests/test_torch_gpu.py`")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     det) = prev
    torch.use_deterministic_algorithms(det)


def _bits(x):
    return x.contiguous().view({torch.float32: torch.int32,
                                torch.bfloat16: torch.int16}.get(
                                    x.dtype, torch.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_terms", [1, 2, 5, 8])
@pytest.mark.parametrize("form", ["static", "static-bc0", "scaled",
                                  "scaled-bc"])
@pytest.mark.parametrize("n", [1, 7, 4097, 100003])
def test_fused_lincomb_bitwise_vs_plain(cuda, dtype, n_terms, form, n):
    gen = torch.Generator().manual_seed(n + n_terms)
    buf = torch.randn(3 + (n_terms + 1) * n, generator=gen,
                      dtype=dtype).to(cuda)
    base = buf[3:3 + n]  # storage offset
    terms = [buf[3 + (i + 1) * n: 3 + (i + 2) * n] for i in range(n_terms)]
    ws = WEIGHTS[:n_terms]
    scale = torch.tensor(0.037, dtype=dtype).to(cuda) \
        if form.startswith("scaled") else 0.037
    bc = {"static": None, "static-bc0": 0.0, "scaled": None,
          "scaled-bc": -2 / 3}[form]
    before = ops.launches
    out = ops.fused_lincomb(base, terms, ws, scale, bc)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    ref = lincomb_plain(base, terms, ws, scale, bc)
    assert torch.equal(_bits(out), _bits(ref))


def test_fused_lincomb_special_values_and_refusals(cuda):
    lam = torch.tensor([float("nan"), -1.0, 1.0, -0.0, float("inf")],
                       device=cuda)
    t = torch.tensor([0.0, 0.0, -0.0, 0.0, 1.0], device=cuda)
    out = ops.fused_lincomb(lam, [t], [-1.0], None, 0.0)
    assert torch.equal(_bits(out),
                       _bits(lincomb_plain(lam, [t], [-1.0], None, 0.0)))
    half = torch.zeros(4, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.fused_lincomb(half, [half], [1.0])
    x = torch.zeros(4, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        ops.fused_lincomb(x, [x] * 9, [1.0] * 9)
    with pytest.raises(ValueError, match="match base"):
        ops.fused_lincomb(x, [x.cpu()], [1.0])


def _mlp_case(device, dtype):
    rs = np.random.RandomState(0)
    u0 = torch.tensor(rs.randn(16, 5), dtype=dtype, device=device)
    th = {"W": torch.tensor(0.4 * rs.randn(5, 5), dtype=dtype, device=device),
          "b": torch.tensor(0.1 * rs.randn(5), dtype=dtype, device=device)}

    def f(u, th, t):
        return torch.tanh(u @ th["W"] + th["b"]) - 0.2 * u

    return f, u0, th


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", ["rk4", "dopri5"])
@pytest.mark.parametrize("policy,ncheck", [("pnode", None), ("pnode2", None),
                                           ("revolve", 3), ("revolve2", 3)])
def test_fused_grads_bitwise_unfused_on_card(cuda, dtype, method, policy,
                                             ncheck):
    f, u0, th = _mlp_case(cuda, dtype)

    def grads(fused):
        a = u0.clone().requires_grad_(True)
        b = {k: v.clone().requires_grad_(True) for k, v in th.items()}
        uf = tadj.odeint(f, a, b, dt=0.1, n_steps=6, method=method,
                         adjoint=policy, ncheck=ncheck, fused_stages=fused)
        return torch.autograd.grad((uf ** 2).sum(), [a, b["W"], b["b"]])

    ops.reset_counts()
    g_fused = grads(True)
    assert ops.launches == tadj.expected_lincomb_calls(method, 6, 1, policy,
                                                       ncheck)
    assert ops.plain_calls == 0
    for a, b in zip(g_fused, grads(False)):
        assert torch.equal(_bits(a), _bits(b))


def test_classifier_grads_bitwise_unfused_on_card(cuda):
    gen = torch.Generator().manual_seed(0)
    params = ode_nets.classifier_init(gen, channels=16, device=cuda)
    rs = np.random.RandomState(1)
    images = torch.tensor(rs.randn(8, 16, 16, 3), dtype=torch.float32,
                          device=cuda)
    labels = torch.tensor(rs.randint(0, 10, 8), device=cuda)

    def grads(fused):
        block = ODEBlock(ode_nets.conv_vf, n_steps=3, fused_stages=fused)
        leaves = [p.detach().clone().requires_grad_(True)
                  for p in torch.utils._pytree.tree_leaves(params)]
        p = torch.utils._pytree.tree_unflatten(
            leaves, torch.utils._pytree.tree_structure(params))
        logits = ode_nets.classifier_apply(
            p, images, odeint_fn=lambda vf, u, th: block(u, th))
        return torch.autograd.grad(ode_nets.softmax_xent(logits, labels),
                                   leaves)

    ops.reset_counts()
    g_fused = grads(True)
    assert ops.launches == tadj.expected_lincomb_calls("rk4", 3, 1, "pnode")
    for a, b in zip(g_fused, grads(False)):
        assert torch.equal(_bits(a), _bits(b))


def _qkv(shape, dtype, device, seed=0, **kw):
    return flash_inputs(*shape, np.random.RandomState(seed), device=device,
                        dtype=dtype, **kw)


def _check_flash_case(device, dtype, shape, causal, window):
    """bf16 (the tensor-core kernel) within the derived limit at diffuse
    and sharp scores; fp32 (the CUDA-core kernel) within FLASH_TOL."""
    mask = dict(causal=causal, window=window)
    for sharp in (FLASH_SHARPNESS if dtype == torch.bfloat16 else (1.0,)):
        q, k, v = _qkv(shape, dtype, device, sharpness=sharp)
        before = ops.flash_launches
        out = ops.flash_attention_bhsd(q, k, v, **mask)
        torch.cuda.synchronize()
        assert ops.flash_launches == before + 1
        ref = attention_plain(q, k, v, **mask)
        assert out.dtype == dtype and out.shape == ref.shape
        if dtype == torch.bfloat16:
            ratio = bf16_ratio(out, q, k, v, plain=ref, **mask)
            print(f"{shape} {mask} sharpness {sharp}: ratio {ratio:.4f}")
            assert ratio <= 1, ratio
        else:
            torch.testing.assert_close(out, ref, **FLASH_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_attention_vs_plain(cuda, dtype, shape, causal, window):
    _check_flash_case(cuda, dtype, shape, causal, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal,window", FLASH_RAGGED)
def test_flash_attention_ragged_every_head_dim(cuda, dtype, shape, causal,
                                               window):
    _check_flash_case(cuda, dtype, shape, causal, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_model_layout_is_read_in_place_bitwise(cuda, dtype):
    qs, ks, vs = _qkv((2, 8, 2, 300, 300, 64), dtype, cuda, layout="bshd")
    out = ops.flash_attention(qs, ks, vs, causal=True, window=100)
    ref = ops.flash_attention_bhsd(
        *(t.transpose(1, 2).contiguous() for t in (qs, ks, vs)),
        causal=True, window=100)
    assert out.shape == qs.shape and out.is_contiguous()
    assert torch.equal(out, ref.transpose(1, 2))
    # a slice of a wider buffer (a fused projection's q) is read in place
    wide = torch.randn(2, 300, 8, 64 + 64, device=cuda).to(dtype)
    q = wide[..., 64:]
    assert torch.equal(ops.flash_attention(q, ks, vs),
                       ops.flash_attention(q.contiguous(), ks, vs))


def test_flash_attention_refuses_on_the_card(cuda):
    q, k, v = _qkv((1, 4, 2, 8, 8, 16), torch.float16, cuda)
    with pytest.raises(TypeError):
        ops.flash_attention_bhsd(q, k, v)
    q, k, v = _qkv((1, 4, 2, 8, 8, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="devices"):
        ops.flash_attention_bhsd(q, k.cpu(), v)
    q, k, v = _qkv((1, 4, 2, 64, 64, 64), torch.bfloat16, cuda)
    before = ops.flash_launches
    # a sequence stride of 68 elements (136 B) is no multiple of 16 B
    odd = torch.zeros(1, 4, 64, 68, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="TMA"):
        ops.flash_attention_bhsd(odd[..., :64], k, v)
    # a base 2 bytes past a 16-byte boundary
    flat = torch.zeros(1 + q.numel(), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="TMA"):
        ops.flash_attention_bhsd(flat[1:].view(q.shape), k, v)
    # a head dim that is not contiguous
    with pytest.raises(ValueError, match="stride 1"):
        ops.flash_attention_bhsd(q.transpose(2, 3), k, v)
    # an fp32 sequence stride beyond the kernel's 32-bit row offsets
    buf = torch.zeros(ops.F32_MAX_ROW_STRIDE + 16, device=cuda)
    q32 = buf.as_strided((1, 1, 2, 16), (0, 0, ops.F32_MAX_ROW_STRIDE, 1))
    k32 = torch.zeros(1, 1, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="sequence stride"):
        ops.flash_attention_bhsd(q32, k32, k32)
    del buf, q32
    assert ops.flash_launches == before


def _lm_case(device, impl, n_layers=3, dtype="float32"):
    cfg = reduced(get_arch("tinyllama-1.1b"), n_layers=n_layers,
                  d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
                  d_ff=512, vocab_size=512, attn_impl=impl,
                  param_dtype=dtype, compute_dtype=dtype)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device=device)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, 512, (2, 100))).to(device)
    return cfg, params, toks


def test_prefill_launch_count_and_pallas_vs_naive(cuda):
    cfg, params, toks = _lm_case(cuda, "pallas")
    ops.reset_counts()
    with torch.no_grad():
        state, last = lm.prefill(cfg, params, {"tokens": toks}, 128)
        torch.cuda.synchronize()
        assert ops.flash_launches == lm.expected_flash_calls(cfg, 1) == 3
        assert ops.flash_plain_calls == 0
        naive = dataclasses.replace(cfg, attn_impl="naive")
        state_n, last_n = lm.prefill(naive, params, {"tokens": toks}, 128)
    assert ops.flash_launches == 3  # the naive prefill launched nothing
    torch.testing.assert_close(last, last_n, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(state["scan"]["0_a"]["k"],
                               state_n["scan"]["0_a"]["k"])
    # decode from both states gives the same greedy tokens
    tok = torch.argmax(last, -1)[:, None]
    tok_n = tok.clone()
    with torch.no_grad():
        for i in range(8):
            lg, state = lm.decode_step(cfg, params, state, tok, 100 + i)
            lg_n, state_n = lm.decode_step(naive, params, state_n, tok_n,
                                           100 + i)
            tok, tok_n = torch.argmax(lg, -1)[:, None], \
                torch.argmax(lg_n, -1)[:, None]
            assert torch.equal(tok, tok_n)


def test_prefill_bf16_pallas_vs_naive(cuda):
    cfg, params, toks = _lm_case(cuda, "pallas", dtype="bfloat16")
    with torch.no_grad():
        _, last = lm.prefill(cfg, params, {"tokens": toks}, 128)
        _, last_n = lm.prefill(dataclasses.replace(cfg, attn_impl="naive"),
                               params, {"tokens": toks}, 128)
    rel = float((last.float() - last_n.float()).abs().max()
                / last_n.float().abs().max())
    assert rel < 5e-2, rel


# the JAX package's grid, then every supported dh x chunk
RWKV6_CASES = RWKV6_GRID + [(2, 3, 192, dh, c) for dh in ops.RWKV6_HEAD_DIMS
                            for c in ops.RWKV6_CHUNKS]
REF_FP32 = RWKV6_REF_TOL["float32"]


def _rwkv6_inputs(b, h, s, dh, dtype, device, seed=0):
    return [t.to(device) for t in rwkv6_inputs(
        b, h, s, dh, torch.Generator().manual_seed(seed), dtype=dtype)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s,dh,chunk", RWKV6_CASES)
def test_rwkv6_kernel_vs_plain_and_sequential(cuda, dtype, b, h, s, dh,
                                              chunk):
    a = _rwkv6_inputs(b, h, s, dh, dtype, cuda)
    before = ops.rwkv6_launches
    out, sfin = ops.rwkv6_chunked_bhsd(*a, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.rwkv6_launches == before + 1
    assert out.dtype == dtype and sfin.dtype == torch.float32
    name = str(dtype).removeprefix("torch.")
    po, ps = rwkv6_plain(*a, chunk=chunk)
    assert limit_ratio(out, po, *RWKV6_TOL[name]) <= 1
    assert limit_ratio(sfin, ps, *RWKV6_TOL["float32"]) <= 1
    ro, rs = rwkv6_ref(*a)
    torch.testing.assert_close(out.float(), ro.float(), **RWKV6_REF_TOL[name])
    torch.testing.assert_close(sfin, rs, **RWKV6_REF_TOL[name])


def test_rwkv6_kernel_chunk_independence_and_padding(cuda):
    a = _rwkv6_inputs(1, 2, 128, 32, torch.float32, cuda, seed=3)
    o1, s1 = ops.rwkv6_chunked_bhsd(*a, chunk=16)
    o2, s2 = ops.rwkv6_chunked_bhsd(*a, chunk=64)
    torch.testing.assert_close(o1, o2, **REF_FP32)
    torch.testing.assert_close(s1, s2, **REF_FP32)
    for s, chunk in ((32, 16), (96, 32), (160, 32)):
        r, k, v, logw, u = _rwkv6_inputs(1, 2, s, 16, torch.float32, cuda,
                                         seed=s)
        bs = [t.transpose(1, 2) for t in (r, k, v, logw)]   # (B,S,H,dh)
        out, sfin = ops.rwkv6_chunked(*bs, u, chunk=chunk)
        ro, rs = rwkv6_ref(r, k, v, logw, u)
        torch.testing.assert_close(out, ro.transpose(1, 2),
                                   **REF_FP32)
        torch.testing.assert_close(sfin, rs, **REF_FP32)


def test_rwkv6_refuses_on_the_card(cuda):
    a = _rwkv6_inputs(1, 2, 64, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.rwkv6_chunked_bhsd(*_rwkv6_inputs(1, 2, 64, 48, torch.float32,
                                              cuda), chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        ops.rwkv6_chunked_bhsd(*a, chunk=8)
    with pytest.raises(TypeError):
        ops.rwkv6_chunked_bhsd(*(t.half() for t in a), chunk=16)
    with pytest.raises(ValueError, match="devices"):
        ops.rwkv6_chunked_bhsd(*a[:4], a[4].cpu(), chunk=16)
    # a carried state: the kernel starts from zero, as the TPU kernel does
    params = ssm.init_rwkv6(torch.Generator().manual_seed(0), 64, 4,
                            device=cuda)
    x = torch.randn(1, 300, 64, device=cuda)
    state = torch.zeros(1, 4, 16, 16, device=cuda)
    with pytest.raises(NotImplementedError, match="zero state"):
        ssm.rwkv6_mix_chunked(params, x, 4, state)


INPLACE_S = [1, 31, 63, 64, 65, 127, 300, 2047]


def _bshd_inputs(b, s, h, dh, dtype, device, seed=0, sliced=False):
    """The kernel-test inputs in the model's (B,S,H,dh) layout, from a numpy
    seed: r/k/v in ``dtype``, logw and u fp32; with ``sliced``, views cut
    out of larger tensors (batch, sequence and head strides of their own,
    a base past the tensor's start)."""
    big = (b + 1, s + 5, h + 2) if sliced else (b, s, h)
    r, k, v, logw, u = (t.to(device) for t in rwkv6_inputs(
        big[0], big[2], big[1], dh, np.random.RandomState(seed),
        layout="bshd"))
    r, k, v = (t.to(dtype) for t in (r, k, v))
    if sliced:
        r, k, v, logw = (t[1:, 3:3 + s, 2:2 + h] for t in (r, k, v, logw))
        u = u[2:2 + h]
    return r, k, v, logw, u


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,chunk", [(64, 64), (32, 16), (128, 32)])
@pytest.mark.parametrize("s", INPLACE_S)
def test_rwkv6_inplace_bitwise_equals_the_padded_composition(cuda, dtype, dh,
                                                             chunk, s):
    """The model path's in-place read against what it replaces: the same
    kernel on upcast, zero-padded, contiguous (B,H,S',dh) copies."""
    a = _bshd_inputs(2, s, 3, dh, dtype, cuda, seed=s)
    ops.reset_counts()
    out, state = ops.rwkv6_chunked_fp32(*a, chunk=chunk)
    torch.cuda.synchronize()
    assert (ops.rwkv6_launches, ops.rwkv6_plain_calls) == (1, 0)
    assert out.dtype == torch.float32 and out.shape == a[0].shape
    assert out.is_contiguous()
    ref_out, ref_state = ops.rwkv6_chunked(*(t.float() for t in a[:4]), a[4],
                                           chunk=chunk)
    assert torch.equal(_bits(out), _bits(ref_out))
    assert torch.equal(_bits(state), _bits(ref_state))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [65, 300])
def test_rwkv6_inplace_reads_strided_views_bitwise(cuda, dtype, s):
    a = _bshd_inputs(2, s, 3, 64, dtype, cuda, seed=s, sliced=True)
    assert not a[0].is_contiguous() and a[0].data_ptr() != \
        a[0]._base.data_ptr()
    out, state = ops.rwkv6_chunked_fp32(*a, chunk=64)
    dense_out, dense_state = ops.rwkv6_chunked_fp32(
        *(t.contiguous() for t in a), chunk=64)
    ref_out, ref_state = ops.rwkv6_chunked(*(t.float() for t in a[:4]), a[4],
                                           chunk=64)
    for o, st in ((dense_out, dense_state), (ref_out, ref_state)):
        assert torch.equal(_bits(out), _bits(o))
        assert torch.equal(_bits(state), _bits(st))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_mix_chunked_equals_the_upcast_route_bitwise(cuda, dtype):
    """``rwkv6_mix_chunked`` reads the projections in place; the route it
    replaced upcast them with ``.float()`` and called ``rwkv6_chunked``.
    Same weights, same bits, one launch each."""
    d, heads, s = 256, 4, 300
    params = ssm.init_rwkv6(torch.Generator().manual_seed(0), d, heads,
                            dtype, device=cuda)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, s, d).astype(
        np.float32)).to(cuda, dtype)
    ops.reset_counts()
    with torch.no_grad():
        y, state = ssm.rwkv6_mix_chunked(params, x, heads)
        r, k, v, g, logw = ssm.rwkv6_projections(params, x, heads)
        yo, so = ops.rwkv6_chunked(*(t.float() for t in (r, k, v, logw)),
                                   params["u_bonus"], chunk=64)
        y_old = ssm._rwkv_out(params, yo, g, dtype, 2, s, d)
    assert (ops.rwkv6_launches, ops.rwkv6_plain_calls) == (2, 0)
    assert y.dtype == dtype and torch.equal(_bits(y), _bits(y_old))
    assert torch.equal(_bits(state), _bits(so))


def test_rwkv6_inplace_refuses_on_the_card(cuda):
    a = _bshd_inputs(1, 64, 2, 64, torch.bfloat16, cuda)
    flat = torch.zeros(2 * 64 * 2 * 64 + 8, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:1 + a[0].numel()].view(a[0].shape)   # 2-byte base
    with pytest.raises(ValueError, match="16-byte aligned base"):
        ops.rwkv6_chunked_fp32(shifted, *a[1:], chunk=64)
    with pytest.raises(ValueError, match="16-byte aligned base"):
        ops.rwkv6_chunked_bhsd(*(flat[1:1 + a[0].numel()].view(1, 2, 64, 64)
                                 for _ in range(4)), a[4].bfloat16(), chunk=64)
    with pytest.raises(ValueError, match="head dim"):
        ops.rwkv6_chunked_fp32(*_bshd_inputs(1, 64, 2, 48, torch.bfloat16,
                                             cuda), chunk=64)
    with pytest.raises(ValueError, match="chunk"):
        ops.rwkv6_chunked_fp32(*a, chunk=8)
    with pytest.raises(TypeError, match="logw and u fp32"):
        ops.rwkv6_chunked_fp32(*a[:3], a[3].bfloat16(), a[4], chunk=64)
    with pytest.raises(ValueError, match="devices"):
        ops.rwkv6_chunked_fp32(*a[:4], a[4].cpu(), chunk=64)


def _rwkv6_lm_case(device):
    cfg = reduced(get_arch("rwkv6-7b"), n_layers=3, d_model=256, n_heads=4,
                  head_dim=64, d_ff=512, vocab_size=512,
                  param_dtype="float32", compute_dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device=device)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, 512, (2, 300)))
    return cfg, params, toks


def test_rwkv6_prefill_launch_count_and_cpu_agreement(cuda):
    cfg, params, toks = _rwkv6_lm_case(cuda)
    ops.reset_counts()
    with torch.no_grad():
        state, last = lm.prefill(cfg, params, {"tokens": toks.to(cuda)}, 304)
        torch.cuda.synchronize()
        assert ops.rwkv6_launches == lm.expected_rwkv6_calls(cfg, 300, 1) \
            == 3
        assert ops.rwkv6_plain_calls == 0
        p_cpu = torch.utils._pytree.tree_map(lambda t: t.cpu(), params)
        state_c, last_c = lm.prefill(cfg, p_cpu, {"tokens": toks}, 304)
    rel = float((last.cpu() - last_c).abs().max() / last_c.abs().max())
    assert rel < 1e-4, rel
    torch.testing.assert_close(state["scan"]["0_w"]["S"].cpu(),
                               state_c["scan"]["0_w"]["S"], rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# CUDA graphs: replay against eager, bitwise
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_nondet(cuda):
    """The card with deterministic algorithms off, as the LM serve runs:
    under them PyTorch routes decode's KV-cache ``index_copy_`` through an
    indexed write that checks its range on the host, which a capture
    refuses."""
    torch.use_deterministic_algorithms(False)
    yield cuda


def _same_bits(a, b):
    la, lb = torch.utils._pytree.tree_leaves(a), \
        torch.utils._pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-7b",
                                  "mixtral-8x7b"])
def test_decode_replay_bitwise_eager(cuda_nondet, arch, dtype):
    dev = cuda_nondet
    cfg = reduced(get_arch(arch), n_layers=2, d_model=256, n_heads=4,
                  head_dim=64, d_ff=512, vocab_size=512, param_dtype=dtype,
                  compute_dtype=dtype)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, 512, (2, 40))).to(dev)

    def step(held, copied):
        return lm.decode_step(cfg, held[0], held[1], *copied)[0]

    graph = StepGraph(step, clone_outputs=False)
    with torch.no_grad():
        st_eager, last = lm.prefill(cfg, params, {"tokens": toks}, 56)
        tok = torch.argmax(last, -1)[:, None]
        pos = torch.zeros((), dtype=torch.long, device=dev)
        # warm-up and capture on a state of its own, then the prefill's in
        st_graph = lm.init_decode_state(cfg, 2, 56, device=dev)
        graph.capture((params, st_graph), (tok, pos))
        for a, b in zip(torch.utils._pytree.tree_leaves(st_graph),
                        torch.utils._pytree.tree_leaves(st_eager)):
            a.copy_(b)
        for i in range(12):
            le, st_eager = lm.decode_step(cfg, params, st_eager, tok, 40 + i)
            pos.fill_(40 + i)
            lg = graph((params, st_graph), (tok, pos))
            assert _same_bits(le, lg)
            tok = torch.argmax(le, -1)[:, None]
    assert graph.graph is not None and graph.pool_bytes > 0
    assert _same_bits(st_eager, st_graph)


def _policy_inputs(device, seed):
    rs = np.random.RandomState(seed)
    u0 = torch.tensor(rs.randn(16, 5), device=device)
    th = {"W": torch.tensor(0.4 * rs.randn(5, 5), device=device),
          "b": torch.tensor(0.1 * rs.randn(5), device=device)}
    return u0, th


@pytest.mark.parametrize("policy", tadj.POLICIES)
def test_odeint_gradient_replay_bitwise_eager(cuda, policy):
    f, _, _ = _mlp_case(cuda, torch.float64)
    ncheck = 3 if policy.startswith("revolve") else None
    fused = policy in ("pnode", "pnode2", "revolve", "revolve2")

    def grads(held, copied):
        u0, th = copied
        a = u0.detach().requires_grad_(True)
        b = {k: v.detach().requires_grad_(True) for k, v in th.items()}
        uf = tadj.odeint(f, a, b, dt=0.1, n_steps=6, method="rk4",
                         adjoint=policy, ncheck=ncheck, fused_stages=fused)
        return list(torch.autograd.grad((uf ** 2).sum(), [a, b["W"],
                                                          b["b"]]))

    graph = StepGraph(grads, clone_outputs=True)
    for seed in (0, 1):  # the second replay reads new copied inputs
        args = _policy_inputs(cuda, seed)
        assert _same_bits(graph((), args), grads((), args))
    assert graph.graph is not None


def _planner_case(device):
    rs = np.random.RandomState(3)
    u0 = torch.tensor(rs.randn(2048, 64), device=device)
    th = {"W": torch.tensor(0.1 * rs.randn(64, 64), device=device),
          "b": torch.tensor(0.1 * rs.randn(64), device=device)}

    def f(u, th, t):
        return torch.tanh(u @ th["W"] + th["b"]) - 0.2 * u

    return f, u0, th


@pytest.mark.parametrize("anchor", [("pnode", None), ("pnode2", None),
                                    ("revolve", 3)],
                         ids=["pnode", "pnode2", "revolve3"])
def test_auto_plan_fits_its_budget_on_the_cuda_allocator(cuda, anchor):
    """The measured check reads the CUDA allocator; an auto plan at an
    anchor policy's measured peak fits it, measured again in a window of
    its own, and its gradient is the chosen policy's bitwise."""
    from repro_torch.mem import model as tmodel
    from repro_torch.mem.planner import plan_odeint
    f, u0, th = _planner_case(cuda)
    kw = dict(dt=0.05, n_steps=8, method="rk4")
    m = tmodel.measure_reverse_cost(f, u0, th, policy=anchor[0],
                                    ncheck=anchor[1], fused_stages=True,
                                    **kw)
    assert m["source"] == "cuda_allocator" and m["peak_bytes"] > 0
    assert m["argument_bytes"] == tmodel.tree_bytes((u0, th))
    budget = m["peak_bytes"]
    plan = plan_odeint(f, u0, th, mem_budget=budget, fused_stages=True, **kw)
    assert plan.offload is None and plan.measured_bytes <= budget
    before = tmodel.measurements
    auto = tmodel.reverse_pass(f, u0, th, policy="auto", mem_budget=budget,
                               fused_stages=True, **kw)
    assert tmodel.allocator_peak(auto, cuda) <= budget
    assert tmodel.measurements == before
    explicit = tmodel.reverse_pass(f, u0, th, policy=plan.policy,
                                   ncheck=plan.ncheck,
                                   fused_stages=plan.policy in
                                   tadj._FUSED_POLICIES, **kw)
    assert _same_bits(auto(), explicit())


def test_auto_gradient_is_measured_in_the_warmup_and_captured(cuda):
    """StepGraph's eager warm-up fills the measurement cache, so the
    capture measures nothing; the replay is the eager gradient bitwise."""
    from repro_torch.mem import model as tmodel
    f, u0, th = _planner_case(cuda)
    budget = 4 * tmodel.measure_reverse_cost(
        f, u0, th, dt=0.05, n_steps=6, policy="pnode2",
        fused_stages=True)["peak_bytes"]

    def grads(held, copied):
        a = copied.detach().requires_grad_(True)
        b = {k: v.detach().requires_grad_(True) for k, v in held.items()}
        uf = tadj.odeint(f, a, b, dt=0.05, n_steps=6, method="rk4",
                         adjoint="auto", mem_budget=budget,
                         fused_stages=True)
        return list(torch.autograd.grad((uf ** 2).sum(), [a, b["W"],
                                                          b["b"]]))

    graph = StepGraph(grads, clone_outputs=True)
    out = graph(th, u0)
    assert graph.graph is not None
    before = tmodel.measurements
    assert _same_bits(out, grads(th, u0))
    assert _same_bits(graph(th, u0 * 0.5), grads(th, u0 * 0.5))
    assert tmodel.measurements == before


def test_cnf_request_replay_bitwise_eager(cuda):
    theta = ode_nets.cnf_vf_init(torch.Generator().manual_seed(0), 6,
                                 hidden=(32, 32, 32), device=cuda)
    kw = dict(dt=0.25, n_steps=4, method="dopri5", adjoint="pnode",
              fused_stages=True)

    def request(th, x):
        with torch.no_grad():
            density = cnf_log_prob(ode_nets.cnf_vf, x, th, **kw)
        xg = x.detach().clone().requires_grad_(True)
        lp = cnf_log_prob(ode_nets.cnf_vf, xg, th, **kw)
        return density, torch.autograd.grad(lp.sum(), xg)[0]

    graph = StepGraph(request, clone_outputs=True)
    for seed in (0, 1):
        x = torch.tensor(np.random.RandomState(seed).randn(256, 6),
                         dtype=torch.float32, device=cuda)
        assert _same_bits(graph(theta, x), request(theta, x))


@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["buckets", "adaptive"])
def test_ode_engine_captured_equals_eager_and_the_tiers(cuda, adaptive,
                                                        tmp_path):
    """``ODEEngine`` on the card: the captured programs (device tier, and
    the adaptive path) equal the eager ones bitwise, the spill and disk
    tiers the device tier, for every kind; every census is empty after."""
    from repro_torch.serve import BucketSpec, ODEEngine
    theta = ode_nets.cnf_vf_init(torch.Generator().manual_seed(0), 6,
                                 hidden=(32, 32, 32), device=cuda)
    w = torch.randn(6, 3, generator=torch.Generator().manual_seed(1)).to(cuda)
    pts = np.random.RandomState(4).randn(2 if adaptive else 7, 6).astype(
        np.float32)
    cases = ([dict(offload="spill"), dict(offload="spill", capture=False)]
             if adaptive else
             [dict(offload=None), dict(offload=None, capture=False),
              dict(offload="spill"), dict(offload="disk",
                                          spool_dir=str(tmp_path))])
    outs = []
    for kw in cases:
        with ODEEngine(ode_nets.cnf_vf, theta, dim=6, dt=0.25, n_steps=4,
                       method="dopri5", offload_segment=2,
                       head=lambda u: u @ w, buckets=BucketSpec((8,)),
                       adaptive=adaptive,
                       max_steps=64, device=cuda, **kw) as eng:
            ts = {k: [eng.submit(k, p) for p in pts] for k in ODEEngine.KINDS}
            eng.run()
            outs.append({k: [t.result(30) for t in v] for k, v in ts.items()})
            assert not any(eng.slot_census().values())
    for other in outs[1:]:
        for k in ODEEngine.KINDS:
            assert all(np.array_equal(a, b)
                       for a, b in zip(outs[0][k], other[k])), k


def test_engine_replay_sampling_matches_the_eager_loop(cuda_nondet):
    dev = cuda_nondet
    cfg = reduced(get_arch("tinyllama-1.1b"))
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    prompts = np.random.RandomState(2).randint(0, 256, (2, 12))
    kw = dict(lanes=2, prompt_len=12, max_gen=10, decode_slice=4,
              temperature=0.8, seed=5, params=params, device=dev)
    eng = LMEngine(cfg, **kw)
    tickets = [eng.submit(p) for p in prompts]
    eng.run()
    served = np.stack([t.result(5.0) for t in tickets])
    assert eng.decode_graph.graph is not None
    # the eager loop samples with a second engine's rule and generator
    # (seeded alike), in the engine's order: the prefill, then each step
    ref = LMEngine(cfg, **kw)
    toks = torch.from_numpy(prompts.astype(np.int32)).to(dev)
    with torch.no_grad():
        state, logits = lm.prefill(cfg, params, {"tokens": toks}, 22)
        tok = ref._sample(logits)[:, None]
        out = [tok]
        for i in range(9):
            logits, state = lm.decode_step(cfg, params, state, tok, 12 + i)
            tok = ref._sample(torch.nan_to_num(logits))[:, None]
            out.append(tok)
    np.testing.assert_array_equal(served, torch.cat(out, 1).cpu().numpy())


# ---------------------------------------------------------------------------
# adaptive Dopri5 and the implicit theta-method on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(10000, 6), (10000,)])
@pytest.mark.parametrize("n_terms,bc", [(1, None), (5, None), (6, None),
                                        (4, 1.0), (3, 0.0)])
def test_fused_lincomb_scaled_form_at_the_adaptive_shapes(cuda, dtype, shape,
                                                          n_terms, bc):
    """The form the adaptive path launches: h a 0-d tensor on the card, in
    the state's dtype, at the CNF state's (10000, 6) and log-density
    (10000,) leaves."""
    gen = torch.Generator().manual_seed(n_terms)
    base = torch.randn(shape, generator=gen, dtype=dtype).to(cuda)
    terms = [torch.randn(shape, generator=gen, dtype=dtype).to(cuda)
             for _ in range(n_terms)]
    h = torch.tensor(0.0123456789, dtype=dtype).to(cuda)
    ws = WEIGHTS[:n_terms]
    before = ops.launches
    out = ops.fused_lincomb(base, terms, ws, h, bc)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert torch.equal(_bits(out), _bits(lincomb_plain(base, terms, ws, h,
                                                       bc)))


def _adaptive_request(cnf, theta, x):
    with torch.no_grad():
        density, info = cnf.log_prob(x, theta)
    xg = x.detach().clone().requires_grad_(True)
    lp, info_g = cnf.log_prob(xg, theta)
    (score,) = torch.autograd.grad(lp.sum(), xg)
    assert info == info_g
    return density, score, info


def test_adaptive_cnf_fused_unfused_and_captured_bitwise(cuda):
    theta = ode_nets.cnf_vf_init(torch.Generator().manual_seed(0), 6,
                                 hidden=(32, 32, 32), device=cuda)
    x = torch.tensor(np.random.RandomState(0).randn(512, 6),
                     dtype=torch.float32, device=cuda)
    unfused = _adaptive_request(AdaptiveCNF(ode_nets.cnf_vf, 6), theta, x)
    fused_cnf = AdaptiveCNF(ode_nets.cnf_vf, 6, fused_stages=True)
    ops.reset_counts()
    fused = _adaptive_request(fused_cnf, theta, x)
    info = fused[2]
    assert ops.plain_calls == 0
    # the density's forward, then the score's forward and reverse sweep
    assert ops.launches == tad.expected_adaptive_lincomb_calls(
        info.n_accepted, info.n_rejected, 2, backward=False) \
        + tad.expected_adaptive_lincomb_calls(info.n_accepted,
                                              info.n_rejected, 2)
    captured_cnf = AdaptiveCNF(ode_nets.cnf_vf, 6, fused_stages=True,
                               capture=True)
    captured = _adaptive_request(captured_cnf, theta, x)
    assert unfused[2] == fused[2] == captured[2]
    assert _same_bits(list(fused[:2]), list(unfused[:2]))
    assert _same_bits(list(captured[:2]), list(fused[:2]))
    graphs = captured_cnf.solver._graphs
    assert set(graphs) == {"attempt", "attempt_record", "adjoint"}
    assert all(g.graph is not None for g in graphs.values())
    # replays on new points: the same bits as eager on them
    x2 = torch.tensor(np.random.RandomState(1).randn(512, 6),
                      dtype=torch.float32, device=cuda)
    again = _adaptive_request(captured_cnf, theta, x2)
    eager = _adaptive_request(fused_cnf, theta, x2)
    assert again[2] == eager[2]
    assert _same_bits(list(again[:2]), list(eager[:2]))


def test_adaptive_cnf_one_point_requests_captured_bitwise(cuda):
    """The engine's adaptive request, one point (6,) a solve: one captured
    solver serves a stream of points, each with its own steps, bitwise
    equal to an eager fused solve of the same point; the eager solve
    launches the expected ``fused_lincomb`` count on its (6,) and 0-d
    leaves."""
    theta = ode_nets.cnf_vf_init(torch.Generator().manual_seed(0), 6,
                                 hidden=(32, 32, 32), device=cuda)
    xs = torch.tensor(np.random.RandomState(0).randn(3, 6),
                      dtype=torch.float32, device=cuda)
    eager_cnf = AdaptiveCNF(ode_nets.cnf_vf, 6, fused_stages=True)
    captured_cnf = AdaptiveCNF(ode_nets.cnf_vf, 6, fused_stages=True,
                               capture=True)
    for i, x in enumerate(xs):
        ops.reset_counts()
        eager = _adaptive_request(eager_cnf, theta, x)
        info = eager[2]
        assert ops.plain_calls == 0
        assert ops.launches == tad.expected_adaptive_lincomb_calls(
            info.n_accepted, info.n_rejected, 2, backward=False) \
            + tad.expected_adaptive_lincomb_calls(info.n_accepted,
                                                  info.n_rejected, 2)
        captured = _adaptive_request(captured_cnf, theta, x)
        assert captured[2] == info, i
        assert eager[0].shape == () and eager[1].shape == (6,)
        assert _same_bits(list(captured[:2]), list(eager[:2])), i


def _pulse_f(u, th, t):
    return (torch.tanh(th["W"] @ u + th["b"]) - 0.2 * u
            + 4.0 * torch.exp(-((t - 1.0) / 0.05) ** 2) * torch.tanh(u))


def _pulse_inputs(device):
    rs = np.random.RandomState(3)
    u0 = torch.tensor(rs.randn(6), device=device, requires_grad=True)
    th = {"W": torch.tensor(0.6 * rs.randn(6, 6), device=device,
                            requires_grad=True),
          "b": torch.tensor(0.1 * rs.randn(6), device=device,
                            requires_grad=True)}
    return u0, th


@pytest.mark.parametrize("capture", [False, True])
def test_adaptive_card_against_the_cpu_fp64(cuda, capture):
    """The card's solve (fused, h0 large so it rejects) against the port
    on the CPU: the same accepted/rejected counts, u_final and gradients
    at the port-vs-JAX tolerance (rtol 1e-10 / atol 1e-12)."""
    out = {}
    for dev in (cuda, torch.device("cpu")):
        u0, th = _pulse_inputs(dev)
        solver = tad.AdaptiveSolver(_pulse_f, t0=0.0, t1=2.0, rtol=1e-7,
                                    atol=1e-7, h0=0.5, fused_stages=True,
                                    capture=capture and dev.type == "cuda")
        uf, info = solver(u0, th)
        g = torch.autograd.grad((uf ** 2).sum(), [u0, th["W"], th["b"]])
        out[dev.type] = (info, [uf.detach().cpu()] + [x.cpu() for x in g])
    assert out["cuda"][0] == out["cpu"][0] and out["cpu"][0].n_rejected > 0
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("method", ["beuler", "cn"])
def test_implicit_policies_bitwise_on_the_card_and_close_to_the_cpu(cuda,
                                                                    method):
    def f(u, th, t):
        return torch.tanh(th["W"] @ u + th["b"]) - 0.5 * u

    def grads(dev, policy, ncheck):
        rs = np.random.RandomState(1)
        u0 = torch.tensor(rs.randn(5), device=dev, requires_grad=True)
        th = {"W": torch.tensor(0.5 * rs.randn(5, 5), device=dev,
                                requires_grad=True),
              "b": torch.tensor(0.1 * rs.randn(5), device=dev,
                                requires_grad=True)}
        uf, st = timp.odeint_implicit(f, u0, th, dt=0.2, n_steps=5,
                                      method=method, adjoint=policy,
                                      ncheck=ncheck, return_stats=True)
        g = torch.autograd.grad((uf ** 2).sum(), [u0, th["W"], th["b"]])
        return st, [uf.detach()] + list(g)

    st, anchor = grads(cuda, "pnode", None)
    assert anchor[0].device.type == "cuda" and not st.diverged
    for policy, ncheck in (("revolve", 2), ("revolve2", 2)):
        st_p, out = grads(cuda, policy, ncheck)
        assert st_p == st
        assert _same_bits(out, anchor), policy
    st_cpu, cpu = grads(torch.device("cpu"), "pnode", None)
    assert st_cpu.newton_iters == st.newton_iters
    for a, b in zip(anchor, cpu):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-8,
                                   atol=1e-10)


K_BASE = (0.04, 3.0e7, 1.0e4)


def _rob_lanes(u, c, t):
    """Robertson kinetics with per-lane log-multipliers c on the rates."""
    k1, k2, k3 = (b * torch.exp(c[:, i]) for i, b in enumerate(K_BASE))
    du1 = -k1 * u[:, 0] + k3 * u[:, 1] * u[:, 2]
    du3 = k2 * u[:, 1] ** 2
    return torch.stack([du1, -du1 - du3, du3], dim=-1)


def _tanh_field(u, th, t):
    return torch.tanh(th["W"] @ u + th["b"]) - 0.5 * u


def _implicit_grads(solver, dev, lanes):
    """(u_final, gradients, stats) of ``solver`` on seeded fp64 inputs: 6
    ensemble lanes with per-lane c, or the d = 5 tanh field."""
    rs = np.random.RandomState(3)
    if lanes:
        u0 = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64,
                          device=dev).repeat(6, 1).requires_grad_(True)
        args = [u0, torch.tensor(0.2 * rs.randn(6, 3), device=dev,
                                 requires_grad=True)]
        uf, st = solver(*args)
        leaves = args
    else:
        u0 = torch.tensor(rs.randn(5), device=dev, requires_grad=True)
        th = {"W": torch.tensor(0.5 * rs.randn(5, 5), device=dev,
                                requires_grad=True),
              "b": torch.tensor(0.1 * rs.randn(5), device=dev,
                                requires_grad=True)}
        uf, st = solver(u0, th)
        leaves = [u0, th["W"], th["b"]]
    g = torch.autograd.grad((uf ** 2).sum(), leaves)
    return [uf.detach()] + list(g), st


def _implicit_solver(lanes, capture, n_steps=1, **kw):
    if lanes:
        return timp.ImplicitSolver(_rob_lanes, dt=0.01, n_steps=n_steps,
                                   lanes=True, capture=capture,
                                   newton_iters=16, newton_tol=1e-10,
                                   gmres_iters=5, gmres_tol=1e-12, **kw)
    return timp.ImplicitSolver(_tanh_field, dt=0.2, n_steps=n_steps,
                               capture=capture, **kw)


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("method", ["beuler", "cn"])
def test_implicit_step_and_adjoint_step_captured_bitwise_eager(cuda, lanes,
                                                               method):
    """One implicit step and its adjoint step, replayed from the captured
    units, bitwise equal to eager (the eager route without lanes, the
    masked units run eagerly with them), with equal stats."""
    eager, st_e = _implicit_grads(_implicit_solver(lanes, False,
                                                   method=method),
                                  cuda, lanes)
    solver = _implicit_solver(lanes, True, method=method)
    for _ in range(2):   # the capturing call, then pure replays
        cap, st_c = _implicit_grads(solver, cuda, lanes)
        assert _same_bits(cap, eager)
        if lanes:
            assert all(torch.equal(a, b) for a, b in zip(st_c, st_e))
            assert not bool(st_c.diverged.any())
        else:
            assert st_c == st_e and not st_c.diverged
    assert set(solver.graph_stats()) == {"start", "unit", "adj_start",
                                         "adj_unit", "adj_finish"}
    assert all(v[2] is not None for v in solver.graph_stats().values())


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("policy,ncheck", [("pnode", None), ("revolve", 2),
                                           ("revolve2", 2)])
def test_implicit_capture_reads_only_the_live_flag(cuda, lanes, policy,
                                                   ncheck):
    """A captured solve reads nothing on the host but the ``live`` flag,
    once every ``CHECK_EVERY`` replays, and (without lanes) the stats
    once; its gradient is bitwise the eager one under every policy."""
    kw = dict(n_steps=5, adjoint=policy, ncheck=ncheck)
    eager, _ = _implicit_grads(_implicit_solver(lanes, False, **kw), cuda,
                               lanes)
    solver = _implicit_solver(lanes, True, **kw)
    _implicit_grads(solver, cuda, lanes)
    r0, l0, s0 = solver.replays, solver.live_reads, solver.stats_reads
    cap, _ = _implicit_grads(solver, cuda, lanes)
    replays, reads = solver.replays - r0, solver.live_reads - l0
    assert replays > 0 and reads == -(-replays // tad.CHECK_EVERY)
    assert solver.stats_reads - s0 == (0 if lanes else 1)
    assert _same_bits(cap, eager)


def test_robertson_cn_loss_captured_bitwise_eager(cuda):
    """The example's 19-solve CN loss (one captured ``ImplicitSolver`` an
    interval) and its Dopri5 loss: value and gradient bitwise eager."""
    from torch.utils import _pytree as pytree
    from repro_torch.examples import stiff_robertson as trob
    rs = np.random.RandomState(0)
    y0, target = trob.scaled_data(rs.rand(20, 3), cuda)
    theta = trob.mlp_vf_init(torch.Generator().manual_seed(0), 3, hidden=32,
                             n_hidden=3, device=cuda)
    out = {}
    for capture in (False, True):
        losses = trob.make_losses(y0, target, capture=capture)
        for name in ("cn", "dopri"):
            loss, g = trob.value_and_grad(getattr(losses, name), theta)
            out[capture, name] = [loss] + pytree.tree_leaves(g)
    for name in ("cn", "dopri"):
        assert _same_bits(out[True, name], out[False, name]), name


def test_implicit_reverse_over_overwritten_buffers_raises(cuda):
    """A captured solver's buffers hold its last call: the reverse sweep
    of an earlier call raises; the latest call's still runs."""
    solver = _implicit_solver(False, True, n_steps=2)
    rs = np.random.RandomState(4)
    th = {"W": torch.tensor(0.5 * rs.randn(5, 5), device=cuda),
          "b": torch.tensor(0.1 * rs.randn(5), device=cuda)}
    u1 = torch.tensor(rs.randn(5), device=cuda, requires_grad=True)
    u2 = torch.tensor(rs.randn(5), device=cuda, requires_grad=True)
    uf1, _ = solver(u1, th)
    uf2, _ = solver(u2, th)
    with pytest.raises(RuntimeError, match="later forward pass"):
        torch.autograd.grad(uf1.sum(), [u1])
    g2, = torch.autograd.grad(uf2.sum(), [u2])
    assert bool(torch.isfinite(g2).all())


# ---------------------------------------------------------------------------
# the offload tiers (repro_torch.mem.offload): copies on the copy stream
# ---------------------------------------------------------------------------

OFFLOAD_GPU_CASES = [
    ("pnode", None, dict(offload="spill")),
    ("pnode", None, dict(offload="disk")),
    ("pnode", None, dict(offload="spill", snaps_in_ram=2)),
    ("pnode", None, dict(offload="spill", offload_segment=3)),
    ("revolve", 3, dict(offload="host")),
    ("revolve", 3, dict(offload="spill")),
    ("revolve2", 3, dict(offload="host")),
    ("revolve2", 3, dict(offload="disk")),
]


def _kept_stores(monkeypatch):
    from repro_torch.mem import offload
    stores, make = [], offload.make_store

    def keep(*a, **k):
        stores.append(make(*a, **k))
        return stores[-1]

    monkeypatch.setattr(offload, "make_store", keep)
    return stores


@pytest.mark.parametrize(
    "policy,ncheck,kw", OFFLOAD_GPU_CASES,
    ids=[f"{p}-" + "-".join(f"{k}={v}" for k, v in kw.items())
         for p, _, kw in OFFLOAD_GPU_CASES])
def test_offload_tiers_bitwise_the_device_tier_on_the_card(
        cuda, policy, ncheck, kw, monkeypatch, tmp_path):
    """Every tier's fused gradient equals the device tier's bitwise on the
    card, with the device tier's launches, and its store copied both ways
    on the card (no silent fallback to the device)."""
    f, u0, th = _planner_case(cuda)
    if kw.get("offload") == "disk":
        kw = dict(kw, offload_dir=str(tmp_path))

    def grads(**k):
        a = u0.detach().requires_grad_(True)
        b = {n: v.detach().requires_grad_(True) for n, v in th.items()}
        uf = tadj.odeint(f, a, b, dt=0.05, n_steps=10, method="rk4",
                         adjoint=policy, ncheck=ncheck, fused_stages=True,
                         **k)
        return list(torch.autograd.grad((uf ** 2).sum(), [a, b["W"],
                                                          b["b"]]))

    stores = _kept_stores(monkeypatch)
    ops.reset_counts()
    got = grads(**kw)
    torch.cuda.synchronize()
    assert ops.plain_calls == 0 and ops.launches == \
        tadj.expected_lincomb_calls("rk4", 10, 1, policy, ncheck)
    assert [st.effective_tier for st in stores] == [kw["offload"]]
    assert stores[0].copies["d2h"] > 0 and stores[0].copies["h2d"] > 0
    assert _same_bits(got, grads())


def test_offload_spill_peak_is_below_the_device_tiers(cuda):
    """pnode at N_t = 16: the spill tier's allocator peak holds two
    segments (staging and a prefetched one) where the device tier holds
    all 16 steps' checkpoints; the host copies are not CUDA storage."""
    from repro_torch.mem import model as tmodel
    f, u0, th = _planner_case(cuda)
    kw = dict(dt=0.05, n_steps=16, method="rk4", policy="pnode",
              fused_stages=True)
    device = tmodel.measure_reverse_cost(f, u0, th, **kw)["peak_bytes"]
    slot = 5 * tmodel.tree_bytes(u0)
    for tier in ("spill", "disk"):
        peak = tmodel.measure_reverse_cost(f, u0, th, offload=tier,
                                           **kw)["peak_bytes"]
        assert peak < device - 8 * slot, (tier, peak, device)


def test_planner_spill_fallback_runs_on_the_card(cuda):
    """A budget under every in-device candidate plans pnode + spill,
    measured on the allocator, and the auto gradient is pnode's bitwise."""
    from repro_torch.mem import model as tmodel
    from repro_torch.mem.planner import plan_odeint
    f, u0, th = _planner_case(cuda)
    kw = dict(dt=0.05, n_steps=8, method="rk4")
    plan = plan_odeint(f, u0, th, mem_budget=1, fused_stages=True, **kw)
    assert (plan.policy, plan.offload) == ("pnode", "spill")
    assert plan.measured_bytes == tmodel.measure_reverse_cost(
        f, u0, th, policy="pnode", offload="spill", fused_stages=True,
        **kw)["peak_bytes"]
    auto = tmodel.reverse_pass(f, u0, th, policy="auto", mem_budget=1,
                               fused_stages=True, **kw)
    pnode = tmodel.reverse_pass(f, u0, th, policy="pnode",
                                fused_stages=True, **kw)
    assert _same_bits(auto(), pnode())


@pytest.mark.parametrize("capture", [False, True],
                         ids=["eager", "captured"])
def test_adaptive_ring_spill_bitwise_the_device_ring(cuda, capture):
    """The ring of segment + CHECK_EVERY slots, shipped at the host's live
    reads (outside the captured attempts), gives the device ring's
    gradient bitwise, eager and captured."""
    rs = np.random.RandomState(3)
    u0 = torch.tensor(rs.randn(512, 6), device=cuda)
    th = {"W": torch.tensor(0.6 * rs.randn(6, 6), device=cuda),
          "b": torch.tensor(0.1 * rs.randn(6), device=cuda)}

    def f(u, p, t):
        return (torch.tanh(u @ p["W"] + p["b"]) - 0.2 * u
                + 4.0 * torch.exp(-((t - 1.0) / 0.05) ** 2) * torch.tanh(u))

    def run(**kw):
        solver = tad.AdaptiveSolver(f, t0=0.0, t1=2.0, rtol=1e-7,
                                    atol=1e-7, max_steps=64,
                                    fused_stages=True, capture=capture,
                                    **kw)
        a = u0.detach().requires_grad_(True)
        b = {n: v.detach().requires_grad_(True) for n, v in th.items()}
        uf, info = solver(a, b)
        g = torch.autograd.grad((uf ** 2).sum(), [a, b["W"], b["b"]])
        return [uf.detach(), *g], info, solver

    dev, info, _ = run()
    for kw in (dict(offload="spill"), dict(offload="disk"),
               dict(offload="spill", offload_segment=3)):
        got, info_s, solver = run(**kw)
        assert info_s == info and _same_bits(got, dev), kw
        assert solver.ring_slots == solver.segment + tad.CHECK_EVERY
        assert info.n_accepted > solver.segment  # several segments


def test_implicit_eager_route_tiers_bitwise_on_the_card(cuda, monkeypatch):
    """The eager implicit route: pnode on spill and disk (and resilient,
    with a byte flipped at rest recomputed), revolve on host and spill,
    each the device tier's gradient bitwise."""
    from repro_torch.mem import offload

    def f(u, th, t):
        return torch.tanh(th["W"] @ u + th["b"]) - 0.5 * u

    rs = np.random.RandomState(1)
    u0 = torch.tensor(rs.randn(5), device=cuda)
    th = {"W": torch.tensor(0.5 * rs.randn(5, 5), device=cuda),
          "b": torch.tensor(0.1 * rs.randn(5), device=cuda)}
    stores = _kept_stores(monkeypatch)

    def grads(corrupt=False, **kw):
        a = u0.detach().requires_grad_(True)
        b = {n: v.detach().requires_grad_(True) for n, v in th.items()}
        uf = timp.odeint_implicit(f, a, b, dt=0.2, n_steps=7, method="cn",
                                  **kw)
        if corrupt:
            stores[-1].sync()
            stores[-1]._host[4][0][0] ^= 0xFF
        return [uf.detach(), *torch.autograd.grad((uf ** 2).sum(),
                                                  [a, b["W"], b["b"]])]

    ref = grads()
    for kw in (dict(offload="spill"), dict(offload="disk"),
               dict(offload="spill", resilient=True)):
        assert _same_bits(grads(**kw), ref), kw
    offload.reset_spill_stats()
    assert _same_bits(grads(corrupt=True, offload="spill", resilient=True),
                      ref)
    assert stores[-1].stats["integrity_fail"] >= 1
    rev = grads(adjoint="revolve", ncheck=2)
    for tier in ("host", "spill"):
        assert _same_bits(grads(adjoint="revolve", ncheck=2, offload=tier),
                          rev), tier
        assert stores[-1].effective_tier == tier


def test_step_graph_holds_the_collector_off_during_a_capture(cuda):
    """The cyclic garbage collector is off while a step is captured (a
    collection there may destroy an unreachable graph, which invalidates
    the capture) and back as it was after; the warm-up runs with it."""
    import gc
    seen = []
    step = StepGraph(lambda h, c: (seen.append(gc.isenabled()), h * c)[1],
                     clone_outputs=True)
    a = torch.arange(4.0, device=cuda)
    assert gc.isenabled()
    assert torch.equal(step(a, torch.full((4,), 2.0, device=cuda)), 2 * a)
    assert seen == [True, False] and gc.isenabled()
    gc.disable()
    try:
        StepGraph(lambda h, c: h * c, clone_outputs=True)(a, a)
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_step_graph_refuses_on_the_card(cuda):
    """Last in the file: a failed capture may leave its side stream's
    allocator state behind."""
    a = torch.arange(4.0, device=cuda)
    graph = StepGraph(lambda h, c: h * c, clone_outputs=True)
    assert torch.equal(graph(a, torch.ones(4, device=cuda)), a)
    assert torch.equal(graph(a, torch.full((4,), 2.0, device=cuda)), 2 * a)
    with pytest.raises(ValueError, match="not the tensor captured"):
        graph(a.clone(), torch.ones(4, device=cuda))
    with pytest.raises(ValueError, match="copied leaf 0"):
        graph(a, torch.ones(4, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="copied leaf 0"):
        graph(a, torch.ones(4))
    # a host read of a device value cannot be captured: no eager fallback
    bad = StepGraph(lambda h, c: h * float(c.sum()), clone_outputs=True)
    with pytest.raises(RuntimeError):
        bad(a, torch.ones(4, device=cuda))
    assert bad.graph is None


# ---------------------------------------------------------------------------
# the flight recorder, device counters and checkpoint snapshots on the card
# ---------------------------------------------------------------------------

def test_adaptive_attempt_log_captured_equals_eager(cuda):
    """The attempt log written inside the captured attempt (no host read)
    gives the eager solver's events and gradient bitwise, with a fault
    gated on the device attempt counter."""
    from repro_torch.ft import FaultPlan, FaultSpec
    from repro_torch.obs import FlightRecorder
    rs = np.random.RandomState(3)
    u0 = torch.tensor(rs.randn(64, 6), device=cuda)
    W = torch.tensor(0.6 * rs.randn(6, 6), device=cuda)

    def f(u, w, t):
        return torch.tanh(u @ w) - 0.2 * u

    outs = []
    for capture in (False, True):
        rec = FlightRecorder()
        solver = tad.AdaptiveSolver(
            f, t0=0.0, t1=1.0, max_steps=64, fused_stages=True,
            capture=capture, obs=rec,
            fault_plan=FaultPlan([FaultSpec("adaptive", 2, "nan", 2)]))
        a, w = u0.clone().requires_grad_(True), W.clone().requires_grad_(True)
        uf, info = solver(a, w)
        g = torch.autograd.grad((uf ** 2).sum(), [a, w])
        steps = rec.adaptive_steps()
        outs.append(([uf.detach(), *g], info, steps))
    (ga, ia, sa), (gb, ib, sb) = outs
    assert ia == ib and ib.n_rejected >= 2 and _same_bits(ga, gb)
    assert [(d["attempt"], d["accept"]) for d in sa] == \
        [(d["attempt"], d["accept"]) for d in sb]
    for key in ("t", "h", "err_norm"):
        np.testing.assert_array_equal([d[key] for d in sa],
                                      [d[key] for d in sb])


def test_jit_counter_counts_every_replay(cuda):
    from repro_torch.obs import JitCounter
    counter = JitCounter("taps")
    x = torch.zeros(4, device=cuda)
    graph = StepGraph(lambda held, copied: (counter.tap(held[0]) + 1,),
                      clone_outputs=True)
    for _ in range(5):
        graph((x,), ())
    # the warm-up, then the replays (the capture itself runs no kernel)
    assert counter.count == 1 + 5
    counter.reset()
    graph((x,), ())
    assert counter.count == 1


def test_checkpoint_snapshot_survives_the_sources_going(cuda, tmp_path):
    """``CheckpointManager.save`` copies on a copy stream it does not wait
    for; the sources are dropped and their memory reused at once, and the
    committed bytes are still the saved values."""
    from repro_torch.ckpt import CheckpointManager
    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn(1 << 22, generator=gen, device=cuda),
            "step": 3}
    want = tree["w"].cpu()
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tree)
    del tree
    junk = [torch.full((1 << 22,), 7.0, device=cuda) for _ in range(4)]
    got, step = mgr.restore_latest({"w": torch.zeros(1 << 22, device=cuda),
                                    "step": 0})
    assert step == 1 and got["step"] == 3 and got["w"].is_cuda
    assert torch.equal(got["w"].cpu(), want) and junk


# ---------------------------------------------------------------------------
# LM training: the RWKV6 backward kernel, the depth remat policies, a step
# ---------------------------------------------------------------------------

def _bwd_inputs(b, s, h, dh, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    r, k, v, logw, u = rwkv6_inputs(b, h, s, dh, gen, layout="bshd")
    dy = torch.randn(r.shape, generator=gen)
    return [t.to(device) for t in (r.to(dtype), k.to(dtype), v.to(dtype),
                                   logw, u, dy)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,dh,chunk", [(2, 300, 4, 16, 64),
                                            (1, 70, 3, 16, 16),
                                            (1, 130, 2, 32, 32),
                                            (2, 257, 2, 64, 64),
                                            (1, 64, 2, 64, 64),
                                            (1, 70, 3, 32, 16)])
def test_rwkv6_backward_kernel_vs_plain_vjp(cuda, dtype, b, s, h, dh, chunk):
    from repro_torch.kernels.ref import rwkv6_plain_vjp
    from repro_torch.kernels.rwkv6_cases import (RWKV6_BWD_WRONG,
                                                 rwkv6_bwd_ratio,
                                                 rwkv6_vjp_chunked)
    a = _bwd_inputs(b, s, h, dh, dtype, cuda)
    before = ops.rwkv6_bwd_launches
    got = ops.rwkv6_chunked_bwd_fp32(*a, chunk=chunk)
    again = ops.rwkv6_chunked_bwd_fp32(*a, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.rwkv6_bwd_launches == before + 2
    assert all(torch.equal(_bits(x), _bits(y)) for x, y in zip(got, again))
    assert [g.dtype for g in got] == [t.dtype for t in a[:5]]
    torch.use_deterministic_algorithms(False)  # rwkv6_plain's cumsum
    plain = rwkv6_plain_vjp(*a, chunk=chunk)
    assert rwkv6_bwd_ratio(got, plain) <= 1
    for w in RWKV6_BWD_WRONG:
        if s <= chunk and w == "the later chunks' state gradient dropped":
            continue  # one chunk carries no state gradient: not wrong there
        wrong = rwkv6_vjp_chunked(*a, chunk=chunk, wrong=w)
        assert rwkv6_bwd_ratio(wrong, plain) > 10, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_backward_kernel_on_unaligned_views(cuda, dtype):
    """r/k/v one element off a 16-byte boundary and dy with rows of dh + 1
    (both copied before the kernels' cp.async), logw an aligned strided
    view of a wider buffer (passed in place with its strides)."""
    from repro_torch.kernels.ref import rwkv6_plain_vjp
    from repro_torch.kernels.rwkv6_cases import rwkv6_bwd_ratio
    b, s, h, dh, chunk = 2, 130, 3, 32, 32
    r, k, v, logw, u, dy = _bwd_inputs(b, s, h, dh, dtype, cuda)

    def off_by_one(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    wide = torch.zeros(b, s, 2 * h, dh, device=cuda)
    wide[:, :, h:] = logw
    rows = torch.zeros(b, s, h, dh + 1, device=cuda)
    rows[..., :dh] = dy
    views = (off_by_one(r), off_by_one(k), off_by_one(v), wide[:, :, h:], u,
             rows[..., :dh])
    assert views[0].data_ptr() % ops.CP_ASYNC_ALIGN != 0
    assert not views[3].is_contiguous() and not views[5].is_contiguous()
    before = ops.rwkv6_bwd_launches
    got = ops.rwkv6_chunked_bwd_fp32(*views, chunk=chunk)
    want = ops.rwkv6_chunked_bwd_fp32(r, k, v, logw, u, dy, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.rwkv6_bwd_launches == before + 2
    assert all(torch.equal(_bits(x), _bits(y)) for x, y in zip(got, want))
    torch.use_deterministic_algorithms(False)  # rwkv6_plain's cumsum
    plain = rwkv6_plain_vjp(r, k, v, logw, u, dy, chunk=chunk)
    assert rwkv6_bwd_ratio(got, plain) <= 1


def test_rwkv6_backward_kernel_refuses(cuda):
    a = _bwd_inputs(1, 64, 2, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.rwkv6_chunked_bwd_fp32(*a, chunk=48)
    with pytest.raises(ValueError, match="dy"):
        ops.rwkv6_chunked_bwd_fp32(*a[:5], a[5].double(), chunk=64)


def _train_case(arch, impl, s, device):
    cfg = reduced(get_arch(arch), n_layers=2, attn_impl=impl)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, s)).astype(np.int32))
    return cfg, params, {"tokens": toks, "targets": toks}


@pytest.mark.parametrize("arch,impl,s", [("tinyllama-1.1b", "chunked", 600),
                                         ("rwkv6-7b", "naive", 300),
                                         ("mixtral-8x7b", "chunked", 300)])
def test_remat_policies_bitwise_on_the_card(cuda, arch, impl, s):
    from torch.utils import _pytree as pytree
    from repro_torch.launch.steps import value_and_grad
    cfg, params, batch = _train_case(arch, impl, s, cuda)
    params = pytree.tree_map(lambda t: t.to(cuda), params)
    batch = {k: v.to(cuda) for k, v in batch.items()}
    runs = []
    for remat, ncheck in (("none", None), ("full", None), ("sqrt", None),
                          ("revolve", 1)):
        loss, _, g = value_and_grad(
            dataclasses.replace(cfg, remat=remat, ncheck=ncheck), params,
            batch)
        runs.append([loss] + pytree.tree_leaves(g))
    for leaves in runs[1:]:
        assert all(torch.equal(_bits(x), _bits(y))
                   for x, y in zip(leaves, runs[0]))


def test_train_step_on_the_card_matches_the_cpu(cuda):
    from torch.utils import _pytree as pytree
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamW
    cfg, params, batch = _train_case("rwkv6-7b", "naive", 300, cuda)
    opt = AdamW(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt)
    _, s_cpu, m_cpu = step(params, opt.init(params), batch, 0)
    card_p = pytree.tree_map(lambda t: t.to(cuda), params)
    ops.reset_counts()
    _, s_card, m_card = step(card_p, opt.init(card_p),
                             {k: v.to(cuda) for k, v in batch.items()}, 0)
    torch.cuda.synchronize()
    assert (ops.rwkv6_launches, ops.rwkv6_bwd_launches) == \
        lm.expected_rwkv6_train_calls(cfg, 300, cfg.remat)
    assert (ops.rwkv6_plain_calls, ops.rwkv6_bwd_plain_calls) == (0, 0)
    for k in ("loss", "grad_norm"):
        assert abs(float(m_card[k]) - float(m_cpu[k])) <= \
            1e-4 * abs(float(m_cpu[k]))
    for a, c in zip(pytree.tree_leaves(s_card.m), pytree.tree_leaves(s_cpu.m)):
        assert float((a.cpu() - c).abs().max()) <= \
            1e-3 * float(c.abs().max())


# ---------------------------------------------------------------------------
# MoE (nn/moe.py) and gradient compression (optim/compress.py)
# ---------------------------------------------------------------------------

def _moe_inputs(device, e=4, k=2, b=2, s=64, d=64, f=128):
    from repro_torch.nn import moe
    p = moe.init_moe(torch.Generator().manual_seed(0), d, f, e)
    x = torch.from_numpy(np.random.RandomState(1).randn(b, s, d)
                         .astype(np.float32))
    return p, x


@pytest.mark.parametrize("dispatch", ["slots", "sorted"])
@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_moe_block_card_against_cpu_on_equal_routing(cuda, cf, dispatch):
    """Reduced Mixtral's block (d 64, d_ff 128, 4 experts, top 2), fp32,
    TF32 off: the card routes as the CPU does (indices and kept mask
    equal), and the output and aux loss agree within 1e-5 of max|out|."""
    from torch.utils import _pytree as pytree
    from repro_torch.nn import moe
    p, x = _moe_inputs("cpu")
    kw = dict(n_experts=4, top_k=2, capacity_factor=cf, group_size=32,
              dispatch=dispatch)
    pc = pytree.tree_map(lambda t: t.to(cuda), p)
    rc = moe.route(pc["w_router"], x.to(cuda).reshape(-1, 64), n_experts=4,
                   top_k=2, capacity_factor=cf, group_size=32)
    r = moe.route(p["w_router"], x.reshape(-1, 64), n_experts=4, top_k=2,
                  capacity_factor=cf, group_size=32)
    assert torch.equal(rc.idx.cpu(), r.idx)
    assert torch.equal(rc.keep.cpu(), r.keep)
    with torch.no_grad():
        out, aux = moe.moe_block(p, x, **kw)
        outc, auxc = moe.moe_block(pc, x.to(cuda), **kw)
    assert float((outc.cpu() - out).abs().max()) <= \
        1e-5 * float(out.abs().max())
    assert abs(float(auxc) - float(aux)) <= 1e-5 * abs(float(aux))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_backward_is_the_same_bits_twice_on_the_card(cuda, dtype):
    from repro_torch.nn import moe
    p, x = _moe_inputs("cpu")
    p = {n: v.to(cuda, dtype if n != "w_router" else torch.float32)
         for n, v in p.items()}
    x = x.to(cuda, dtype)
    dy = torch.randn(x.shape, generator=torch.Generator(cuda).manual_seed(2),
                     device=cuda).to(dtype)
    runs = []
    for _ in range(2):
        leaves = {n: v.detach().requires_grad_(True) for n, v in p.items()}
        xx = x.detach().requires_grad_(True)
        out, aux = moe.moe_block(leaves, xx, n_experts=4, top_k=2,
                                 capacity_factor=1.25, group_size=32)
        runs.append(torch.autograd.grad(
            (out.float() * dy.float()).sum() + aux,
            [leaves[n] for n in sorted(leaves)] + [xx]))
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(*runs))


def test_int8_compress_on_the_card_is_the_cpus_bitwise(cuda):
    """max, IEEE division and round half to even are exact on both: the
    quantized gradients, scales, residuals and dequantized gradients are
    the CPU's bits, with values at exact half steps and a zero leaf."""
    from torch.utils import _pytree as pytree
    from repro_torch.optim import compress as tc
    rs = np.random.RandomState(0)
    half = torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, -126.5])
    g = {"a": torch.from_numpy(rs.randn(4096, 33).astype(np.float32)),
         "half": half, "zero": torch.zeros(5),
         "b": torch.from_numpy((rs.randn(1000) * 1e-3).astype(np.float32))}
    r = pytree.tree_map(lambda t: 0.3 * torch.randn_like(t), g)
    to = lambda tree: pytree.tree_map(lambda t: t.to(cuda), tree)  # noqa
    q, res = tc.int8_compress(g, r)
    qc, resc = tc.int8_compress(to(g), to(r))
    flat = lambda t: pytree.tree_leaves(t)  # noqa: E731
    for a, b in zip(flat((q, res, tc.int8_decompress(q))),
                    flat((qc, resc, tc.int8_decompress(qc)))):
        assert a.dtype == b.dtype
        assert torch.equal(a, b.cpu()) if a.dtype == torch.int8 \
            else torch.equal(_bits(a), _bits(b.cpu()))
    for a, b in zip(flat(tc.bf16_decompress(tc.bf16_compress(g))),
                    flat(tc.bf16_decompress(tc.bf16_compress(to(g))))):
        assert torch.equal(_bits(a), _bits(b.cpu()))


@pytest.mark.parametrize("peak", [3.0031628608703613, 2.3511321544647217,
                                  0.8049525618553162, 3.925164222717285])
def test_int8_scale_is_a_division_on_the_card(cuda, peak):
    """At these maxima ``max * float32(1/127)`` rounds one ulp away from
    ``max / 127`` (the reference's scale), so a scale taken through the
    reciprocal would change every quantized value's scale and the
    residual; the card's scale, codes and residual are the CPU's bits."""
    from repro_torch.optim import compress as tc
    g = torch.tensor([peak, -0.5 * peak, 0.25, 0.0], dtype=torch.float32)
    m = torch.tensor(peak, dtype=torch.float32)
    assert m / 127.0 != m * (torch.tensor(1.0) / 127.0)
    q, s = tc.int8_quantize(g)
    qc, sc = tc.int8_quantize(g.to(cuda))
    assert torch.equal(_bits(s), _bits(sc.cpu()))
    assert torch.equal(q, qc.cpu())
    (_, r), (_, rc) = (tc.int8_compress([g], [torch.zeros(4)]),
                       tc.int8_compress([g.to(cuda)],
                                        [torch.zeros(4, device=cuda)]))
    assert torch.equal(_bits(r[0]), _bits(rc[0].cpu()))


# ---------------------------------------------------------------------------
# RecurrentGemma (RG-LRU) and the donated train step
# ---------------------------------------------------------------------------

def test_flash_at_recurrentgemmas_shape_on_the_card(cuda):
    """The bf16 kernel at RecurrentGemma-9B's prefill shape (8, 16, 1,
    4096, 256), causal, window 2048, against ``attention_plain``: within
    the derived limit at diffuse and sharp scores; the wrong answers
    beyond it (10x but for scores rounded before the max, whose margin
    the limit's reorder term at dh 256 keeps under 10x)."""
    from repro_torch.kernels import flash_cases as fc
    from repro_torch.kernels.ops import flash_attention_bhsd
    rng = np.random.RandomState(31)
    b, h, hkv, s, dh = fc.FLASH_RECURRENTGEMMA
    mask = dict(causal=True, window=fc.FLASH_RECURRENTGEMMA_WINDOW)
    margins = dict.fromkeys(fc.WRONG_ANSWERS, 0.0)
    for sharp in FLASH_SHARPNESS:
        q, k, v = flash_inputs(b, h, hkv, s, s, dh, rng, device=cuda,
                               dtype=torch.bfloat16, sharpness=sharp)
        out = flash_attention_bhsd(q, k, v, **mask)
        plain = attention_plain(q, k, v, **mask)
        assert bf16_ratio(out, q, k, v, plain=plain, **mask) <= 1
        for name, wrong in fc.WRONG_ANSWERS.items():
            margins[name] = max(margins[name], bf16_ratio(
                wrong(q, k, v, **mask), q, k, v, plain=plain, **mask))
        del q, k, v, out, plain
    for name, m in margins.items():
        assert m > (1.0 if name == "scores rounded before the row max"
                    else fc.WRONG_MARGIN), (name, m)


@pytest.mark.parametrize("s", [1, 3, 64, 4096])
def test_rglru_doubling_scan_on_the_card(cuda, s):
    """The doubling scan against a sequential fp64 recurrence, and BITWISE
    from run to run (each pass reads only the previous pass's tensors)."""
    gen = torch.Generator().manual_seed(s)
    a = torch.rand(2, s, 256, generator=gen, dtype=torch.float64) * 0.5 \
        + 0.5
    b = torch.randn(2, s, 256, generator=gen, dtype=torch.float64)
    ref, h = torch.empty_like(b), torch.zeros(2, 256, dtype=torch.float64)
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        ref[:, t] = h
    ac, bc = a.float().to(cuda), b.float().to(cuda)
    out = ssm.linear_scan(ac, bc)
    assert float((out.double().cpu() - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max())
    assert torch.equal(_bits(out), _bits(ssm.linear_scan(ac, bc)))


def test_update_in_place_on_the_card_is_update_bitwise(cuda):
    """``AdamW.update_`` on the card writes the params and moments in place
    with ``update``'s bits (no FMA contraction: every product and sum is
    its own operation), bf16 and fp32 params, the clip active."""
    from torch.utils import _pytree as pytree
    from repro_torch.optim.adamw import AdamW
    gen = torch.Generator(device=cuda).manual_seed(0)
    mk = lambda *sh, dt=torch.bfloat16: torch.randn(  # noqa: E731
        sh, generator=gen, device=cuda).to(dt)
    params = {"a": mk(1024, 257), "b": mk(33, dt=torch.float32),
              "c": [mk(4, 8, 16)]}
    opt = AdamW(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10,
                grad_dtype="bfloat16")
    ref_p, ref_s = params, opt.init(params)
    don_p = pytree.tree_map(torch.clone, params)
    don_s = opt.init(don_p)
    for i in range(3):
        grads = pytree.tree_map(lambda t: 30.0 * torch.randn(
            t.shape, generator=gen, device=cuda).to(t.dtype), params)
        ref_p, ref_s, ref_m = opt.update(grads, ref_s, ref_p)
        don_p, don_s, m = opt.update_(grads, don_s, don_p)
        for x, y in zip(pytree.tree_leaves((ref_p, ref_s.m, ref_s.v)),
                        pytree.tree_leaves((don_p, don_s.m, don_s.v))):
            assert torch.equal(_bits(x), _bits(y))
        assert torch.equal(m["grad_norm"], ref_m["grad_norm"])


def test_checkpoint_before_an_in_place_step_keeps_the_pre_step_bits(
        cuda, tmp_path):
    """``save`` queues the snapshot's copy on a copy stream and returns;
    an in-place write queued right after it on the compute stream waits
    for the copy, so the checkpoint holds the pre-step bits."""
    from repro_torch.ckpt import CheckpointManager
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn(1 << 24, generator=gen, device=cuda)
    want = w.cpu()
    mgr = CheckpointManager(tmp_path)
    torch.cuda._sleep(10_000_000)   # the compute stream is busy...
    mgr.save(1, {"w": w})
    for _ in range(8):              # ...and the step writes in place
        w.mul_(3.0).add_(1.0)
    got, _ = mgr.restore_latest({"w": torch.zeros_like(w)})
    assert torch.equal(got["w"].cpu(), want)
    assert not torch.equal(w.cpu(), want)


def test_donated_step_on_the_card_is_the_functional_step_bitwise(cuda):
    """Reduced RecurrentGemma (r, r, a, r), fp32: three donated steps
    with the sentinel on and the second poisoned, BITWISE the functional
    step's params and moments, and int8's residual."""
    from torch.utils import _pytree as pytree
    from repro_torch.launch.steps import init_compress_state, make_train_step
    from repro_torch.optim.adamw import AdamW
    cfg = reduced(get_arch("recurrentgemma-9b"), attn_impl="chunked")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device=cuda)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 48)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks, "targets": toks}
    opt = AdamW(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)
    for compress in (None, "int8"):
        fun = make_train_step(cfg, opt, compress=compress, sentinel=True)
        don = make_train_step(cfg, opt, compress=compress, sentinel=True,
                              donate=True)
        f = [params, opt.init(params)]
        d = [pytree.tree_map(torch.clone, params)]
        d.append(opt.init(d[0]))
        if compress:
            f.append(init_compress_state(compress, params))
            d.append(init_compress_state(compress, params))
        for i, poison in enumerate((False, True, False)):
            *f, _ = fun(*f, batch, i, poison)
            *d, _ = don(*d, batch, i, poison)
            assert f[1].step == d[1].step == (1 if i < 2 else 2)
            for x, y in zip(pytree.tree_leaves((f[0], f[1].m, f[1].v, f[2:])),
                            pytree.tree_leaves((d[0], d[1].m, d[1].v, d[2:]))):
                assert torch.equal(_bits(x), _bits(y))
