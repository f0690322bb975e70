"""The port's kernels on the card: ``fused_lincomb`` bitwise against its
plain version, and fused against unfused adjoint gradients bitwise on the
same card; ``flash_attention_bhsd`` against ``attention_plain`` (fp32
rtol = atol = 2e-5, as ``tests/test_kernels.py``; bf16 rtol 1e-2, atol
1e-3: both round an fp32 result to bf16 once, so they may differ by one
bf16 ulp and no more), its launch
count on an LM prefill, and the kernel's prefill against the naive one.
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
from repro_torch.core import adjoint as tadj
from repro_torch.core.depth_ode import ODEBlock
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_plain, lincomb_plain
from repro_torch.models import lm, ode_nets

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
    return x.contiguous().view(torch.int32 if x.dtype == torch.float32
                               else torch.int64)


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


# bf16: one ulp of the output is at most 2**-7 of it; an error the size of
# an output (about 0.05 at S = 1920) fails
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=1e-3)}
FLASH_SHAPES = [(1, 4, 4, 128, 128, 64), (2, 4, 2, 128, 128, 64),
                (1, 8, 1, 256, 256, 32), (1, 4, 4, 200, 200, 64),
                (1, 2, 2, 64, 64, 128), (1, 4, 4, 64, 192, 64)]
FLASH_SHAPES += [(2, 4, 2, 150, 150, dh) for dh in ops.FLASH_HEAD_DIMS]


def _qkv(shape, dtype, device, seed=0):
    b, h, hkv, sq, sk, dh = shape
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(b, h, sq, dh, generator=gen).to(device, dtype),
            torch.randn(b, hkv, sk, dh, generator=gen).to(device, dtype),
            torch.randn(b, hkv, sk, dh, generator=gen).to(device, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0), (False, 48)])
def test_flash_attention_vs_plain(cuda, dtype, shape, causal, window):
    q, k, v = _qkv(shape, dtype, cuda)
    before = ops.flash_launches
    out = ops.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_launches == before + 1
    ref = attention_plain(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), **FLASH_TOL[dtype])


def test_flash_attention_refuses_on_the_card(cuda):
    q, k, v = _qkv((1, 4, 2, 8, 8, 16), torch.float16, cuda)
    with pytest.raises(TypeError):
        ops.flash_attention_bhsd(q, k, v)
    q, k, v = _qkv((1, 4, 2, 8, 8, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="devices"):
        ops.flash_attention_bhsd(q, k.cpu(), v)


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
