"""The port's RG-LRU (recurrentgemma's recurrent block, ``nn/ssm.py``) and
its ``'r'`` layers (``nn/transformer.py``) against the JAX package, on the
CPU.  fp32 on both sides (the JAX side under ``jax.enable_x64(False)``),
inputs and weights from numpy seeds, the JAX package's weights carried
across by ``repro_torch.convert``.

Tolerance: ``LM_TOL`` (rtol = atol = 2e-5, fp32), the LM tests' own.  The
port's doubling scan sums in another order than ``associative_scan``, so
the two agree to fp32 rounding, not bitwise; the measured differences are
below 1e-6 of values of order one.  The doubling scan is held against a
sequential fp64 recurrence within 1e-5 of max|h| (fp32 rounding over
log2(S) passes) and bitwise against itself from run to run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_arch as j_get_arch
from repro.models import lm as jlm
from repro.nn import ssm as jssm
from repro.nn import transformer as jtf
from repro_torch import convert
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_arch
from repro_torch.kernels import ops
from repro_torch.models import lm as tlm
from repro_torch.nn import ssm
from repro_torch.nn import transformer as ttf

LM_TOL = dict(rtol=2e-5, atol=2e-5)
D_MODEL, D_RNN = 32, 48
ARCH = "recurrentgemma-9b"


@pytest.fixture(autouse=True)
def _f32():
    with jax.enable_x64(False):
        yield


def _close(j, t, tol=LM_TOL):
    np.testing.assert_allclose(np.asarray(t.detach().float()),
                               np.asarray(j, np.float32), **tol)


def _block_params(seed=0):
    jp = jssm.init_rglru_block(jax.random.PRNGKey(seed), D_MODEL, D_RNN)
    jp = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jp)
    return jp, convert.params_from_jax(jp, device="cpu")


def _randn(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the block's functions
# ---------------------------------------------------------------------------

def test_init_draws_the_jax_layout():
    jp, _ = _block_params()
    tp = ssm.init_rglru_block(torch.Generator().manual_seed(0), D_MODEL,
                              D_RNN)
    shapes = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (tuple(a.shape), str(a.dtype)), tree)
    assert shapes(convert.params_to_numpy(tp)) == shapes(jp)
    assert torch.equal(tp["lam"], torch.full((D_RNN,), 0.6))
    stacked = ssm.init_rglru_block(torch.Generator().manual_seed(0),
                                   D_MODEL, D_RNN, dtype=torch.bfloat16,
                                   lead=(3,))
    assert stacked["conv_w"].shape == (3, 4, D_RNN)
    assert stacked["w_a"].dtype == torch.bfloat16
    assert stacked["lam"].dtype == torch.float32  # fp32 whatever the dtype
    assert abs(float(tp["w_a"].std()) - 0.1 * D_RNN ** -0.5) < 0.005


@pytest.mark.parametrize("s", [1, 7, 64])
def test_causal_conv1d_matches_jax(s):
    x = _randn(2, s, D_RNN, seed=s)
    w = _randn(4, D_RNN, seed=100 + s, scale=0.3)
    j = jssm._causal_conv1d(jnp.asarray(x), jnp.asarray(w))
    t = ssm._causal_conv1d(torch.from_numpy(x), torch.from_numpy(w))
    _close(j, t)
    # the row at the last of a 4-row window: the same products, same order
    window = torch.from_numpy(np.concatenate(
        [np.zeros((2, 3, D_RNN), np.float32), x], 1)[:, -4:])
    assert torch.equal(ssm._conv_rows(window, torch.from_numpy(w), 1),
                       t[:, -1:])


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("s", [1, 7, 64])
def test_rglru_matches_jax(s, with_h0):
    jp, tp = _block_params()
    z = _randn(2, s, D_RNN, seed=s)
    h0 = _randn(2, D_RNN, seed=7) if with_h0 else None
    jy, jh = jssm.rglru(jp, jnp.asarray(z),
                        None if h0 is None else jnp.asarray(h0))
    ty, th = ssm.rglru(tp, torch.from_numpy(z),
                       None if h0 is None else torch.from_numpy(h0))
    assert ty.dtype == torch.float32 and th.shape == (2, D_RNN)
    _close(jy, ty)
    _close(jh, th)
    assert torch.equal(th, ty[:, -1])


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("s", [1, 7, 64])
def test_rglru_block_matches_jax(s, with_h0):
    jp, tp = _block_params(seed=1)
    x = _randn(2, s, D_MODEL, seed=s)
    h0 = _randn(2, D_RNN, seed=8) if with_h0 else None
    jy, jh = jssm.rglru_block(jp, jnp.asarray(x),
                              None if h0 is None else jnp.asarray(h0))
    ty, th = ssm.rglru_block(tp, torch.from_numpy(x),
                             None if h0 is None else torch.from_numpy(h0))
    assert ty.shape == (2, s, D_MODEL)
    _close(jy, ty)
    _close(jh, th)


@pytest.mark.parametrize("s", [1, 2, 5, 64, 300])
def test_linear_scan_is_the_recurrence_and_deterministic(s):
    rs = np.random.RandomState(s)
    a = rs.uniform(0.5, 1.0, (2, s, 8))
    b = rs.randn(2, s, 8)
    h, ref = np.zeros((2, 8)), np.empty_like(b)
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        ref[:, t] = h
    at, bt = torch.from_numpy(a).float(), torch.from_numpy(b).float()
    out = ssm.linear_scan(at, bt)
    err = float(np.abs(out.double().numpy() - ref).max())
    assert err <= 1e-5 * np.abs(ref).max(), err
    assert torch.equal(out, ssm.linear_scan(at, bt))
    # the fp64 scan is the recurrence to fp64 rounding
    np.testing.assert_allclose(
        ssm.linear_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        ref, rtol=1e-12, atol=1e-12)


def test_rglru_gradient_matches_jax():
    jp, tp = _block_params(seed=2)
    x = _randn(2, 12, D_MODEL, seed=3)
    dy = _randn(2, 12, D_MODEL, seed=4)

    def jloss(p, xx):
        y, h = jssm.rglru_block(p, xx)
        return jnp.sum(y * dy) + jnp.sum(h)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, h = ssm.rglru_block(leaves, xt)
    ((y * torch.from_numpy(dy)).sum() + h.sum()).backward()
    for k in tp:
        g = np.asarray(jg[k])
        err = np.abs(leaves[k].grad.numpy() - g).max() / np.abs(g).max()
        assert err <= 1e-4, (k, err)
    _close(jgx, xt.grad, dict(rtol=1e-4, atol=1e-5))


# ---------------------------------------------------------------------------
# 'r' layers in the stack: prefill, decode
# ---------------------------------------------------------------------------

def _model(seed=0, **kw):
    kw.setdefault("attn_impl", "pallas")
    jcfg = j_reduced(j_get_arch(ARCH), **kw)
    tcfg = reduced(get_arch(ARCH), **kw)
    jp = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                jlm.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, tcfg, jp, convert.params_from_jax(jp, device="cpu")


def _tokens(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(
        np.int32)


def test_reduced_stack_holds_an_r_layer_in_its_remainder():
    jcfg, tcfg, _, tp = _model()
    assert tcfg.kinds == ("r", "r", "a", "r")
    assert ttf.stack_plan(tcfg) == jtf.stack_plan(jcfg) == \
        (("r", "r", "a"), 1, ("r",))
    assert set(tp["blocks"]["rem"]) == {"rem0_r"}
    st = tlm.init_decode_state(tcfg, 2, 8, device="cpu")
    assert st["rem"]["rem0_r"]["conv"].shape == (2, 3, 64)
    assert st["scan"]["0_r"]["h"].dtype == torch.float32
    shapes = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (tuple(a.shape), str(a.dtype)), tree)
    assert shapes(convert.params_to_numpy(st)) == \
        shapes(jlm.init_decode_state(jcfg, 2, 8))
    assert tlm.expected_flash_calls(tcfg, 2) == 2
    assert tlm.expected_flash_calls(
        dataclasses.replace(get_arch(ARCH), attn_impl="pallas"), 1) == 12


@pytest.mark.parametrize("s", [2, 24])
def test_prefill_then_decode_equals_prefill(s):
    """Prefill of S tokens against S - 1 tokens and one decode step: the
    last logits and every layer's state agree, within LM_TOL, on the port
    and on the JAX package.  At S 2 the decode's window holds two zero
    rows in front of the prompt's one row (the zero-filled slots)."""
    jcfg, tcfg, jp, tp = _model(seed=1)
    toks = _tokens(2, s, seed=s)
    with torch.no_grad():
        ops.reset_counts()
        full_st, full = tlm.prefill(tcfg, tp, {"tokens": torch.from_numpy(
            toks)}, s + 4)
        st, _ = tlm.prefill(tcfg, tp, {"tokens": torch.from_numpy(
            toks[:, :-1])}, s + 4)
        assert ops.flash_plain_calls == tlm.expected_flash_calls(tcfg, 2)
        if s - 1 < 3:
            conv = st["scan"]["0_r"]["conv"]
            assert not bool(conv[:, :, :3 - (s - 1)].any())
        dec, st = tlm.decode_step(tcfg, tp, st, torch.from_numpy(
            toks[:, -1:]), s - 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **LM_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(convert.params_to_numpy(st)),
                    jax.tree_util.tree_leaves(
                        convert.params_to_numpy(full_st))):
        np.testing.assert_allclose(a, b, **LM_TOL)
    jst, _ = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :-1])},
                         s + 4)
    jdec, _ = jlm.decode_step(jcfg, jp, jst, jnp.asarray(toks[:, -1:]),
                              jnp.int32(s - 1))
    _close(jdec, dec)

