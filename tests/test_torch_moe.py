"""The port's MoE block (``repro_torch.nn.moe``) against the JAX package's
``repro.nn.moe``, on the CPU.

Inputs come from numpy seeds; the weights are the JAX package's
``init_moe``'s.  Routing is held first, exactly: the top-k indices and
the kept mask equal the reference's formulas computed in jnp, and the
seed's smallest margin between a token's k-th and (k+1)-th probability
is asserted, so a near-tie would show as a routing difference and not
hide in a tolerance.  Then the output and the aux loss within the
reference's own ``tests/test_moe.py`` tolerance (rtol = atol = 2e-4;
measured below 1e-6), in fp32 under ``jax.enable_x64(False)``.  The
gradient at cf 1.25 (tokens dropped) in fp64 under
``jax.enable_x64(True)``, autograd against ``jax.vjp``, within 1e-10 of
each leaf's max|g|: the two sides run the same fp64 operations in other
orders (the router's input is rounded to fp32 on both, as the reference
does).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_arch as j_get_arch
from repro.models import lm as jlm
from repro.nn import moe as jmoe
from repro_torch import convert
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_arch
from repro_torch.launch.steps import value_and_grad
from repro_torch.nn import moe as tmoe

MOE_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD64_TOL = 1e-10
D, FF = 16, 32
# (E, k); cf 1.25 drops pairs, cf = E is dropless; T = 64 is a multiple of
# the group size 16 (4 groups), T = 42 is not (groups of 14)
EK = [(4, 2), (8, 2), (16, 4)]
CF = ["drops", "dropless"]
TOKENS = [(2, 32), (2, 21)]


def _cf(which, e):
    return 1.25 if which == "drops" else float(e)


def _setup(e, b, s, seed=0, dtype=np.float32):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), D, FF, e)
    jp = {k: np.array(v, dtype) for k, v in jp.items()}
    x = np.random.RandomState(seed + 1).randn(b, s, D).astype(dtype)
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    return jp, tp, x


def _jax_routing(jp, x, e, k, cf, group_size):
    """The reference's routing formulas (``repro/nn/moe.py`` :56-80), in
    jnp: (top-k indices, kept mask, sorted probabilities)."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    t = xf.shape[0]
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ jp["w_router"], axis=-1)
    _, gi = jax.lax.top_k(probs, k)
    g_sz = jmoe._group_size(t, group_size)
    g = t // g_sz
    cap = int(max(k, cf * k * g_sz / e))
    oh = jax.nn.one_hot(gi.reshape(g, g_sz * k), e, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(oh, axis=1) - oh) * oh, axis=-1)
    keep = (pos < cap).reshape(t, k)
    return (np.asarray(gi), np.asarray(keep),
            np.sort(np.asarray(probs), axis=-1)[:, ::-1])


@pytest.fixture
def f32():
    with jax.enable_x64(False):
        yield


@pytest.mark.parametrize("dispatch", ["slots", "sorted"])
@pytest.mark.parametrize("b,s", TOKENS, ids=["T64", "T42"])
@pytest.mark.parametrize("cf", CF)
@pytest.mark.parametrize("e,k", EK, ids=[f"E{e}k{k}" for e, k in EK])
def test_moe_block_routes_and_matches_jax(f32, e, k, cf, b, s, dispatch):
    jp, tp, x = _setup(e, b, s)
    cfv = _cf(cf, e)
    gi, keep, sp = _jax_routing(jp, x, e, k, cfv, 16)
    # the seed's routing is no near-tie: the k-th and (k+1)-th
    # probabilities of every token are apart by far more than rounding
    assert float((sp[:, k - 1] - sp[:, k]).min()) > 1e-5
    xt = torch.from_numpy(x)
    r = tmoe.route(tp["w_router"], xt.reshape(-1, D), n_experts=e, top_k=k,
                   capacity_factor=cfv, group_size=16)
    np.testing.assert_array_equal(r.idx.numpy(), gi)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert bool(keep.all()) == (cf == "dropless")
    jo, ja = jmoe.moe_block(jp, jnp.asarray(x), n_experts=e, top_k=k,
                            capacity_factor=cfv, group_size=16)
    with torch.no_grad():
        to, ta = tmoe.moe_block(tp, xt, n_experts=e, top_k=k,
                                capacity_factor=cfv, group_size=16,
                                dispatch=dispatch)
        plain = tmoe.moe_plain(tp, xt, r)
    assert to.shape == (b, s, D) and to.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MOE_TOL)
    np.testing.assert_allclose(float(ta), float(ja), **MOE_TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jo), **MOE_TOL)


@pytest.mark.parametrize("e,k", [(4, 1), (4, 2), (8, 2), (16, 4)])
def test_uniform_router_ties_go_to_the_lower_index(f32, e, k):
    """Ties everywhere: a zero router gives every token the same
    probabilities, and ``lax.top_k`` takes the lower indices first; so
    does the port.  Then a router whose columns repeat in pairs (ties
    between expert 2i and 2i+1 in every token)."""
    jp, tp, x = _setup(e, 1, 24)
    for i, w in enumerate((
            np.zeros((D, e), np.float32),
            np.repeat(np.asarray(jp["w_router"])[:, :e // 2], 2, axis=1))):
        jw = dict(jp, w_router=w)
        gi, keep, _ = _jax_routing(jw, x, e, k, 1.25, 1024)
        if i == 0:
            assert (gi == np.arange(k)).all()
        r = tmoe.route(torch.from_numpy(w), torch.from_numpy(x).reshape(-1, D),
                       n_experts=e, top_k=k, capacity_factor=1.25)
        np.testing.assert_array_equal(r.idx.numpy(), gi)
        np.testing.assert_array_equal(r.keep.numpy(), keep)
        jo, ja = jmoe.moe_block(jw, jnp.asarray(x), n_experts=e, top_k=k)
        with torch.no_grad():
            to, ta = tmoe.moe_block(dict(tp, w_router=torch.from_numpy(w)),
                                    torch.from_numpy(x), n_experts=e,
                                    top_k=k)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MOE_TOL)
        np.testing.assert_allclose(float(ta), float(ja), **MOE_TOL)


@pytest.mark.parametrize("dispatch", ["slots", "sorted"])
@pytest.mark.parametrize("e,k", [(4, 2), (16, 4)], ids=["E4k2", "E16k4"])
def test_moe_gradient_matches_jax_vjp_fp64(e, k, dispatch):
    """cf 1.25 with drops, T = 42 in groups of 14: autograd of (out, aux)
    against ``jax.vjp`` under x64, every leaf and x within 1e-10 of its
    max|g|."""
    with jax.enable_x64(True):
        jp, tp, x = _setup(e, 2, 21, dtype=np.float64)
        rs = np.random.RandomState(7)
        dout = rs.randn(2, 21, D)
        daux = 0.37

        def f(p, xx):
            return jmoe.moe_block(p, xx, n_experts=e, top_k=k,
                                  capacity_factor=1.25, group_size=16)

        (jo, ja), vjp = jax.vjp(f, jp, jnp.asarray(x))
        jgp, jgx = vjp((jnp.asarray(dout), jnp.asarray(daux)))
    keep = _jax_routing({k_: v.astype(np.float32) for k_, v in jp.items()},
                        x.astype(np.float32), e, k, 1.25, 16)[1]
    assert not keep.all()
    tp = {k_: v.requires_grad_(True) for k_, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    to, ta = tmoe.moe_block(tp, xt, n_experts=e, top_k=k,
                            capacity_factor=1.25, group_size=16,
                            dispatch=dispatch)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=1e-12, atol=1e-12)
    grads = torch.autograd.grad(
        (to * torch.from_numpy(dout)).sum() + daux * ta,
        [tp[n] for n in sorted(tp)] + [xt])
    refs = [jgp[n] for n in sorted(tp)] + [jgx]
    for name, g, j in zip(sorted(tp) + ["x"], grads, refs):
        j = np.asarray(j)
        err = np.abs(g.numpy() - j).max() / np.abs(j).max()
        assert err <= GRAD64_TOL, (name, err)


def test_moe_backward_is_the_same_bits_twice_and_layouts_agree(f32):
    jp, tp, x = _setup(8, 2, 32)
    dout = torch.from_numpy(np.random.RandomState(3).randn(2, 32, D)
                            .astype(np.float32))
    runs = {}
    for dispatch in ("slots", "slots", "sorted"):
        p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        xt = torch.from_numpy(x).requires_grad_(True)
        out, aux = tmoe.moe_block(p, xt, n_experts=8, top_k=2,
                                  capacity_factor=1.25, group_size=16,
                                  dispatch=dispatch)
        g = torch.autograd.grad((out * dout).sum() + aux,
                                [p[n] for n in sorted(p)] + [xt])
        runs.setdefault(dispatch, []).append([out, aux, *g])
    first, second = runs["slots"]
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for a, b in zip(first, runs["sorted"][0]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_moe_refuses_an_unknown_dispatch():
    _, tp, x = _setup(4, 1, 8)
    with pytest.raises(ValueError, match="dispatch"):
        tmoe.moe_block(tp, torch.from_numpy(x), n_experts=4, top_k=2,
                       dispatch="dense")


def test_init_moe_draws_the_reference_layout():
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(gen, D, FF, 8, torch.bfloat16, lead=(3,))
    jp = jmoe.init_moe(jax.random.PRNGKey(0), D, FF, 8, jnp.bfloat16)
    for n, v in jp.items():
        assert tuple(p[n].shape) == (3, *v.shape)
        assert str(p[n].dtype).split(".")[-1] == str(v.dtype)
    assert p["w_router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "dbrx-132b"])
def test_moe_tree_crosses_convert_unchanged(arch):
    """The stacked 4-D expert weights (units, E, D, F) keep their layout
    through ``convert`` both ways: the conv rule (a 4-D leaf named "w")
    does not touch them."""
    jcfg = j_reduced(j_get_arch(arch))
    jp = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = convert.params_from_jax(jp, device="cpu")
    moe = tp["blocks"]["scan"]["0_a"]["moe"]
    jm = jp["blocks"]["scan"]["0_a"]["moe"]
    for n in ("w_gate", "w_up", "w_down"):
        assert moe[n].ndim == 4
        np.testing.assert_array_equal(moe[n].numpy(), jm[n])
    assert moe["w_router"].shape == (jcfg.n_layers, jcfg.d_model,
                                     jcfg.n_experts)
    jax.tree_util.tree_map(np.testing.assert_array_equal, jp,
                           convert.params_to_numpy(tp))
    tcfg = reduced(get_arch(arch))
    mine = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg.d_model,
                         tcfg.d_ff, tcfg.n_experts, lead=(tcfg.n_layers,))
    assert {n: tuple(v.shape) for n, v in mine.items()} == \
        {n: tuple(v.shape) for n, v in moe.items()}


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "dbrx-132b"])
def test_remat_policies_give_bitwise_gradients_on_reduced_moe(f32, arch):
    """The four depth remat policies on reduced Mixtral (and DBRX at its
    16 experts, top 4), 4 layers at cf 1.25: the same loss and gradient
    bits, the aux loss included."""
    kw = dict(n_experts=16, top_k=4) if arch == "dbrx-132b" else {}
    cfg = reduced(get_arch(arch), attn_impl="chunked", **kw)
    params = convert.params_from_jax(jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jlm.init_params(j_reduced(j_get_arch(arch), **kw),
                        jax.random.PRNGKey(0))), device="cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 40)).astype(np.int32))
    batch = {"tokens": toks, "targets": toks}
    runs = {}
    for remat, ncheck in (("none", None), ("full", None), ("sqrt", None),
                          ("revolve", 1)):
        c = dataclasses.replace(cfg, remat=remat, ncheck=ncheck)
        loss, m, g = value_and_grad(c, params, batch)
        runs[remat] = [loss, m["aux"]] + pytree.tree_leaves(g)
    assert float(runs["none"][1]) > 0
    for remat, leaves in runs.items():
        assert all(torch.equal(a, b) for a, b in zip(leaves, runs["none"])), \
            remat
