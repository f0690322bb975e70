"""The port's LM training slice against the JAX package, on the CPU.

Inputs come from numpy seeds; parameters are the JAX package's, carried
across by ``repro_torch.convert``.  Sizes are the smallest that show each
contract: reduced configs (d 64, 4 heads of dh 16, vocab 256), 2 layers.

Tolerances and their reasons:

- ``checkpointed_scan`` (i): bitwise within the port, every policy against
  ``'none'`` (the checkpoints keep the first forward's graph and recompute
  only its saved tensors, with the same kernels); against the JAX
  package, its own contract's rtol 1e-12 in fp64
  (``tests/test_depth_ode.py``), normwise (of max|g|): across two
  frameworks tanh and the products round differently, and an element
  near zero (3.6e-4 against a max of 40) differs by 1e-10 of itself.
- ``VAL_TOL`` (rtol = atol = 2e-5), fp32 values (attention outputs,
  losses, grad norms): the LM slice's tolerance (``test_torch_lm.py``);
  the two frameworks sum the same products in other orders.
- ``GRAD_TOL`` = 1e-4 of each leaf's max|g|, fp32 gradients, normwise:
  a weight's gradient element sums over every position of the batch
  (B S = 600 at the RWKV6 case), each product rounded in another order
  on the two sides, so n 2**-24 = 3.6e-5 of the sum of |terms|, which is
  within a few times max|g|; the chunked RWKV6 form adds the rounding of
  its cumsums inside exponentials.  Measured: below 1e-6 of max|g| for
  attention, 7e-6 for TinyLlama's leaves and 2.4e-5 for RWKV6-7B's at S
  = 300.  Normwise, because an element near zero is the difference of
  larger terms and has no relative accuracy.
- RWKV6 (iii): ``rwkv6_plain_vjp`` in fp64 against ``jax.vjp`` of the
  JAX package's chunked core, which casts to fp32 inside (``resh``) even
  under x64, so within ``GRAD_TOL``; the kernel's algorithm
  (``rwkv6_vjp_chunked``) against ``rwkv6_plain_vjp``, both fp64, within
  1e-10 of max|g| (the ``mid`` renormaliser's terms cancel up to fp64
  rounding).
- The train steps (v): the port's step and the JAX package's jitted step
  (under an Auto-axes mesh, jax 0.9.0's default mesh being refused by the
  JAX attention's sharding pins) from the same params, batch and AdamW:
  loss and grad norm within ``VAL_TOL``, moments m within ``GRAD_TOL``
  of their max, v (squares) within 2e-4 of theirs, params within
  ``PARAM_TOL`` (atol 1e-7 absolute plus 2e-5 of max|p|).  AdamW's
  ``eps`` is 1e-3 on both sides here: with the default 1e-8 a step's
  update is sign(g) wherever |g| > eps, so an element whose gradient is
  within rounding of zero may take +lr on one side and -lr on the other,
  which says nothing about either implementation.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from torch.utils import _pytree as pytree

from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_arch as j_get_arch
from repro.core.depth_ode import checkpointed_scan as j_checkpointed_scan
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro.nn import ssm as jssm
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import convert
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_arch
from repro_torch.core.depth_ode import checkpointed_scan
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rwkv6_plain_vjp
from repro_torch.kernels.rwkv6_cases import rwkv6_inputs, rwkv6_vjp_chunked
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.models import lm as tlm
from repro_torch.nn import attention as tattn
from repro_torch.nn import ssm as tssm
from repro_torch.optim.adamw import AdamW

VAL_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 1e-4
V_TOL = 2e-4
PARAM_TOL = dict(rtol=0.0, atol=1e-7)
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture
def f32():
    with jax.enable_x64(False):
        yield


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _normwise(port, ref, tol, what=""):
    a = np.asarray(port.detach().double() if torch.is_tensor(port) else port,
                   np.float64)
    b = np.asarray(ref, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= tol, (what, err, tol)


def _leaves_close(port_tree, jax_tree, tol):
    jl = jax.tree_util.tree_leaves(jax_tree)
    tl = pytree.tree_leaves(port_tree)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        _normwise(t, j, tol)


# ---------------------------------------------------------------------------
# (i) checkpointed_scan
# ---------------------------------------------------------------------------

N_LAYERS, D = 12, 16
POLICIES = [("none", {}), ("full", {}), ("sqrt", {}),
            ("revolve", {"ncheck": 1}), ("revolve", {"ncheck": 3})]


def _scan_setup():
    rs = np.random.RandomState(0)
    w = 0.2 * rs.randn(N_LAYERS, D, D)
    b = 0.05 * rs.randn(N_LAYERS, D)
    u0 = rs.randn(4, D)
    return u0, {"w": w, "b": b}


def _port_scan_grads(remat, kw):
    u0, st = _scan_setup()
    u = torch.tensor(u0, requires_grad=True)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in st.items()}
    out = checkpointed_scan(lambda c, q: c + torch.tanh(c @ q["w"] + q["b"]),
                            u, p, N_LAYERS, remat=remat, **kw)
    val = (out ** 2).sum()
    return [val.detach()] + list(torch.autograd.grad(val, (u, p["w"],
                                                           p["b"])))


@pytest.mark.parametrize(
    "remat,kw", POLICIES,
    ids=[f"{r}{k.get('ncheck', '')}" for r, k in POLICIES])
def test_checkpointed_scan_bitwise_and_matches_jax(remat, kw):
    ref = _port_scan_grads("none", {})
    got = _port_scan_grads(remat, kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    u0, st = _scan_setup()
    with jax.enable_x64(True):
        def loss(u, p):
            out = j_checkpointed_scan(
                lambda c, q: c + jnp.tanh(c @ q["w"] + q["b"]), u, p,
                N_LAYERS, remat=remat, **kw)
            return jnp.sum(out ** 2)

        val, (gu, gp) = jax.value_and_grad(loss, argnums=(0, 1))(
            jnp.asarray(u0), {k: jnp.asarray(v) for k, v in st.items()})
        for a, b in zip(got, [val, gu, gp["w"], gp["b"]]):
            _normwise(a, b, 1e-12)


def test_checkpointed_scan_refusals():
    u0, st = _scan_setup()
    p = {k: torch.tensor(v) for k, v in st.items()}
    with pytest.raises(ValueError, match="ncheck"):
        checkpointed_scan(lambda c, q: c, torch.tensor(u0), p, N_LAYERS,
                          remat="revolve")
    with pytest.raises(ValueError, match="unknown remat"):
        checkpointed_scan(lambda c, q: c, torch.tensor(u0), p, N_LAYERS,
                          remat="bogus")


# ---------------------------------------------------------------------------
# (ii) the chunked attention's custom VJP
# ---------------------------------------------------------------------------

# (B, S, H, Hkv, causal, window, block): the block divides S or leaves a
# ragged last one
ATTN_CASES = [
    pytest.param(2, 40, 4, 2, True, 0, 16, id="causal-gqa-ragged"),
    pytest.param(2, 70, 4, 4, True, 20, 16, id="window-ragged"),
    pytest.param(1, 48, 2, 1, False, 0, 16, id="bidirectional-gqa"),
    pytest.param(1, 600, 4, 2, True, 0, 512, id="two-512-blocks"),
]


@pytest.mark.parametrize("b,s,h,hkv,causal,window,blk", ATTN_CASES)
def test_flash_custom_vjp_matches_jax_and_autograd(f32, b, s, h, hkv, causal,
                                                   window, blk):
    rs = np.random.RandomState(0)
    dh, rep = 16, h // hkv
    q = rs.randn(b, s, h, dh).astype(np.float32)
    k = rs.randn(b, s, hkv, dh).astype(np.float32)
    v = rs.randn(b, s, hkv, dh).astype(np.float32)
    do = rs.randn(b, s, h, dh).astype(np.float32)
    kr, vr = np.repeat(k, rep, 2), np.repeat(v, rep, 2)
    jo, vjp = jax.vjp(
        lambda q_, k_, v_: jattn._flash_attention(
            q_, k_, v_, jnp.asarray(window), causal, blk, blk,
            window or None), *map(jnp.asarray, (q, kr, vr)))
    jdq, jdk, jdv = (np.asarray(g) for g in vjp(jnp.asarray(do)))
    # autograd sums the repeated kv heads' gradients
    jdk, jdv = (g.reshape(b, s, hkv, rep, dh).sum(3) for g in (jdk, jdv))

    def port(fn):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                      for x in (q, k, v))
        out = fn(tq, tk, tv)
        return [out] + list(torch.autograd.grad(out, (tq, tk, tv),
                                                torch.from_numpy(do)))

    custom = port(lambda tq, tk, tv: tattn._FlashAttention.apply(
        tq, tattn._repeat_kv(tk, h), tattn._repeat_kv(tv, h), window, causal,
        blk, blk, window))
    np.testing.assert_allclose(custom[0].detach().numpy(), np.asarray(jo),
                               **VAL_TOL)
    for t, j in zip(custom[1:], (jdq, jdk, jdv)):
        _normwise(t, j, GRAD_TOL)
    autodiff = port(lambda tq, tk, tv: tattn.attention_chunked(
        tq, tk, tv, causal=causal, window=window, q_block=blk, k_block=blk))
    np.testing.assert_allclose(autodiff[0].detach().numpy(),
                               custom[0].detach().numpy(), **VAL_TOL)
    for a, c in zip(autodiff[1:], custom[1:]):
        _normwise(a, c, GRAD_TOL)
    if blk == min(512, s):
        # the dispatcher takes the custom VJP for impl="chunked"
        via = port(lambda tq, tk, tv: tattn.attention(
            tq, tk, tv, causal=causal, window=window, impl="chunked"))
        for a, c in zip(via, custom):
            assert torch.equal(a.detach(), c.detach())


def test_pallas_impl_refuses_autograd():
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="autograd"):
        tattn.attention(q, q, q, impl="pallas")


# ---------------------------------------------------------------------------
# (iii) the RWKV6 gradient
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_rwkv6_core(monkeypatch):
    """The JAX package's ``rwkv6_mix_chunked`` reduced to its chunked core:
    its projections hand back given (r, k, v, logw) and its output stage
    returns the recurrence's (B, S, H, dh) output as it is."""
    held = {}
    monkeypatch.setattr(jssm, "rwkv6_projections",
                        lambda params, x, n_heads: held["rkvgw"])
    monkeypatch.setattr(jssm, "_rwkv_out",
                        lambda params, y, g, dtype, b, s, d: y)

    def core(r, k, v, logw, u):
        held["rkvgw"] = (r, k, v, None, logw)
        b, s, h, dh = r.shape
        x = jnp.zeros((b, s, h * dh), r.dtype)
        return jssm.rwkv6_mix_chunked({"u_bonus": u}, x, h)[0]

    return core


def test_rwkv6_plain_vjp_matches_jax_fp64(jax_rwkv6_core):
    b, h, s, dh = 2, 2, 300, 16
    rs = np.random.RandomState(0)
    ins = [t.double() for t in rwkv6_inputs(b, h, s, dh, rs, layout="bshd")]
    dy = torch.from_numpy(rs.randn(b, s, h, dh))
    with jax.enable_x64(True):
        _, vjp = jax.vjp(jax_rwkv6_core, *(jnp.asarray(t.numpy())
                                           for t in ins))
        jg = vjp(jnp.asarray(dy.numpy()))
    tg = rwkv6_plain_vjp(*ins, dy, chunk=64)
    for t, j in zip(tg, jg):
        _normwise(t, j, GRAD_TOL)
    # the kernel's algorithm (mid held constant, the scans of W and Z)
    for t, p in zip(rwkv6_vjp_chunked(*ins, dy, chunk=64), tg):
        _normwise(t, p, 1e-10)


def test_rwkv6_backward_wrapper_on_the_cpu():
    """CPU tensors take ``rwkv6_plain_vjp`` (counted as plain calls); each
    gradient comes back in its operand's dtype and shape; bad operands
    raise."""
    r, k, v, logw, u = rwkv6_inputs(1, 2, 70, 16, np.random.RandomState(0),
                                    layout="bshd")
    r, k, v = (t.to(torch.bfloat16) for t in (r, k, v))
    dy = torch.randn(r.shape)
    ops.reset_counts()
    grads = ops.rwkv6_chunked_bwd_fp32(r, k, v, logw, u, dy, chunk=64)
    assert (ops.rwkv6_bwd_plain_calls, ops.rwkv6_bwd_launches) == (1, 0)
    assert [(g.dtype, g.shape) for g in grads] == \
        [(t.dtype, t.shape) for t in (r, k, v, logw, u)]
    for got, want in zip(grads, rwkv6_plain_vjp(r, k, v, logw, u, dy,
                                                chunk=64)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="dy"):
        ops.rwkv6_chunked_bwd_fp32(r, k, v, logw, u, dy.double(), chunk=64)
    with pytest.raises(TypeError, match="fp32"):
        ops.rwkv6_chunked_bwd_fp32(r, k, v, logw.double(), u, dy, chunk=64)


def _rwkv_params(seed=0):
    jcfg = j_reduced(j_get_arch("rwkv6-7b"), n_layers=1)
    jp = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jlm.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, jax.tree_util.tree_map(
        lambda a: a[0], jp["blocks"]["scan"]["0_w"]["tmix"])


def test_rwkv6_mix_chunked_gradient_matches_jax(f32):
    jcfg, jp = _rwkv_params()
    s, d = 300, jcfg.d_model
    x = np.random.RandomState(1).randn(2, s, d).astype(np.float32)
    dy = np.random.RandomState(2).randn(2, s, d).astype(np.float32)
    _, vjp = jax.vjp(lambda p, x_: jssm.rwkv6_mix_chunked(
        p, x_, jcfg.n_heads)[0], jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    tp = convert.params_from_jax(jp, device="cpu")
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ops.reset_counts()
    y, _ = tssm.rwkv6_mix_chunked(leaves, tx, jcfg.n_heads)
    grads = torch.autograd.grad(y, [tx] + list(leaves.values()),
                                torch.from_numpy(dy))
    assert (ops.rwkv6_plain_calls, ops.rwkv6_bwd_plain_calls) == (1, 1)
    assert (ops.rwkv6_launches, ops.rwkv6_bwd_launches) == (0, 0)
    _normwise(grads[0], jgx, GRAD_TOL)
    for (name, t) in zip(leaves, grads[1:]):
        _normwise(t, jgp[name], GRAD_TOL, name)


def test_rwkv6_final_state_has_no_gradient():
    _, jp = _rwkv_params()
    tp = {k: v.requires_grad_(True)
          for k, v in convert.params_from_jax(jp, device="cpu").items()}
    x = torch.randn(1, 300, 64)
    _, state = tssm.rwkv6_mix_chunked(tp, x, 4)
    with pytest.raises(NotImplementedError, match="final state"):
        state.sum().backward()


# ---------------------------------------------------------------------------
# (iv) loss_fn and (v) the train step
# ---------------------------------------------------------------------------

# (arch, attention impl, sequence): the chunked custom VJP on TinyLlama,
# the chunked RWKV6 form (S > 256) on RWKV6-7B
LM_CASES = [pytest.param("tinyllama-1.1b", "chunked", 24, id="tinyllama"),
            pytest.param("rwkv6-7b", "naive", 300, id="rwkv6-chunked")]


def _lm(arch, impl, seed=0):
    kw = dict(n_layers=2, attn_impl=impl)
    jcfg = j_reduced(j_get_arch(arch), **kw)
    tcfg = reduced(get_arch(arch), **kw)
    jp = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jlm.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, tcfg, jp


def _batch(b, s, seed=0):
    t = np.random.RandomState(seed).randint(0, 256, (b, s)).astype(np.int32)
    return {"tokens": t, "targets": t}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch,impl,s", LM_CASES)
def test_loss_fn_value_and_grad_match_jax(f32, arch, impl, s):
    jcfg, tcfg, jp = _lm(arch, impl)
    batch = _batch(2, s)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, _jbatch(batch)), has_aux=True)(jp)
    loss, _, grads = value_and_grad(
        tcfg, convert.params_from_jax(jp, device="cpu"), _tbatch(batch))
    np.testing.assert_allclose(float(loss), float(jl), **VAL_TOL)
    _leaves_close(grads, jg, GRAD_TOL)


def _jax_steps(jcfg, jp, batch, accum, n):
    with _auto_mesh():
        step = jax.jit(j_make_train_step(jcfg, JAdamW(**OPT), accum=accum))
        p, o = jp, JAdamW(**OPT).init(jp)
        out = []
        for i in range(n):
            p, o, m = step(p, o, _jbatch(batch), jnp.int32(i))
            out.append((p, o, m))
    return out


@pytest.mark.parametrize("accum,n", [(1, 3), (2, 1)])
def test_train_step_matches_jax(f32, accum, n):
    jcfg, tcfg, jp = _lm("tinyllama-1.1b", "chunked")
    batch = _batch(4, 24, seed=1)
    jouts = _jax_steps(jcfg, jp, batch, accum, n)
    opt = AdamW(**OPT)
    step = make_train_step(tcfg, opt, accum=accum)
    params = convert.params_from_jax(jp, device="cpu")
    state = opt.init(params)
    for i, (jp_i, jo_i, jm_i) in enumerate(jouts):
        params, state, m = step(params, state, _tbatch(batch), i)
        np.testing.assert_allclose(float(m["loss"]), float(jm_i["loss"]),
                                   **VAL_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm_i["grad_norm"]), **VAL_TOL)
        assert state.step == int(jo_i.step) == i + 1
        _leaves_close(state.m, jo_i.m, GRAD_TOL)
        _leaves_close(state.v, jo_i.v, V_TOL)
        for t, j in zip(pytree.tree_leaves(params),
                        jax.tree_util.tree_leaves(jp_i)):
            bound = PARAM_TOL["atol"] + 2e-5 * float(np.abs(j).max())
            assert float(np.abs(t.numpy() - np.asarray(j)).max()) <= bound


def test_poisoned_step_commits_nothing():
    _, tcfg, jp = _lm("tinyllama-1.1b", "chunked")
    opt = AdamW(**OPT)
    params = convert.params_from_jax(jp, device="cpu")
    state = opt.init(params)
    batch = _tbatch(_batch(2, 16))
    clean = make_train_step(tcfg, opt)
    gated = make_train_step(tcfg, opt, sentinel=True)
    p1, s1, _ = clean(params, state, batch, 0)
    p2, s2, m2 = gated(params, state, batch, 0)
    assert int(m2["nonfinite"]) == 0 and s2.step == s1.step == 1
    for a, b in zip(pytree.tree_leaves((p1, s1.m, s1.v)),
                    pytree.tree_leaves((p2, s2.m, s2.v))):
        assert torch.equal(a, b)
    p3, s3, m3 = gated(p2, s2, batch, 1, poison=True)
    assert int(m3["nonfinite"]) == 1 and s3.step == 1
    assert not np.isfinite(float(m3["loss"]))
    for a, b in zip(pytree.tree_leaves((p2, s2.m, s2.v)),
                    pytree.tree_leaves((p3, s3.m, s3.v))):
        assert torch.equal(a, b)


def test_adamw_grad_dtype_rounds_the_gradient():
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([1.0 + 2.0 ** -12, 3.0])}
    rounded = {"w": torch.tensor([1.0, 3.0])}   # g in bf16
    opt = AdamW(grad_dtype="bfloat16")
    new, state, m = opt.update(g, opt.init(p), p)
    ref_new, ref_state, ref_m = AdamW().update(rounded, opt.init(p), p)
    assert torch.equal(m["grad_norm"], ref_m["grad_norm"])
    assert torch.equal(new["w"], ref_new["w"])
    assert torch.equal(state.m["w"], ref_state.m["w"])
    _, _, raw = AdamW().update(g, opt.init(p), p)
    assert not torch.equal(raw["grad_norm"], m["grad_norm"])


def test_expected_rwkv6_train_calls():
    cfg = reduced(get_arch("rwkv6-7b"), n_layers=3)
    assert tlm.expected_rwkv6_train_calls(cfg, 300, "none") == (3, 3)
    for remat in ("full", "sqrt", "revolve"):
        assert tlm.expected_rwkv6_train_calls(cfg, 300, remat, 2) == (12, 6)
    assert tlm.expected_rwkv6_train_calls(cfg, 256, "sqrt") == (0, 0)
    assert tlm.expected_rwkv6_train_calls(
        dataclasses.replace(get_arch("tinyllama-1.1b")), 4096, "sqrt") \
        == (0, 0)
