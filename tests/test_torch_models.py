"""The port's vector fields, CNF, classifier and AdamW held against the JAX
package on shared inputs, and the slice end to end at a small size.

Weights are made by the JAX package's ``*_init``, carried across with
``repro_torch.convert`` and cast to fp64 on both sides; data comes from
numpy.  Tolerance rtol 1e-10 / atol 1e-12 in fp64: XLA and PyTorch's CPU
kernels sum matmuls, convolutions and group-norm reductions in different
orders.  AdamW is compared in fp32 (its moments are fp32 by design) at
rtol 1e-6 / atol 1e-7: the two compute the schedule and the bias
corrections with different roundings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adjoint as jadj
from repro.core import cnf as jcnf
from repro.models import ode_nets as jnets
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.core import adjoint as tadj
from repro_torch.core import cnf as tcnf
from repro_torch.core.depth_ode import ODEBlock
from repro_torch.kernels import ops
from repro_torch.models import ode_nets as tnets
from repro_torch.optim import adamw as tadamw

jax.config.update("jax_enable_x64", True)

RTOL, ATOL = 1e-10, 1e-12


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _f64_np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _ttree(tree_np, grad=False):
    t = convert.params_from_jax(tree_np, device="cpu", dtype=torch.float64)
    if grad:
        for x in jax.tree_util.tree_leaves(t):
            x.requires_grad_(True)
    return t


def _flat(tree, prefix=""):
    """{key path: numpy array}: leaf order differs between the two pytree
    libraries (JAX sorts dict keys), so trees are compared by path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _assert_trees_close(port_np, jax_tree, rtol=RTOL, atol=ATOL):
    a, b = _flat(port_np), _flat(jax_tree)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _port_grads(tree, loss):
    leaves = jax.tree_util.tree_leaves(tree)
    grads = torch.autograd.grad(loss, leaves)
    spec = jax.tree_util.tree_structure(tree)
    return convert.params_to_numpy(jax.tree_util.tree_unflatten(spec, grads))


# ---------------------------------------------------------------------------
# vector fields
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["gelu", "tanh", "silu", "softplus", "relu"])
def test_mlp_vf_matches_jax(act):
    th = _f64_np(jnets.mlp_vf_init(jax.random.PRNGKey(0), 4, hidden=16,
                                   n_hidden=2))
    th["layers"][-1]["w"] *= 100.0  # undo the near-zero init: test the net
    u = np.random.RandomState(1).randn(5, 4) * 3
    ref = jnets.mlp_vf(jnp.asarray(u), _jtree(th), 0.3, act=act)
    out = tnets.mlp_vf(torch.tensor(u), _ttree(th), 0.3, act=act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _cnf_theta(dim=3, hidden=(16, 16)):
    th = _f64_np(jnets.cnf_vf_init(jax.random.PRNGKey(2), dim, hidden=hidden))
    rs = np.random.RandomState(5)
    for lyr in th["layers"]:  # non-trivial time gates
        for k in ("t_gate", "t_gate_b", "t_bias"):
            lyr[k] = 0.5 * rs.randn(*lyr[k].shape)
    th["layers"][-1]["w"] *= 30.0
    return th


def test_cnf_vf_matches_jax():
    th = _cnf_theta()
    u = np.random.RandomState(1).randn(7, 3)
    for t in (0.0, 0.1, 0.7):  # t goes through float32 on both sides
        ref = jnets.cnf_vf(jnp.asarray(u), _jtree(th), t)
        out = tnets.cnf_vf(torch.tensor(u), _ttree(th), t)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)


def _conv_theta(channels=8):
    th = _f64_np(jnets.conv_vf_init(jax.random.PRNGKey(3), channels))
    th["conv2"]["w"] *= 100.0
    rs = np.random.RandomState(6)
    th["gn_scale"] = 1 + 0.1 * rs.randn(channels)
    th["gn_bias"] = 0.1 * rs.randn(channels)
    return th


@pytest.mark.parametrize("channels", [4, 16])
def test_conv_vf_matches_jax(channels):
    th = _conv_theta(channels)
    u = np.random.RandomState(2).randn(2, 6, 5, channels)
    ref = jnets.conv_vf(jnp.asarray(u), _jtree(th), 0.25)
    out = tnets.conv_vf(torch.tensor(u), _ttree(th), 0.25)
    assert out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_convert_roundtrip_and_conv_layout():
    th = _f64_np(jnets.classifier_init(jax.random.PRNGKey(0), channels=8))
    t = convert.params_from_jax(th, device="cpu")
    assert tuple(t["stem"]["w"].shape) == (8, 3, 3, 3)          # OIHW
    assert tuple(t["ode"]["conv1"]["w"].shape) == (8, 9, 3, 3)
    assert tuple(t["head"]["w"].shape) == (8, 10)               # (d_in, d_out)
    back = convert.params_to_numpy(t)
    a, b = _flat(back), _flat(th)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_params_from_jax_needs_a_card_unless_asked_for_cpu(monkeypatch):
    """The weights' carrier defaults to the card, as every entry point
    does: without one it raises, and it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    th = {"w": np.ones((2, 3)), "b": np.zeros(3)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_jax(th)
    t = convert.params_from_jax(th, device="cpu")
    assert t["w"].device.type == "cpu"


# ---------------------------------------------------------------------------
# classifier: logits, loss and gradients through the pnode adjoint
# ---------------------------------------------------------------------------

def _classifier_case(seed=0, batch=4, hw=8, channels=8):
    params = _f64_np(jnets.classifier_init(jax.random.PRNGKey(seed),
                                           channels=channels))
    params["ode"]["conv2"]["w"] *= 30.0
    rs = np.random.RandomState(seed + 1)
    images = rs.randn(batch, hw, hw, 3)
    labels = rs.randint(0, 10, size=batch)
    return params, images, labels


def _jax_classifier_loss(params, images, labels, n_steps=2):
    def odeint_fn(vf, u, th):
        return jadj.odeint(vf, u, th, dt=1.0 / n_steps, n_steps=n_steps,
                           method="rk4", adjoint="pnode")

    logits = jnets.classifier_apply(params, images, odeint_fn=odeint_fn)
    return jnets.softmax_xent(logits, labels), logits


def _port_classifier_loss(params, images, labels, n_steps=2, fused=True):
    block = ODEBlock(tnets.conv_vf, n_steps=n_steps, method="rk4",
                     adjoint="pnode", fused_stages=fused)
    logits = tnets.classifier_apply(params, images,
                                    odeint_fn=lambda vf, u, th: block(u, th))
    return tnets.softmax_xent(logits, labels), logits


def test_classifier_loss_and_grads_match_jax():
    params, images, labels = _classifier_case()
    (jl, jlog), jg = jax.jit(jax.value_and_grad(_jax_classifier_loss,
                                                has_aux=True))(
        _jtree(params), jnp.asarray(images), jnp.asarray(labels))
    tp = _ttree(params, grad=True)
    tl, tlog = _port_classifier_loss(tp, torch.tensor(images),
                                     torch.tensor(labels))
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL, atol=ATOL)
    _assert_trees_close(_port_grads(tp, tl), jg)


def test_softmax_xent_one_hot_equals_gather():
    rs = np.random.RandomState(0)
    logits = torch.tensor(rs.randn(6, 10))
    labels = torch.tensor(rs.randint(0, 10, 6))
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    ref = (torch.logsumexp(logits, -1) - gold).mean()
    assert torch.equal(tnets.softmax_xent(logits, labels), ref)


# ---------------------------------------------------------------------------
# CNF log-density and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trace,method,policy,n_steps", [
    ("exact", "dopri5", "pnode", 2),
    ("exact", "rk4", "revolve", 3),
    ("hutchinson", "bosh3", "pnode2", 4),
])
def test_cnf_log_prob_and_grads_match_jax(trace, method, policy, n_steps):
    th = _cnf_theta()
    rs = np.random.RandomState(4)
    x = rs.randn(6, 3)
    probe = rs.choice([-1.0, 1.0], size=x.shape)
    kw = dict(dt=0.25, n_steps=n_steps, method=method, adjoint=policy,
              trace=trace)
    if policy == "revolve":
        kw["ncheck"] = 1

    def jloss(theta, xx):
        lp = jcnf.cnf_log_prob(jnets.cnf_vf, xx, theta,
                               probe=jnp.asarray(probe), **kw)
        return jnp.sum(lp * jnp.arange(1.0, 7.0)), lp

    (_, jlp), (jgth, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        _jtree(th), jnp.asarray(x))
    tth = _ttree(th, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    tlp = tcnf.cnf_log_prob(tnets.cnf_vf, tx, tth,
                            probe=torch.tensor(probe),
                            fused_stages=True, **kw)
    np.testing.assert_allclose(tlp.detach().numpy(), np.asarray(jlp),
                               rtol=RTOL, atol=ATOL)
    loss = torch.sum(tlp * torch.arange(1.0, 7.0, dtype=torch.float64))
    leaves = jax.tree_util.tree_leaves(tth)
    gs = torch.autograd.grad(loss, leaves + [tx])
    _, spec = jax.tree_util.tree_flatten(tth)
    _assert_trees_close(
        convert.params_to_numpy(jax.tree_util.tree_unflatten(spec, gs[:-1])),
        jgth)
    np.testing.assert_allclose(gs[-1].numpy(), np.asarray(jgx), rtol=RTOL,
                               atol=ATOL)


def test_cnf_sample_matches_jax():
    th = _cnf_theta()
    z = np.random.RandomState(8).randn(5, 3)
    ref = jax.jit(lambda zz, tt: jcnf.cnf_sample(
        jnets.cnf_vf, zz, tt, dt=0.25, n_steps=4, method="rk4"))(
        jnp.asarray(z), _jtree(th))
    out = tcnf.cnf_sample(tnets.cnf_vf, torch.tensor(z), _ttree(th), dt=0.25,
                          n_steps=4, method="rk4")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_three_updates_match_jax():
    rs = np.random.RandomState(0)
    params = {"a": rs.randn(3, 4).astype(np.float32),
              "b": [rs.randn(5).astype(np.float32)]}
    grads = [{"a": rs.randn(3, 4).astype(np.float32) * s,
              "b": [rs.randn(5).astype(np.float32) * s]} for s in (0.1, 3.0, 1.0)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.05)
    with jax.enable_x64(False):
        jopt = jadamw.AdamW(**kw)
        jp = _jtree(params)
        js = jopt.init(jp)
        for g in grads:
            jp, js, jinfo = jopt.update(_jtree(g), js, jp)
        jp = jax.tree_util.tree_map(np.asarray, jp)
    topt = tadamw.AdamW(**kw)
    tp = convert.params_from_jax(params, device="cpu")
    ts = topt.init(tp)
    for g in grads:
        tp, ts, tinfo = topt.update(convert.params_from_jax(g, device="cpu"),
                                    ts, tp)
    assert ts.step == 3
    np.testing.assert_allclose(float(tinfo["grad_norm"]),
                               float(jinfo["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(tinfo["lr"], float(jinfo["lr"]), rtol=1e-6)
    _assert_trees_close(convert.params_to_numpy(tp), jp, rtol=1e-6,
                        atol=1e-7)


# ---------------------------------------------------------------------------
# the slice end to end at a small size
# ---------------------------------------------------------------------------

def test_slice_end_to_end_classifier_training():
    """Loss, gradients and two AdamW steps of the fused pnode classifier
    against the JAX package (fp64 model, fp32 optimizer state)."""
    params, images, labels = _classifier_case(seed=3)
    kw = dict(lr=5e-3, warmup_steps=1, total_steps=4)
    jopt, topt = jadamw.AdamW(**kw), tadamw.AdamW(**kw)
    jp, tp = _jtree(params), _ttree(params)
    js, ts = jopt.init(jp), topt.init(tp)
    g_fn = jax.jit(jax.value_and_grad(_jax_classifier_loss, has_aux=True))
    for _ in range(2):
        (jl, _), jg = g_fn(jp, jnp.asarray(images), jnp.asarray(labels))
        for x in jax.tree_util.tree_leaves(tp):
            x.requires_grad_(True)
        tl, _ = _port_classifier_loss(tp, torch.tensor(images),
                                      torch.tensor(labels))
        tg = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tp),
            torch.autograd.grad(tl, jax.tree_util.tree_leaves(tp)))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
        _assert_trees_close(convert.params_to_numpy(tg), jg, rtol=1e-6,
                            atol=1e-9)
        jp, js, _ = jopt.update(jg, js, jp)
        with torch.no_grad():
            tp, ts, _ = topt.update(tg, ts,
                                    jax.tree_util.tree_map(torch.Tensor.detach,
                                                           tp))
    _assert_trees_close(convert.params_to_numpy(tp), jp, rtol=1e-5,
                        atol=1e-7)


def test_slice_end_to_end_cnf_density_and_score():
    """The serving computations: log-density and its x-gradient (a full
    reverse sweep), fused pnode dopri5, against the JAX package; fused and
    unfused bitwise inside the port; the plain lincomb calls as predicted."""
    th = _cnf_theta(dim=3, hidden=(16, 16, 16))
    x = np.random.RandomState(11).randn(8, 3)
    kw = dict(dt=0.2, n_steps=3, method="dopri5", adjoint="pnode")

    def jlp(xx):
        return jcnf.cnf_log_prob(jnets.cnf_vf, xx, _jtree(th), **kw)

    j_density, j_vjp = jax.jit(lambda xx: jax.vjp(jlp, xx))(jnp.asarray(x))
    (j_score,) = jax.jit(j_vjp)(jnp.ones_like(j_density))

    def port(fused):
        tx = torch.tensor(x, requires_grad=True)
        lp = tcnf.cnf_log_prob(tnets.cnf_vf, tx, _ttree(th),
                               fused_stages=fused, **kw)
        (score,) = torch.autograd.grad(lp.sum(), tx)
        return lp.detach(), score

    ops.reset_counts()
    density, score = port(True)
    assert ops.plain_calls == tadj.expected_lincomb_calls("dopri5", 3, 2,
                                                          "pnode")
    d_unf, s_unf = port(False)
    assert torch.equal(density, d_unf) and torch.equal(score, s_unf)
    np.testing.assert_allclose(density.numpy(), np.asarray(j_density),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(score.numpy(), np.asarray(j_score), rtol=RTOL,
                               atol=ATOL)
