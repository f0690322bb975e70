"""The port's stiff Robertson example (paper §5.3,
``repro_torch.examples.stiff_robertson``) against the JAX package's
``examples/stiff_robertson.py``: the beuler truth, and one CN and one
Dopri5 training epoch from the same seeded weights, in fp64 with x64 set
on both sides.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.core import implicit as jimp

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _x64_and_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with jax.enable_x64(True):
        yield
    torch.set_num_threads(prev)


def _reference_example():
    """``examples/stiff_robertson.py`` loaded as a module.  Its import turns
    x64 on for the process; the setting is put back afterwards."""
    prev = jax.config.jax_enable_x64
    spec = importlib.util.spec_from_file_location(
        "reference_stiff_robertson", ROOT / "examples" / "stiff_robertson.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_enable_x64", prev)
    return mod


def test_stiff_robertson_epoch0_matches_the_reference_example():
    """One CN and one Dopri5 epoch of the port's example at --device cpu,
    from the reference example's seeded weights, against the reference's
    epoch-0 loss and gradient norm (its losses, jitted, on the same
    truth) within 1e-8 relative."""
    from repro.core.adaptive import odeint_adaptive
    from repro.models.ode_nets import mlp_vf, mlp_vf_init
    from repro_torch import convert
    from repro_torch.examples import stiff_robertson as trob

    ref = _reference_example()
    ts, y = ref.robertson_truth(20)
    _, y_port = trob.robertson_truth(20)
    np.testing.assert_allclose(y_port, y, rtol=1e-10, atol=1e-15)
    lo, hi = y.min(axis=0), y.max(axis=0)
    y_s = (y - lo) / (hi - lo + 1e-12)
    y0, target = jnp.asarray(y_s[0]), jnp.asarray(y_s)
    theta = mlp_vf_init(jax.random.PRNGKey(0), 3, hidden=32, n_hidden=3)
    n_obs = len(ts)

    def loss_cn(p):
        us, u = [], y0
        for k in range(n_obs - 1):
            u = jimp.odeint_implicit(mlp_vf, u, p, dt=0.5, n_steps=2,
                                     t0=float(k), **trob.CN_KW)
            us.append(u)
        return jnp.mean(jnp.abs(jnp.stack([y0] + us) - target))

    def loss_dopri(p):
        us, u = [], y0
        for k in range(n_obs - 1):
            u, _ = odeint_adaptive(mlp_vf, u, p, t0=float(k),
                                   t1=float(k + 1), rtol=1e-6, atol=1e-6,
                                   max_steps=512)
            us.append(u)
        return jnp.mean(jnp.abs(jnp.stack([y0] + us) - target))

    tth = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, theta),
                                  device="cpu")
    out = trob.run(1, device="cpu", theta=tth, log=lambda *_: None)
    assert not any(s.diverged for s in out["cn_stats"])
    for key, fn in (("cn", loss_cn), ("dopri5", loss_dopri)):
        loss, g = jax.jit(jax.value_and_grad(fn))(theta)
        gn = float(jnp.sqrt(sum(jnp.sum(x ** 2)
                                for x in jax.tree_util.tree_leaves(g))))
        np.testing.assert_allclose(out[key]["losses"][0], float(loss),
                                   rtol=1e-8)
        np.testing.assert_allclose(out[key]["gnorms"][0], gn, rtol=1e-8)
        for a, b in zip(pytree.tree_leaves(out[key]["grads0"]),
                        jax.tree_util.tree_leaves(g)):
            assert a.dtype == torch.float32 and b.dtype == jnp.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6 * np.abs(b).max())


def _quick_truth(n_pts, device="cpu", capture=False):
    """A stand-in for the beuler truth (about 15 s on the CPU): the plan
    depends only on the state's shape and dtype."""
    s = np.linspace(0.0, 1.0, n_pts)
    return np.logspace(-5, 2, n_pts), np.stack(
        [1.0 - 0.3 * s, 3e-5 * np.sin(np.pi * s), 0.3 * s], axis=1)


def test_stiff_robertson_cli_refuses_mem_budget_and_needs_a_card(
        monkeypatch, capsys):
    """A 2000-byte budget plans pnode on the spill tier (the reference
    example's documented case): the CN solvers run it on the eager route
    (item 10a, logged) with the in-device plan's epoch 0, bitwise (the
    reference example's offload contract)."""
    from repro_torch.examples import stiff_robertson as trob
    monkeypatch.setattr(trob, "robertson_truth", _quick_truth)
    out = trob.main(["--epochs", "1", "--mem-budget", "2000", "--device",
                     "cpu"])
    assert (out["plan"].policy, out["plan"].offload) == ("pnode", "spill")
    assert "item 10a" in capsys.readouterr().out
    assert all(s.offload == "spill" and not s.masked
               for s in out["losses"].cn_solvers)
    ref = trob.main(["--epochs", "1", "--mem-budget", "400000", "--device",
                     "cpu"])
    assert out["cn"]["losses"] == ref["cn"]["losses"]
    assert out["cn"]["gnorms"] == ref["cn"]["gnorms"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trob.main(["--epochs", "1"])


def test_stiff_robertson_cli_mem_budget_prints_the_references_plan(
        monkeypatch, capsys):
    """``--mem-budget 400000`` prints the reference example's plan line
    (its ``plan_odeint`` call on its own weights and state) and trains
    under that policy: epoch 0 equals the policy passed explicitly."""
    from repro.mem.planner import plan_odeint
    from repro.models.ode_nets import mlp_vf, mlp_vf_init
    from repro_torch.examples import stiff_robertson as trob
    monkeypatch.setattr(trob, "robertson_truth", _quick_truth)
    plan = plan_odeint(mlp_vf, jnp.zeros(3),
                       mlp_vf_init(jax.random.PRNGKey(0), 3, hidden=32,
                                   n_hidden=3), dt=0.5, n_steps=2,
                       method="cn", mem_budget=400000, verify="model",
                       solver_opts=dict(newton_iters=6, gmres_iters=10))
    line = (f"planner @ 400000 bytes: policy={plan.policy} "
            f"ncheck={plan.ncheck} offload={plan.offload} "
            f"predicted_peak={plan.predicted.peak_bytes}B "
            f"NFE-B={plan.extra_fevals} fits={plan.fits}")
    out = trob.main(["--epochs", "1", "--mem-budget", "400000", "--device",
                     "cpu"])
    assert line in capsys.readouterr().out.splitlines()
    assert (out["plan"].policy, out["plan"].ncheck) == (plan.policy,
                                                        plan.ncheck)
    assert all(s.policy == plan.policy and s.ncheck == plan.ncheck
               for s in out["losses"].cn_solvers)
    ref = trob.run(1, device="cpu", adjoint=plan.policy, ncheck=plan.ncheck,
                   log=lambda *_: None)
    assert out["cn"]["losses"] == ref["cn"]["losses"]
