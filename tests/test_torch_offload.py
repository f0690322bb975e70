"""The port's checkpoint stores (``repro_torch.mem.offload``) and the
solvers' offload tiers, held against the port's own device tier BITWISE
and against the JAX package (``repro.mem.offload`` and its solvers) on
shared fp64 inputs made with numpy from a seed.

- Gradients: every tier equals the device tier bitwise (the stores move
  bytes, never arithmetic), and is within the tolerance of the JAX
  package's same call that the port's parity tests use for that solver
  (``test_torch_core.py``: rtol 1e-10 / atol 1e-12; ``test_torch_implicit
  .py``: 1e-8 / 1e-10; ``test_torch_adaptive.py``: 1e-10 / 1e-12).  The
  JAX package's host tier does not run on jax 0.9 (``TransferToMemoryKind``
  is gone), so the port's host tier is held against its device tier.
- Counters: the transfers, slots and bytes of ``spill_stats()`` equal the
  JAX package's for the same N_t and segment (payloads under its 96 KiB
  callback cap, where it does not chunk) and
  ``mem/model.py::spill_callback_counts``.  ``free_cb`` is not compared:
  XLA drops the reference's last free, whose token nothing reads.
- The store: the ``snaps_in_ram`` routing, zero-filled missing slots, a
  prefetch issued before a rewrite serving the bytes of its issue, the
  disk files (stale sweep, clean-up at GC), bf16 and fp64 round trips and
  the crc32 of a slot equal to the JAX package's.
"""
import gc
import glob
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as jad
from repro.core import adjoint as jadj
from repro.core import implicit as jimp
from repro.mem import model as jmodel
from repro.mem import offload as joff
from repro_torch.core import adaptive as tad
from repro_torch.core import adjoint as tadj
from repro_torch.core import implicit as timp
from repro_torch.mem import model as tmodel
from repro_torch.mem import offload as toff

D = 6
N = 7
DT = 0.05
ODE_TOL = dict(rtol=1e-10, atol=1e-12)
IMP_TOL = dict(rtol=1e-8, atol=1e-10)
ADA = dict(t0=0.0, t1=2.0, rtol=1e-7, atol=1e-7, max_steps=64)


@pytest.fixture(autouse=True, scope="module")
def _x64():
    # set globally, not by the thread-local context manager: the JAX
    # package's spill callbacks run on XLA's threads, which would not see
    # it (revolve2's and the adaptive ring's reads then return fp32)
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _problem_np(seed=7):
    rs = np.random.RandomState(seed)
    return rs.randn(D), {"W": 0.4 * rs.randn(D, D), "b": 0.1 * rs.randn(D)}


def _jf(u, th, t):
    return jnp.tanh(th["W"] @ u + th["b"]) - 0.2 * u + 0.05 * jnp.cos(t) * u


def _tf(u, th, t):
    return torch.tanh(th["W"] @ u + th["b"]) - 0.2 * u \
        + 0.05 * torch.cos(torch.as_tensor(t, dtype=u.dtype)) * u


def _jf_pulse(u, th, t):
    return (jnp.tanh(th["W"] @ u + th["b"]) - 0.2 * u
            + 4.0 * jnp.exp(-((t - 1.0) / 0.05) ** 2) * jnp.tanh(u))


def _tf_pulse(u, th, t):
    return (torch.tanh(th["W"] @ u + th["b"]) - 0.2 * u
            + 4.0 * torch.exp(-((t - 1.0) / 0.05) ** 2) * torch.tanh(u))


def _t(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _t(v, grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), dtype=torch.float64,
                        requires_grad=grad)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _grads_of(solve, u0n, thn):
    """(u_final, [d/du0, d/dW, d/db]) of sum(u_final**2), the port's."""
    u, p = _t(u0n, True), _t(thn, True)
    uf = solve(u, p)
    g = torch.autograd.grad(torch.sum(uf ** 2), [u, p["W"], p["b"]])
    return uf.detach().numpy(), [x.numpy() for x in g]


def _jax_grads_of(solve, u0n, thn):
    def loss(u, p):
        uf = solve(u, p)
        return jnp.sum(uf ** 2), uf

    (_, uf), (gu, gth) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(_j(u0n), _j(thn))
    return np.asarray(uf), [np.asarray(gu), np.asarray(gth["W"]),
                            np.asarray(gth["b"])]


def _assert_bitwise(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)


def _assert_close(a, b, tol):
    np.testing.assert_allclose(a[0], b[0], **tol)
    for x, y in zip(a[1], b[1]):
        np.testing.assert_allclose(x, y, **tol)


# ---------------------------------------------------------------------------
# odeint: pnode's segmented sweeps, the revolve schedules' slots
# ---------------------------------------------------------------------------

ODEINT_CASES = [
    ("pnode", None, dict(offload="spill")),
    ("pnode", None, dict(offload="disk")),
    ("pnode", None, dict(offload="spill", snaps_in_ram=2)),
    ("pnode", None, dict(offload="spill", offload_segment=2,
                         fused_stages=True)),
    ("revolve", 3, dict(offload="host")),
    ("revolve", 3, dict(offload="spill")),
    ("revolve", 3, dict(offload="disk")),
    ("revolve2", 3, dict(offload="host")),
    ("revolve2", 3, dict(offload="spill")),
    ("revolve2", 3, dict(offload="disk")),
]


def _odeint_ids():
    return [f"{p}-" + "-".join(f"{k}={v}" for k, v in kw.items())
            for p, _, kw in ODEINT_CASES]


@pytest.mark.parametrize("policy,ncheck,kw", ODEINT_CASES,
                         ids=_odeint_ids())
def test_odeint_tiers_bitwise_the_device_tier_and_close_to_jax(policy,
                                                               ncheck, kw):
    u0n, thn = _problem_np()

    def port(**k):
        return _grads_of(lambda u, p: tadj.odeint(
            _tf, u, p, dt=DT, n_steps=N, adjoint=policy, ncheck=ncheck,
            **k), u0n, thn)

    _assert_bitwise(port(**kw), port(
        fused_stages=kw.get("fused_stages", False)))
    jkw = {k: v for k, v in kw.items() if k != "fused_stages"}
    if jkw.get("offload") == "host":
        jkw.pop("offload")  # the JAX host tier does not run on jax 0.9
    ref = _jax_grads_of(lambda u, p: jadj.odeint(
        _jf, u, p, dt=DT, n_steps=N, adjoint=policy, ncheck=ncheck, **jkw),
        u0n, thn)
    _assert_close(port(**kw), ref, ODE_TOL)


STAT_KEYS = ("write_cb", "read_cb", "write_slots", "read_slots",
             "write_bytes", "read_bytes", "dispatch_cb", "prefetch_hit_cb",
             "disk_write_bytes", "disk_read_bytes", "ram_bytes_peak")


@pytest.mark.parametrize("policy,ncheck,kw", [
    ("pnode", None, dict(offload="spill")),
    ("pnode", None, dict(offload="disk", offload_segment=2)),
    ("pnode", None, dict(offload="spill", snaps_in_ram=2)),
    ("revolve", 3, dict(offload="spill")),
    ("revolve2", 3, dict(offload="disk"))],
    ids=["pnode-spill", "pnode-disk-seg2", "pnode-split", "revolve-spill",
         "revolve2-disk"])
def test_spill_stats_equal_the_references(policy, ncheck, kw):
    """Transfers, slots and bytes of one gradient, the JAX package's and
    the cost model's; pnode makes 2 ceil(N_t / segment) transfers."""
    u0n, thn = _problem_np()
    joff.reset_spill_stats()
    _jax_grads_of(lambda u, p: jadj.odeint(
        _jf, u, p, dt=DT, n_steps=N, adjoint=policy, ncheck=ncheck, **kw),
        u0n, thn)
    want = joff.spill_stats()
    toff.reset_spill_stats()
    _grads_of(lambda u, p: tadj.odeint(
        _tf, u, p, dt=DT, n_steps=N, adjoint=policy, ncheck=ncheck, **kw),
        u0n, thn)
    got = toff.spill_stats()
    assert {k: got[k] for k in STAT_KEYS} == {k: want[k] for k in STAT_KEYS}
    seg = kw.get("offload_segment")
    counts = tmodel.spill_callback_counts(policy, N, ncheck=ncheck,
                                          segment=seg)
    assert counts == jmodel.spill_callback_counts(policy, N, ncheck=ncheck,
                                                  segment=seg)
    if policy == "pnode":
        n_seg = math.ceil(N / (seg or tmodel.default_segment(N)))
        assert (got["write_cb"], got["read_cb"]) == (n_seg, n_seg) == (
            counts["forward"], counts["backward"])
    else:
        assert got["write_cb"] + got["read_cb"] + got["free_cb"] == \
            counts["total"]


def test_a_second_reverse_sweep_raises_as_on_the_device_tier():
    u0n, thn = _problem_np()
    u, p = _t(u0n, True), _t(thn, True)
    uf = tadj.odeint(_tf, u, p, dt=DT, n_steps=N, offload="spill")
    loss = torch.sum(uf ** 2)
    torch.autograd.grad(loss, [u], retain_graph=True)
    with pytest.raises(RuntimeError, match="ran twice"):
        torch.autograd.grad(loss, [u])


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def _rows(n, scale=1.0):
    return torch.arange(2.0 * n, dtype=torch.float64).reshape(n, 2) * scale


def test_slot_census_routes_as_the_reference():
    """snaps_in_ram=3: a batch of 3 stays in RAM, the next batch of 4
    overflows whole to one disk file (the reference's
    tests/test_multitier.py census)."""
    ref = joff.make_store("spill", snaps_in_ram=3)
    tok = ref.init_token()
    tok = ref.write_batch(tok, 0, jnp.ones((3, 2)))
    tok = ref.write_batch(tok, 3, jnp.ones((4, 2)) * 2)
    jax.block_until_ready(tok)
    st = toff.make_store("spill", snaps_in_ram=3)
    st.write_batch(0, torch.ones(3, 2, dtype=torch.float64))
    st.write_batch(3, torch.ones(4, 2, dtype=torch.float64) * 2)
    assert st.slot_census() == ref.slot_census() == \
        {"ram": 3, "disk": 4, "disk_files": 1}
    assert bool((st.prefetch(3, 4) == 2.0).all())
    st.free(0)
    assert st.slot_census() == {"ram": 2, "disk": 4, "disk_files": 1}


def test_missing_slots_read_as_zeros_and_fail_a_checked_read():
    st = toff.make_store("disk", integrity=True)
    st.write_batch(0, _rows(5))
    assert torch.equal(st.prefetch(0, 4), _rows(5)[:4])
    tail = st.prefetch(4, 4)
    assert torch.equal(tail[0], _rows(5)[4]) and bool((tail[1:] == 0).all())
    ok, _ = st.prefetch_checked(0, 5)
    assert ok and st.stats["integrity_fail"] == 0
    ok, _ = st.prefetch_checked(3, 4)
    assert not ok and st.stats["integrity_fail"] == 2


def test_an_issued_prefetch_serves_the_bytes_of_its_issue():
    st = toff.make_store("spill")
    st.write_batch(0, _rows(4))
    st.prefetch_issue(0, 4)
    st.write_batch(0, _rows(4, 100.0))  # rewritten after the issue
    assert torch.equal(st.prefetch(0, 4), _rows(4))
    assert (st.stats["dispatch_cb"], st.stats["prefetch_hit_cb"]) == (1, 1)
    assert torch.equal(st.prefetch(0, 4), _rows(4, 100.0))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64],
                         ids=["bf16", "fp64"])
def test_raw_bytes_round_trip_bitwise(dtype):
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)) \
        .to(dtype)
    st = toff.make_store("spill", integrity=True)
    st.write_batch(0, {"a": x, "b": -x})
    out = st.prefetch(0, 3)
    assert torch.equal(out["a"].view(torch.int16 if dtype == torch.bfloat16
                                     else torch.int64),
                       x.view(torch.int16 if dtype == torch.bfloat16
                              else torch.int64))
    assert torch.equal(out["b"], -x)
    st.put(7, (x[0], x[1]))
    assert all(torch.equal(a, b) for a, b in zip(st.pop(7), (x[0], x[1])))
    with pytest.raises(KeyError):
        st.get(7)
    if dtype == torch.float64:  # the reference's crc32 over the same bytes
        assert st._sums[1] == joff._crc_leaves(
            [x[1].numpy(), (-x)[1].numpy()])


def test_offload_dir_pins_files_and_sweeps_stale(tmp_path):
    stale = tmp_path / (toff._DISK_PREFIX + "deadbeef.npz")
    stale.write_bytes(b"not a real npz")
    st = toff.make_store("disk", disk_dir=str(tmp_path))
    assert st.swept_files == 1 and not stale.exists()
    u0n, thn = _problem_np()
    a = _grads_of(lambda u, p: tadj.odeint(
        _tf, u, p, dt=DT, n_steps=N, offload="disk",
        offload_dir=str(tmp_path)), u0n, thn)
    _assert_bitwise(a, _grads_of(lambda u, p: tadj.odeint(
        _tf, u, p, dt=DT, n_steps=N), u0n, thn))
    gc.collect()
    assert glob.glob(str(tmp_path / (toff._DISK_PREFIX + "*.npz"))) == []
    assert tmp_path.exists()


def test_disk_files_cleaned_up_on_store_gc(tmp_path):
    st = toff.make_store("disk", disk_dir=str(tmp_path))
    st.write_batch(0, _rows(4))
    assert len(glob.glob(str(tmp_path / (toff._DISK_PREFIX + "*.npz")))) \
        == 1
    own = toff.make_store("disk")
    own.write_batch(0, _rows(2))
    root = own._disk_dir
    assert len(glob.glob(root + "/" + toff._DISK_PREFIX + "*.npz")) == 1
    del st, own
    gc.collect()
    assert glob.glob(str(tmp_path / (toff._DISK_PREFIX + "*.npz"))) == []
    assert not glob.glob(root)


def test_host_store_degrades_to_the_device_tier_on_the_cpu():
    st = toff.make_store("host")
    assert (st.tier, st.requested_tier, st.effective_tier) == (
        "host", "host", "device")
    x = torch.ones(3)
    st.put(0, (x, 2 * x))
    a, b = st.pop(0)
    assert a is x and torch.equal(b, 2 * x) and st.copies == {"d2h": 0,
                                                               "h2d": 0}
    assert toff.HostStore().effective_tier == "device"


class _StubPlan:
    def __init__(self, down):
        self.down = set(down)

    def tier_disabled(self, tier):
        return tier in self.down


@pytest.mark.parametrize("down", [(), ("spill",), ("spill", "disk"),
                                  ("spill", "disk", "host"), ("disk",)],
                         ids=["none", "spill", "spill-disk",
                              "spill-disk-host", "disk"])
def test_effective_tier_walks_the_references_ladder(down):
    plan = _StubPlan(down)
    for tier in (None, "device", "host", "spill", "disk"):
        for scanned in (False, True):
            assert toff.effective_tier(tier, plan, scanned=scanned) == \
                joff.effective_tier(tier, plan, scanned=scanned)
    assert toff.effective_tier("spill", None) == "spill"


def test_fault_plan_and_obs_name_item_11():
    """Item 11's hooks run: a plan arms the spill store's sites, and a
    bound recorder sees the store's traffic."""
    from repro_torch.ft import FaultPlan, FaultSpec
    from repro_torch.obs import FlightRecorder
    plan = FaultPlan([FaultSpec("spill.read", 0, "flake")])
    st = toff.make_store("spill", fault_plan=plan, retry_backoff_s=0.0)
    assert st.fault_plan is plan
    rec = FlightRecorder()
    st.bind_obs(rec)
    x = torch.arange(6.0).reshape(2, 3)
    st.write_batch(0, x)
    assert torch.equal(st.prefetch(0, 2), x)
    assert plan.fired_count("spill.read", "flake") == 1
    assert [e.kind for e in rec.events()] == ["spill.write", "spill.retry",
                                              "spill.read"]


# ---------------------------------------------------------------------------
# the implicit eager route
# ---------------------------------------------------------------------------

IMPLICIT_CASES = [
    ("pnode", None, dict(offload="spill")),
    ("pnode", None, dict(offload="disk")),
    ("pnode", None, dict(offload="spill", resilient=True)),
    ("pnode", None, dict(offload="spill", snaps_in_ram=1,
                         offload_segment=2)),
    ("revolve", 1, dict(offload="spill")),
    ("revolve", 1, dict(offload="disk")),
    ("revolve2", 1, dict(offload="host")),
]


@pytest.mark.parametrize(
    "policy,ncheck,kw", IMPLICIT_CASES,
    ids=[f"{p}-" + "-".join(f"{k}={v}" for k, v in kw.items())
         for p, _, kw in IMPLICIT_CASES])
def test_implicit_tiers_bitwise_the_device_tier_and_close_to_jax(policy,
                                                                 ncheck, kw):
    u0n, thn = _problem_np(1)

    def port(**k):
        return _grads_of(lambda u, p: timp.odeint_implicit(
            _tf, u, p, dt=0.2, n_steps=4, method="cn", adjoint=policy,
            ncheck=ncheck, **k), u0n, thn)

    _assert_bitwise(port(**kw), port())
    jkw = {k: v for k, v in kw.items()
           if not (k == "offload" and v == "host")}
    ref = _jax_grads_of(lambda u, p: jimp.odeint_implicit(
        _jf, u, p, dt=0.2, n_steps=4, method="cn", adjoint=policy,
        ncheck=ncheck, **jkw), u0n, thn)
    _assert_close(port(**kw), ref, IMP_TOL)


@pytest.mark.parametrize("tier", ["spill", "disk"])
def test_resilient_recomputes_a_segment_corrupted_at_rest(tier,
                                                          monkeypatch):
    """A byte flipped in the RAM dict or in a segment file after the
    forward sweep: the checked read fails (``integrity_fail``), the
    segment is integrated again from its entry state, and the gradient is
    the clean run's, bitwise."""
    u0n, thn = _problem_np(1)
    stores = []
    make = toff.make_store

    def keep(*a, **k):
        stores.append(make(*a, **k))
        return stores[-1]

    def run(corrupt):
        u, p = _t(u0n, True), _t(thn, True)
        uf = timp.odeint_implicit(_tf, u, p, dt=0.2, n_steps=5,
                                  method="cn", offload=tier, resilient=True)
        if corrupt:
            st = stores[-1]
            st.sync()
            if tier == "spill":
                st._host[3][0][0] ^= 0xFF
            else:
                path = st._disk[3]
                with np.load(path) as z:
                    data = {k: z[k] for k in z.files}
                data["s3_l0"][0] ^= 0xFF
                np.savez(path, **data)
        g = torch.autograd.grad(torch.sum(uf ** 2), [u, p["W"], p["b"]])
        return uf.detach().numpy(), [x.numpy() for x in g]

    monkeypatch.setattr(toff, "make_store", keep)
    clean = run(False)
    toff.reset_spill_stats()
    _assert_bitwise(run(True), clean)
    assert stores[-1].stats["integrity_fail"] >= 1


def test_masked_implicit_form_with_offload_names_item_10a():
    for kw in (dict(capture=True), dict(lanes=True)):
        with pytest.raises(NotImplementedError, match="item 10a"):
            timp.ImplicitSolver(_tf, dt=0.2, n_steps=5, offload="spill",
                                **kw)


# ---------------------------------------------------------------------------
# the adaptive ring
# ---------------------------------------------------------------------------

def _adaptive(solver_kw, **kw):
    u0n, thn = _problem_np(3)
    solver = tad.AdaptiveSolver(_tf_pulse, **ADA, **solver_kw, **kw)
    out = _grads_of(lambda u, p: solver(u, p)[0], u0n, thn)
    return out, solver


@pytest.mark.parametrize("capture", [False, True], ids=["eager", "capture"])
@pytest.mark.parametrize("kw", [dict(offload="spill"), dict(offload="disk"),
                                dict(offload="spill", offload_segment=3,
                                     snaps_in_ram=4)],
                         ids=["spill", "disk", "spill-seg3-split"])
def test_adaptive_ring_tiers_bitwise_the_device_ring(kw, capture):
    dev, dev_solver = _adaptive(dict(capture=capture))
    toff.reset_spill_stats()
    got, solver = _adaptive(dict(capture=capture), **kw)
    _assert_bitwise(got, dev)
    seg = kw.get("offload_segment", tmodel.default_segment(ADA["max_steps"]))
    assert solver.segment == seg
    assert solver.ring_slots == seg + tad.CHECK_EVERY
    assert solver._ring["h"].shape[0] == seg + tad.CHECK_EVERY
    assert solver.ring_bytes * ADA["max_steps"] == \
        dev_solver.ring_bytes * (seg + tad.CHECK_EVERY)
    n_seg = math.ceil(solver._n_acc.item() / seg)
    st = toff.spill_stats()
    assert (st["write_cb"], st["read_cb"]) == (n_seg, n_seg) and n_seg > 1


@pytest.mark.parametrize("tier", ["spill", "disk"])
def test_adaptive_ring_tiers_close_to_jax(tier):
    u0n, thn = _problem_np(3)
    got = _grads_of(lambda u, p: tad.odeint_adaptive(
        _tf_pulse, u, p, offload=tier, **ADA)[0], u0n, thn)
    ref = _jax_grads_of(lambda u, p: jad.odeint_adaptive(
        _jf_pulse, u, p, offload=tier, **ADA)[0], u0n, thn)
    _assert_close(got, ref, ODE_TOL)
