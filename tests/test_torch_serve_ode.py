"""The port's ``ODEEngine`` (``repro_torch.serve``) and the lane keys of its
stores (``repro_torch.mem.offload``), on the CPU.

Against the JAX package's ``ODEEngine``: the same numpy weights
(``convert.params_from_jax``) and requests, density, score and classify
on the spill, disk and RAM/disk split tiers and on the adaptive path,
within ``JAX_TOL``.  The serve stack is fp32 on both sides; the JAX side
runs under ``jax.enable_x64(False)`` (other modules turn x64 on at
import).  ``JAX_TOL`` is fp32 rounding: XLA and PyTorch add the matmuls
and the trace in other orders (measured 2.4e-7 abs, 3.7e-7 rel).

Inside the port, bitwise, as ``tests/test_serve.py`` holds the JAX
package:

- (i) a request's result is the same bits whatever its batch-mates and
  its lane inside one bucket;
- (ii) the spill, disk and split tiers give the device tier's bits;
- (iv) a poisoned lane's batch-mates keep their bits;
- (v) a batched request equals the unbatched per-request solve.

(iii), a captured replay equal to eager, needs the card
(``tests/test_torch_gpu.py``); here ``StepGraph`` runs the device tier's
programs eagerly on its static buffers.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ode_nets import cnf_vf as j_cnf_vf
from repro.models.ode_nets import cnf_vf_init as j_cnf_vf_init
from repro.serve import BucketSpec as JBucketSpec
from repro.serve import ODEEngine as JODEEngine
from repro_torch.convert import params_from_jax
from repro_torch.core.adaptive import odeint_adaptive
from repro_torch.core.adjoint import odeint
from repro_torch.core.cnf import exact_trace_vf
from repro_torch.ft import FaultPlan, FaultSpec
from repro_torch.mem.offload import make_store
from repro_torch.mem.planner import plan_odeint
from repro_torch.models.ode_nets import cnf_vf
from repro_torch.obs import FlightRecorder, MetricsRegistry
from repro_torch.serve import BucketSpec, ODEEngine

# The JAX package's tests/test_implicit_mem.py draws its d = 6 problem from
# jax.random in x64 inside a hypothesis test with a 200 ms deadline, so the
# process that compiles those PRNG kernels first pays about 1.3 s inside
# that test's first example.  Which files share an xdist worker (and in
# what order) changes with every file added, and every worker imports this
# module at collection: compiling them here, inside the context manager
# (no flag is left set), keeps that compile out of its deadline whichever
# files ran before it.
with jax.enable_x64(True):
    _keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jax.block_until_ready((jax.random.normal(_keys[0], (6,)),
                           0.4 * jax.random.normal(_keys[1], (6, 6))))

DIM = 3
DT, N_STEPS, SEG = 0.1, 8, 4
JAX_TOL = dict(rtol=1e-5, atol=1e-6)
KINDS = ODEEngine.KINDS
TIERS = {"spill": dict(offload="spill"), "disk": dict(offload="disk"),
         "split": dict(offload="spill", snaps_in_ram=3)}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def np_theta():
    with jax.enable_x64(False):
        th = j_cnf_vf_init(jax.random.PRNGKey(0), DIM, hidden=(8, 8))
        return jax.tree_util.tree_map(lambda a: np.array(a), th)


@pytest.fixture(scope="module")
def theta(np_theta):
    return params_from_jax(np_theta, device="cpu")


@pytest.fixture(scope="module")
def xs():
    return np.random.default_rng(7).normal(size=(5, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def head_w():
    return np.random.default_rng(0).normal(size=(DIM, 2)).astype(np.float32)


def _engine(theta, head_w=None, **kw):
    kw.setdefault("offload_segment", SEG)
    if head_w is not None:
        w = torch.from_numpy(head_w)
        kw["head"] = lambda u: u @ w
    return ODEEngine(cnf_vf, theta, dim=DIM, dt=DT, n_steps=N_STEPS,
                     device="cpu", **kw)


def _serve(eng, xs, kinds=KINDS):
    """Every kind on ``xs`` (one batch a kind); {kind: [result]}."""
    tickets = {k: [eng.submit(k, x) for x in xs] for k in kinds}
    eng.run()
    return {k: [np.asarray(t.result(5)) for t in ts]
            for k, ts in tickets.items()}


#: the kinds each tier is served, here and in the JAX engine: the score is
#: the only kind whose checkpoints go through a store (density and classify
#: run forward only), so the other tiers serve it alone
TIER_KINDS = {"spill": KINDS, "disk": ("score",), "split": ("score",)}
ADAPTIVE = dict(offload="spill", adaptive=True, max_steps=64)


@pytest.fixture(scope="module")
def jax_results(np_theta, xs, head_w):
    """The JAX engine's results by tier (and "adaptive", on two points),
    bucket 4 (one padding lane)."""
    out = {}
    with jax.enable_x64(False):
        th = jax.tree_util.tree_map(jnp.asarray, np_theta)
        w = jnp.asarray(head_w)
        cases = dict(TIERS, adaptive=ADAPTIVE)
        for name, kw in cases.items():
            eng = JODEEngine(j_cnf_vf, th, dim=DIM, dt=DT, n_steps=N_STEPS,
                             offload_segment=SEG, buckets=JBucketSpec((4,)),
                             head=lambda u: u @ w, **kw)
            out[name] = (_serve(eng, xs[:2], KINDS) if name == "adaptive"
                         else _serve(eng, xs[:3], TIER_KINDS[name]))
    return out


@pytest.fixture(scope="module")
def tier_results(theta, xs, head_w, tmp_path_factory):
    """The port's engine on the first three points by tier (None: the
    device tier), bucket 4, each engine closed after its batches; with the
    census after them.  Filled on first use."""
    cache = {}

    def get(tier):
        if tier not in cache:
            kw = TIERS[tier] if tier is not None else dict(offload=None)
            spool = str(tmp_path_factory.mktemp(f"spool-{tier}"))
            with _engine(theta, head_w, buckets=BucketSpec((4,)),
                         spool_dir=spool, **kw) as eng:
                got = _serve(eng, xs[:3], TIER_KINDS.get(tier, KINDS))
                cache[tier] = (got, eng.slot_census(), len(eng._fns))
        return cache[tier]
    return get


# -- per-request references (unbatched, the port's own solves) -------------

def _aug():
    return exact_trace_vf(cnf_vf, DIM)


def _logp_one(theta, x, **kw):
    """log p of one request solved alone, as a (1, DIM) state."""
    z, dl = odeint(_aug(), (x[None], torch.zeros(1)), theta, dt=DT,
                   n_steps=N_STEPS, method="rk4", adjoint="pnode", **kw)
    return (-0.5 * torch.sum(z ** 2, dim=-1)
            - 0.5 * DIM * math.log(2 * math.pi) + dl)[0]


def _density_one(theta, x):
    with torch.no_grad():
        return _logp_one(theta, torch.from_numpy(x)).numpy()


def _score_one(theta, x):
    xt = torch.from_numpy(x).requires_grad_(True)
    return torch.autograd.grad(_logp_one(theta, xt), xt)[0].numpy()


def _classify_one(theta, x, head_w):
    with torch.no_grad():
        u = odeint(cnf_vf, torch.from_numpy(x)[None], theta, dt=DT,
                   n_steps=N_STEPS, method="rk4", adjoint="pnode")
        return (u @ torch.from_numpy(head_w))[0].numpy()


@pytest.fixture(scope="module")
def refs(theta, xs, head_w):
    """Each of the first three requests solved alone, every kind."""
    return {"density": [_density_one(theta, x) for x in xs[:3]],
            "score": [_score_one(theta, x) for x in xs[:3]],
            "classify": [_classify_one(theta, x, head_w) for x in xs[:3]]}


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b)) and \
        len(a) == len(b)


# -- parity with the JAX engine -----------------------------------------------

@pytest.mark.parametrize("tier", sorted(TIERS))
def test_engine_matches_the_jax_engine(jax_results, tier_results, tier):
    got, census, _ = tier_results(tier)
    assert not any(census.values()), census
    for kind in TIER_KINDS[tier]:
        np.testing.assert_allclose(np.stack(got[kind]),
                                   np.stack(jax_results[tier][kind]),
                                   err_msg=kind, **JAX_TOL)


def test_adaptive_engine_matches_the_jax_engine(theta, xs, head_w,
                                                jax_results):
    with _engine(theta, head_w, **ADAPTIVE) as eng:
        got = _serve(eng, xs[:2])
        assert not any(eng.slot_census().values())
    for kind in KINDS:
        np.testing.assert_allclose(np.stack(got[kind]),
                                   np.stack(jax_results["adaptive"][kind]),
                                   err_msg=kind, **JAX_TOL)


# -- bitwise inside the port --------------------------------------------------

@pytest.mark.parametrize("tier", [None] + sorted(TIERS))
def test_engine_bitwise_fixed(refs, tier_results, tier):
    """(ii) the tier equals the device tier, (v) both equal the unbatched
    per-request solve, bit for bit, with a padding lane in the bucket; the
    census is empty after the batch."""
    device, _, _ = tier_results(None)
    got, census, n_fns = tier_results(tier)
    assert not any(census.values()), census
    assert n_fns == len(got)
    for kind in got:
        assert _same(got[kind], device[kind]), kind
        assert _same(got[kind], refs[kind]), kind


def test_engine_bitwise_across_compositions_and_lanes(theta, xs, refs):
    """(i) one program serves changing compositions: two rounds through
    the (score, 2) program, the second one lane and a padding lane, then
    the points again in reverse order with other batch-mates and lanes,
    each bitwise the request alone."""
    refs = refs["score"]
    with _engine(theta, offload="spill", buckets=BucketSpec((2,))) as eng:
        for lo, hi in ((0, 2), (2, 3)):
            ts = [eng.submit("score", x) for x in xs[lo:hi]]
            eng.run()
            assert _same([t.result(5) for t in ts], refs[lo:hi])
        order = [2, 1, 0]
        ts = [eng.submit("score", xs[i]) for i in order]
        eng.run()
        assert _same([t.result(5) for t in ts], [refs[i] for i in order])
        assert len(eng._fns) == 1
        assert not any(eng.slot_census().values())


def test_engine_bitwise_adaptive(theta, xs):
    """The adaptive path equals direct single-lane solves, and the
    captured route (``StepGraph``'s CPU behaviour) the eager one."""
    aug, t1 = _aug(), DT * N_STEPS
    kw = dict(t0=0.0, t1=t1, rtol=1e-6, atol=1e-6, max_steps=64,
              offload="spill", offload_segment=SEG)

    def logp(x):
        (z, dl), _ = odeint_adaptive(aug, (x, torch.zeros(())), theta, **kw)
        return (-0.5 * torch.sum(z ** 2) - 0.5 * DIM * math.log(2 * math.pi)
                + dl)

    outs = []
    for capture in (False, True):
        with _engine(theta, capture=capture, **ADAPTIVE) as eng:
            outs.append(_serve(eng, xs[:1], kinds=("density", "score")))
    assert all(_same(outs[0][k], outs[1][k]) for k in outs[0])
    for x, d, s in zip(xs[:1], outs[0]["density"], outs[0]["score"]):
        xt = torch.from_numpy(x).requires_grad_(True)
        lp = logp(xt)
        (g,) = torch.autograd.grad(lp, xt)
        assert np.array_equal(d, np.atleast_1d(lp.detach().numpy()))
        assert np.array_equal(s, g.numpy())


def test_engine_classify_head(theta, xs, head_w):
    """The forward-only kinds write no checkpoint; the lane-keyed spill
    store perturbs no logit: they equal the batched no-offload program."""
    x = torch.from_numpy(xs[:2])
    with torch.no_grad():
        u = odeint(cnf_vf, x, theta, dt=DT, n_steps=N_STEPS, method="rk4",
                   adjoint="pnode")
        ref = (u @ torch.from_numpy(head_w)).numpy()
    with _engine(theta, head_w, offload="spill",
                 buckets=BucketSpec((2,))) as eng:
        got = _serve(eng, xs[:2], kinds=("classify", "density"))
        store = eng._store(2)
        assert store.stats["write_cb"] == 0 and store.stats["read_cb"] == 0
    assert _same(got["classify"], list(ref))


def test_callbacks_independent_of_lane_count(theta, xs):
    """Host transfers a solve are O(n_steps / segment) however many
    requests share the batch, so the per-request count falls as occupancy
    grows."""
    n_seg = math.ceil(N_STEPS / SEG)

    def run(n_req):
        reg = MetricsRegistry()
        with _engine(theta, offload="spill", buckets=BucketSpec((4,)),
                     registry=reg) as eng:
            eng.warmup(kinds=("score",))
            store = eng._store(4)
            before = dict(store.stats)
            for x in xs[:n_req]:
                eng.submit("score", x)
            eng.run()
            delta = {k: store.stats[k] - before.get(k, 0)
                     for k in ("write_cb", "read_cb", "dispatch_cb")}
        return delta, reg.histogram("serve.callbacks_per_request")

    (solo, h1), (batched, h4) = run(1), run(4)
    assert batched == solo
    assert solo["write_cb"] == n_seg
    assert solo["read_cb"] + solo["dispatch_cb"] <= 2 * (n_seg + 1)
    assert h4["sum"] / h4["count"] == pytest.approx(
        h1["sum"] / h1["count"] / 4)


def test_poisoned_lane_fails_alone(theta, xs, refs):
    """(iv) ``serve.decode`` poisons the first real lane: its ticket fails,
    its batch-mates keep their bits, every lane's slots are freed, and the
    metrics and events count it."""
    refs = refs["score"]
    reg, rec = MetricsRegistry(), FlightRecorder()
    with _engine(theta, offload="spill", buckets=BucketSpec((4,)),
                 registry=reg, obs=rec,
                 fault_plan=FaultPlan([FaultSpec("serve.decode", 0, "nan")])
                 ) as eng:
        ts = [eng.submit("score", x) for x in xs[:3]]
        eng.run()
        with pytest.raises(RuntimeError, match="non-finite"):
            ts[0].result(5)
        assert _same([t.result(5) for t in ts[1:]], refs[1:])
        assert not any(eng.slot_census().values())
    assert reg.counter("serve.errors") == 1
    assert reg.counter("serve.completed") == 2
    assert reg.histogram("serve.batch_occupancy")["sum"] == 0.75
    assert reg.histogram("serve.batch_wall_s")["count"] == 1
    (batch,) = rec.events("serve.batch")
    assert batch.data["lanes"] == 3 and batch.data["bucket"] == 4
    assert batch.data["callbacks"] > 0
    assert rec.events("spill.write") and rec.events("queue.schedule")
    assert {e.data["request"] for e in rec.events("spill.free_request")} \
        == {t.rid for t in ts}


# -- the stores' lane keys ------------------------------------------------------

def test_departure_frees_slots(theta, xs):
    """A lane-keyed batched gradient with the store kept: each departure
    frees exactly its own slots; padding lanes stored nothing."""
    store = make_store("spill")
    store.lane_keys = ("req-a", "req-b", None)
    x = torch.from_numpy(xs[:3]).requires_grad_(True)
    z, dl = odeint(_aug(), (x, torch.zeros(3)), theta, dt=DT,
                   n_steps=N_STEPS, method="rk4", adjoint="pnode",
                   offload="spill", offload_segment=SEG, offload_store=store)
    lp = -0.5 * torch.sum(z ** 2, dim=-1) + dl
    (g,) = torch.autograd.grad(lp.sum(), x)
    assert torch.isfinite(g[:2]).all()
    assert store.slot_census()["ram"] == 2 * N_STEPS
    assert store.request_slots("req-a") == N_STEPS
    assert store.free_request("req-a") == N_STEPS
    assert store.request_slots("req-a") == 0
    assert store.request_slots("req-b") == N_STEPS  # batch-mate untouched
    store.free_request("req-b")
    assert not any(store.slot_census().values())
    assert store.free_request(None) == 0
    store.close()


@pytest.mark.parametrize("tier", ["spill", "disk"])
def test_keyed_block_round_trips_with_padding_zero(tier, tmp_path):
    """A (seg, B, ...) block with a padding lane: per-lane rows keyed
    (request, slot), the padding lane stores nothing and reads back as
    zeros, the other lanes' bytes come back bitwise (stage-stacked leaves
    carry the lane axis second); a segment file goes with its last slot."""
    rng = np.random.default_rng(3)
    seg, s = 4, 2
    state = torch.from_numpy(rng.normal(size=(seg, 3, 5)))
    stages = torch.from_numpy(rng.normal(size=(seg, s, 3, 5))
                              .astype(np.float32))
    store = make_store(tier, disk_dir=str(tmp_path))
    store.lane_keys = ("a", None, "b")
    store.write_batch(8, (state, stages), lane_axes=(0, 1))
    census = store.slot_census()
    assert census["ram" if tier == "spill" else "disk"] == 2 * seg
    store.prefetch_issue(8, seg)
    got_state, got_stages = store.prefetch(8, seg)
    for b in (0, 2):
        assert torch.equal(got_state[:, b], state[:, b])
        assert torch.equal(got_stages[:, :, b], stages[:, :, b])
    assert not got_state[:, 1].any() and not got_stages[:, :, 1].any()
    ok, _ = store.prefetch_checked(8, seg)
    assert ok and store.stats["prefetch_hit_cb"] == 1
    assert store.free_request("a") == seg
    assert store.slot_census()["disk_files"] == (tier == "disk")
    assert store.free_request("b") == seg
    assert not any(store.slot_census().values())
    store.close()


def test_check_lanes_errors():
    store = make_store("spill")
    store.lane_keys = ("a", "b")
    with pytest.raises(ValueError, match="entries but the mapped batch"):
        store.write_batch(0, (torch.zeros(2, 3, 4),))
    with pytest.raises(ValueError, match="exactly one mapped batch axis"):
        store.write_batch(0, (torch.zeros(2),))  # a 0-d state leaf
    store.lane_keys = None
    store.write_batch(0, (torch.zeros(2),))  # unkeyed: any layout
    assert store.slot_census()["ram"] == 2
    store.close()


# -- planner, programs, refusals ------------------------------------------------

def test_engine_planner_integration(theta, xs, refs):
    """A budget routes through ``plan_odeint(batch=max bucket)`` and still
    serves bitwise results."""
    with _engine(theta, ram_budget=1, buckets=BucketSpec((2,))) as eng:
        proto = (torch.zeros(DIM), torch.zeros(()))
        plan = plan_odeint(_aug(), proto, theta, dt=DT, n_steps=N_STEPS,
                           method="rk4", ram_budget=1, verify="model",
                           batch=2)
        assert eng.plan == plan
        assert eng.plan.policy == "pnode" and eng.offload == "disk"
        tk = eng.submit("score", xs[0])
        eng.run()
        assert np.array_equal(tk.result(5), refs["score"][0])


def test_compile_cache_bounded(theta, xs):
    with _engine(theta, offload="spill", buckets=BucketSpec((1, 2))) as eng:
        assert eng.warmup() == len(KINDS) * 2
        assert not any(eng.slot_census().values())
        for i in range(3):
            eng.submit("density", xs[i % len(xs)])
            eng.run()
        assert len(eng._fns) <= len(KINDS) * 2


def test_engine_refuses_other_tiers_and_defaults_to_the_card(theta):
    with pytest.raises(ValueError, match="lane-keyed spill/disk"):
        _engine(theta, offload="host")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ODEEngine(cnf_vf, theta, dim=DIM, dt=DT, n_steps=N_STEPS)
