"""The port's observability layer (``repro_torch.obs``) held against the
JAX package's ``repro.obs`` on the CPU, and bitwise-neutral inside the
port.

- With a ``FlightRecorder`` attached, gradients are bitwise those without,
  across the 8 explicit policies x the device, host, spill and disk tiers
  where valid, the implicit policies x their tiers, and the adaptive
  solver eager and through ``StepGraph`` (``capture=True``, eager on the
  CPU).
- The recorder's views match the JAX package's on the same solves: the
  spill traffic per segment base (bytes, slots and transfers: the sizes
  stay under the JAX package's 96 KiB callback cap, so its callbacks are
  one a transfer), the implicit steps, the adaptive attempt sequence.
- ``to_chrome_trace``, ``check_against_baseline`` and ``MetricsRegistry``
  give the JAX package's outputs on the same inputs.
- ``JitCounter`` counts on the device and keeps its counter's address
  across resets; ``scope`` frames show under ``torch.profiler``.

The shared problem is the JAX package's ``tests/test_obs.py`` size:
``f = -th * u``, ``U0 = ones(3)``, fp64, N_t 16, segment 4.
"""
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.adjoint import odeint as j_odeint
from repro.core.implicit import odeint_implicit as j_implicit
from repro.obs import FlightRecorder as JRecorder
from repro.obs import baseline as j_baseline
from repro.obs import registry as j_registry
from repro.obs import trace_export as j_export
from repro_torch.core.adaptive import AdaptiveSolver
from repro_torch.core.adjoint import POLICIES, odeint
from repro_torch.core.implicit import odeint_implicit
from repro_torch.mem.offload import reset_spill_stats, spill_stats
from repro_torch.obs import (BaselineRef, FevalCounter, FlightRecorder, Gate,
                             JitCounter, MetricsRegistry, MetricsSink,
                             check_against_baseline, export_chrome_trace,
                             scope, to_chrome_trace)
from repro_torch.obs.trace_export import read_events

N_STEPS, SEG, DT, TH = 16, 4, 0.05, 0.7


@pytest.fixture(autouse=True, scope="module")
def _x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _f(u, th, t):
    return -th * u


def _inputs():
    return (torch.ones(3, dtype=torch.float64, requires_grad=True),
            torch.tensor(TH, dtype=torch.float64, requires_grad=True))


def _explicit(obs=None, **kw):
    u0, th = _inputs()
    uf = odeint(_f, u0, th, dt=DT, n_steps=N_STEPS, obs=obs, **kw)
    return torch.autograd.grad(torch.sum(uf ** 2), [u0, th])


def _implicit(obs=None, **kw):
    u0, th = _inputs()
    uf = odeint_implicit(_f, u0, th, dt=DT, n_steps=N_STEPS, method="cn",
                         newton_iters=8, newton_tol=1e-12, obs=obs, **kw)
    return torch.autograd.grad(torch.sum(uf ** 2), [u0, th])


#: (policy, ncheck, tier): every policy on the device, and the tiers each
#: takes (pnode: spill and disk; revolve and revolve2: host, spill, disk)
EXPLICIT = ([(p, 4 if p.startswith("revolve") else None, None)
             for p in POLICIES]
            + [("pnode", None, t) for t in ("spill", "disk")]
            + [(p, 4, t) for p in ("revolve", "revolve2")
               for t in ("host", "spill", "disk")])


@pytest.mark.parametrize("policy,ncheck,tier", EXPLICIT,
                         ids=[f"{p}-{t or 'device'}" for p, _, t in EXPLICIT])
def test_obs_bitwise_explicit(policy, ncheck, tier):
    kw = dict(adjoint=policy, ncheck=ncheck, offload=tier)
    if tier in ("spill", "disk") and policy == "pnode":
        kw["offload_segment"] = SEG
    rec = FlightRecorder()
    a, b = _explicit(**kw), _explicit(obs=rec, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    (ev,) = rec.events("odeint.solve")
    assert (ev.data["adjoint"], ev.data["offload"]) == (policy, tier)
    if policy.startswith("revolve") or tier is not None:
        assert any(e.kind.startswith(("store.", "spill."))
                   for e in rec.events())


IMPLICIT = ([("pnode", None, None), ("pnode", None, "spill"),
             ("pnode", None, "disk")]
            + [(p, 4, t) for p in ("revolve", "revolve2")
               for t in (None, "host", "spill")])


@pytest.mark.parametrize("policy,ncheck,tier", IMPLICIT,
                         ids=[f"{p}-{t or 'device'}" for p, _, t in IMPLICIT])
def test_obs_bitwise_implicit(policy, ncheck, tier):
    kw = dict(adjoint=policy, ncheck=ncheck, offload=tier)
    if tier in ("spill", "disk") and policy == "pnode":
        kw["offload_segment"] = SEG
    rec = FlightRecorder()
    a, b = _implicit(**kw), _implicit(obs=rec, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    steps = rec.implicit_steps()
    assert [d["step"] for d in steps] == list(range(N_STEPS))
    assert all(d["converged"] for d in steps)
    if policy != "pnode":
        assert rec.implicit_recomputes()


@pytest.mark.parametrize("capture", [False, True], ids=["eager", "graph"])
@pytest.mark.parametrize("offload", [None, "spill"])
def test_obs_bitwise_adaptive(capture, offload):
    outs = []
    for rec in (None, FlightRecorder()):
        s = AdaptiveSolver(_f, t0=0.0, t1=1.0, max_steps=64, capture=capture,
                           offload=offload, obs=rec)
        u0, th = _inputs()
        uf, info = s(u0, th)
        outs.append((uf.detach(), torch.autograd.grad(
            torch.sum(uf ** 2), [u0, th]), info, rec))
    (ua, ga, ia, _), (ub, gb, ib, rec) = outs
    assert ia == ib and torch.equal(ua, ub)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))
    assert rec.accepted_rejected() == (ib.n_accepted, ib.n_rejected)
    kinds = [e.kind for e in rec.events()]
    assert kinds.count("adaptive.solve") == kinds.count("adaptive.adjoint")


# ---------------------------------------------------------------------------
# the recorder's views against the JAX package's
# ---------------------------------------------------------------------------

def _j_traffic(**kw):
    rec = JRecorder()

    def loss(th):
        return jnp.sum(j_odeint(_f, jnp.ones(3), th, dt=DT, n_steps=N_STEPS,
                                obs=rec, **kw) ** 2)

    jax.block_until_ready(jax.jit(jax.grad(loss))(jnp.asarray(TH)))
    return rec


def _one_store(traffic):
    (store,) = traffic.values()
    return store


@pytest.mark.parametrize("tier", ["spill", "disk"])
def test_spill_traffic_matches_the_reference_and_the_store(tier):
    kw = dict(adjoint="pnode", offload=tier, offload_segment=SEG)
    rec = FlightRecorder()
    reset_spill_stats()
    _explicit(obs=rec, **kw)
    stats = spill_stats()
    mine = _one_store(rec.spill_traffic())
    ref = _one_store(_j_traffic(**kw).spill_traffic())
    for key in ("write_cb", "read_cb", "write_slots", "read_slots",
                "write_bytes", "read_bytes", "segments", "media"):
        assert mine[key] == ref[key], key
    for key in ("write_cb", "read_cb", "write_slots", "read_slots",
                "write_bytes", "read_bytes", "dispatch_cb"):
        assert mine[key] == stats[key], key
    assert sorted(mine["segments"]) == [0, 4, 8, 12]


def test_implicit_steps_match_the_reference():
    rec, jrec = FlightRecorder(), JRecorder()
    kw = dict(dt=DT, n_steps=N_STEPS, method="cn", adjoint="revolve2",
              ncheck=2, newton_iters=8, newton_tol=1e-12)
    _implicit(obs=rec, **{k: v for k, v in kw.items()
                          if k not in ("dt", "n_steps", "method",
                                       "newton_iters", "newton_tol")})

    def loss(th):
        return jnp.sum(j_implicit(_f, jnp.ones(3), th, obs=jrec, **kw) ** 2)

    jax.block_until_ready(jax.jit(jax.grad(loss))(jnp.asarray(TH)))
    for mine, ref in ((rec.implicit_steps(), jrec.implicit_steps()),
                      (rec.implicit_recomputes(),
                       jrec.implicit_recomputes())):
        assert [(d["step"], d["iters"], d["converged"]) for d in mine] == \
            [(d["step"], d["iters"], d["converged"]) for d in ref]
    (ev,) = rec.events("implicit.solve")
    (jev,) = jrec.events("implicit.solve")
    assert ev.data == jev.data


def _events():
    rec = FlightRecorder()
    _explicit(obs=rec, adjoint="pnode", offload="spill", offload_segment=SEG)
    rec.record("queue.submit", _runtime=True, rid="r0", depth=3)
    rec.record("serve.batch", _runtime=True, occupancy=0.5)
    rec.record("adaptive.step", _runtime=True, t=0.0, h=0.01, accept=True,
               attempt=0)
    return [e.to_json() for e in rec.events()]


def test_chrome_trace_matches_the_reference(tmp_path):
    evs = _events()
    assert to_chrome_trace(evs) == j_export.to_chrome_trace(evs)
    # and without wall clocks (older dumps order by seq)
    bare = [{k: v for k, v in e.items() if k != "ts"} for e in evs]
    assert to_chrome_trace(bare) == j_export.to_chrome_trace(bare)
    path = tmp_path / "trace.jsonl"
    with MetricsSink(str(path)) as sink:
        for e in evs:
            sink.emit(f"trace.{e['kind']}", **e)
    assert read_events(str(path)) == j_export.read_events(str(path))
    n = export_chrome_trace(str(path), str(tmp_path / "t.json"))
    doc = json.loads((tmp_path / "t.json").read_text())
    assert n == len(doc["traceEvents"]) > len(evs)


def test_baseline_checker_matches_the_reference():
    record = {"spill_io": {"callbacks": 8}, "fused": {
        "a": {"bitwise": True}, "b": {"bitwise": False}},
        "nfe": [10, 12], "size": 16}
    baseline = {"spill": {"max_cb": 6}, "size": 16}
    spec = [("cb", "spill_io.callbacks", "<=", ("ref", "spill.max_cb"), ""),
            ("bits", "fused.*.bitwise", "truthy", None, "must be bitwise"),
            ("nfe", "nfe.1", "==", 12, ""), ("missing", "nope", "==", 1, ""),
            ("noref", "size", "==", ("ref", "nope"), ""),
            ("size", "size", "==", ("ref", "size"), "")]
    out = []
    for mod, Gate_, Ref in ((None, Gate, BaselineRef),
                            (j_baseline, j_baseline.Gate,
                             j_baseline.BaselineRef)):
        gates = [Gate_(n, p, op, Ref(r[1]) if isinstance(r, tuple) else r,
                       msg) for n, p, op, r, msg in spec]
        reg = (MetricsRegistry() if mod is None
               else j_registry.MetricsRegistry())
        check = check_against_baseline if mod is None \
            else j_baseline.check_against_baseline
        errs = check(record, gates, baseline, bench="b", registry=reg)
        pre = check(record, [Gate_("pre", "size", "==", 15,
                                   precondition=True)] + gates, baseline,
                    bench="b", registry=reg)
        out.append((errs, pre, reg.snapshot()))
    assert out[0] == out[1]
    assert out[0][0]    # the case fails some gates


def test_registry_matches_the_reference():
    snaps = []
    for reg in (MetricsRegistry(), j_registry.MetricsRegistry()):
        reg.inc("a")
        reg.inc("a", 4)
        reg.set_gauge("g", 3)
        for v in (2.0, -1.0, 7.5):
            reg.observe("h", v)
        snaps.append((reg.snapshot(), reg.counter("a"), reg.gauge("g"),
                      reg.histogram("h"), reg.histogram("none")))
        reg.reset()
        snaps.append(reg.snapshot())
    assert snaps[:2] == snaps[2:]


# ---------------------------------------------------------------------------
# counting and profiling
# ---------------------------------------------------------------------------

def test_jit_counter_counts_on_the_tensor_device_and_mirrors():
    reg = MetricsRegistry()
    c = JitCounter("taps", reg)
    x = torch.zeros(2)
    assert c.tap(x) is x
    c.tap(x)
    c.tap(1.5)
    assert c.count == 3 and reg.counter("taps") == 3
    (dev,) = c._dev.values()
    ptr = dev.data_ptr()
    c.reset()
    c.tap(x)
    assert c.count == 1 and reg.counter("taps") == 4
    assert c._dev[x.device].data_ptr() == ptr


def test_feval_counter_counts_adaptive_attempts_and_keeps_the_gradient():
    outs = []
    for wrap in (False, True):
        f = FevalCounter(_f) if wrap else _f
        s = AdaptiveSolver(f, t0=0.0, t1=1.0, max_steps=64)
        u0, th = _inputs()
        with torch.no_grad():
            uf, info = s(u0, th)
        outs.append((uf, info, f))
    (ua, ia, _), (ub, ib, counter) = outs
    assert torch.equal(ua, ub) and ia == ib
    assert counter.count == ib.nfe_forward


def test_scope_frames_show_under_the_profiler_only():
    with scope("outside"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _explicit(adjoint="pnode", offload="spill", offload_segment=SEG)
    names = {e.key for e in prof.key_averages()}
    assert {"obs:pnode_spill/fwd", "obs:pnode_spill/bwd",
            "obs:spill/write", "obs:spill/prefetch"} <= names


def test_flight_recorder_jsonl_roundtrip(tmp_path):
    rec = FlightRecorder(registry=MetricsRegistry())
    s = AdaptiveSolver(_f, t0=0.0, t1=1.0, max_steps=64, obs=rec)
    s(*_inputs())
    # a device log handed over pending, read at sync()
    rec.emit_rows("custom", torch.tensor([[1.0, 2.0], [3.0, 4.0]]),
                  ("x", "n"), index="row", casts={"n": int}, tag="log")
    path = tmp_path / "rec.jsonl"
    n = rec.to_jsonl(str(path))
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert n == len(lines) == len(rec)
    assert [x["seq"] for x in lines] == sorted(x["seq"] for x in lines)
    assert rec.registry.counter("trace.adaptive.step") == \
        sum(x["kind"] == "adaptive.step" for x in lines)
    custom = [(x["row"], x["x"], x["n"], x["tag"], x["runtime"])
              for x in lines if x["kind"] == "custom"]
    assert custom == [(0, 1.0, 2, "log", True), (1, 3.0, 4, "log", True)]
