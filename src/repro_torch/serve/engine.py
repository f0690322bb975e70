"""The serving engines of ``repro_torch.serve``, the port of
``repro/serve/engine.py``: ``ODEEngine`` (batched ODE evaluation under a
memory budget) and ``LMEngine`` (wave-based continuous batching for the LM
prefill/decode path).

``ODEEngine`` is the paper's workload as a service: CNF log-density
(``kind="density"``), the score d log p / dx (``"score"``, the reverse pass
the paper is about) and ODE-classifier logits (``"classify"``) over a
caller's vector field.  Batches come from a ``RequestQueue`` and are
padded to a ``BucketSpec`` bucket; there is one program a (kind, bucket),
so at most ``len(KINDS) * len(sizes)`` exist whatever the traffic.  A
program solves the padded (B, dim) block as one state, since the vector
fields act row-wise on a leading axis: the JAX package's ``vmap`` is not
needed.  Every solve is ``odeint(adjoint="pnode")`` with the stage updates
unfused, as the JAX package's engine runs it.  Its tier:

- ``offload=None``: the checkpoints stay on the device, and each program
  is a ``StepGraph`` (``launch/graphs.py``), captured on the card at its
  first call and replayed after it (``capture=False`` runs it eagerly).
- ``offload="spill"`` / ``"disk"``: the checkpoints go through a store a
  bucket whose ``lane_keys`` tie each slot to the request in its lane,
  slot key ``(request id, step)`` (``mem/offload.py``).  The host moves
  each segment between kernels, so these programs run eagerly (capturing
  them as units with the host's transfers between them is ROADMAP Queue 1
  item 12a); each is still built once a (kind, bucket).  The keys are
  read when a transfer runs, so one program serves every batch
  composition, padding lanes store nothing, and ``free_request`` drops a
  departed request's slots without touching its batch-mates'.

A request's result is the same bits whatever its batch-mates and its lane
inside one bucket, on every tier, and the spill and disk tiers (and the
RAM/disk split) give the device tier's bits.

Memory budgets go through ``repro_torch.mem.plan_odeint(batch=bucket)``:
the planner prices the batched working set (state and f activations scale
with the lanes, the shared ``theta`` does not) and solves the RAM/disk
``snaps_in_ram`` split the stores then honour.

``adaptive=True`` serves each request as its own single-lane adaptive
Dopri5 solve (the lanes would diverge in their steps): one
``AdaptiveCNF`` (density, score) or ``AdaptiveSolver`` (classify) a kind,
shared by every request, captured on the card unless ``capture=False``.

Faults and metrics, as the JAX package's engine has them: ``fault_plan=``
arms the queue's ``serve.request`` site, the stores' spill sites and the
``serve.decode`` site, which ticks once a batch (once a request on the
adaptive path); its ``nan`` kind poisons the first real lane's result,
which fails that ticket alone.  ``registry=`` receives the queue's metrics,
the ``serve.batch_occupancy``, ``serve.callbacks_per_request`` and
``serve.batch_wall_s`` histograms and the ``serve.errors`` /
``serve.completed`` counters; ``obs=`` the queue's and the stores' events
and ``serve.batch``.

``LMEngine``: the decode step takes one position for the whole batch, so
lanes cannot be at different sequence offsets inside one batch: requests
are grouped into *waves* that prefill together and decode in lockstep.
Between decode slices of the active wave the engine prefills the next
wave, so when the active wave retires the next one starts decoding at
once.

Decode runs through a ``StepGraph``, the port's counterpart of the JAX
package's ``jax.jit(decode, donate_argnums=(1,))``: on the card it is
captured once as a CUDA graph and replayed every step.  The engine owns
one static decode state, into which each wave's prefill state is copied
when the wave becomes active, and the graph reads it, the token and the
position (a 0-d device tensor) at fixed addresses.  Warm-up and capture
run on that static state before any wave uses it, as a decode step writes
its state in place.  Prefill stays eager (it is device-bound and is where
the flash and RWKV6 kernels launch), and so does sampling, as the JAX
package jits decode alone: the Gumbel draws at ``temperature > 0`` use the
engine's generator outside the graph.

``LMEngine``'s faults and metrics: ``fault_plan=`` arms the queue's
``serve.request`` site and the ``serve.decode`` site, which ticks once a
decode step; its ``nan`` kind poisons lane 0's logits of that step.  With
a plan armed, the engine reads a per-lane finite flag of the logits after
each step (one host read a step) and resolves a lane that went non-finite
with an error, while its batch-mates' tokens are the clean run's bit for
bit; unarmed, the replayed decode is unchanged.  ``registry=`` receives
the queue's metrics plus the ``serve.batch_occupancy`` histogram and the
``serve.errors`` / ``serve.completed`` counters; ``obs=`` the queue's
events plus ``serve.prefill`` and ``serve.retire``.

Not ported yet: the mesh and sharded replicas (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.adaptive import AdaptiveSolver
from repro_torch.core.adjoint import odeint
from repro_torch.core.cnf import AdaptiveCNF, _base_log_prob, exact_trace_vf
from repro_torch.launch.graphs import StepGraph
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.mem.offload import make_store
from repro_torch.mem.planner import plan_odeint
from repro_torch.models import lm as lm_mod
from repro_torch.models.ode_nets import resolve_device
from repro_torch.serve.queue import BucketSpec, RequestQueue, Ticket

__all__ = ["ODEEngine", "LMEngine"]


class ODEEngine:
    """Continuous-batching ODE inference over one vector field (module
    docstring).

    Parameters
    ----------
    f : vector field ``f(u, theta, t)``, row-wise on (B, dim) states.
    theta : its parameters (a tree of tensors), shared by every request;
        held on ``device``.
    dim : state dimension; a request's payload is a (dim,) float array.
    dt, n_steps, t0, method : the solve grid (fixed-step path).
    offload : "spill" | "disk" | None, the checkpoint tier of the reverse
        pass.  The planner overrides it when a budget is given.
    mem_budget / ram_budget / disk_budget : consult ``plan_odeint`` with
        ``batch=max bucket`` (the largest working set); the plan's tier and
        ``snaps_in_ram`` configure the engine and ``.plan`` keeps it.
    head : ``head(u_final) -> logits`` of ``kind="classify"``, row-wise
        (default: the final state).
    adaptive : the per-request adaptive path (module docstring).
    capture : replay CUDA graphs where the tier allows (the device tier
        and the adaptive path); False runs every program eagerly.
    device : where the engine computes; the card unless the caller asks
        for the CPU.
    """

    KINDS = ("density", "score", "classify")

    def __init__(self, f: Callable, theta: Any, *, dim: int, dt: float,
                 n_steps: int, t0: float = 0.0, method: str = "rk4",
                 offload: Optional[str] = "spill",
                 offload_segment: Optional[int] = None,
                 snaps_in_ram: Optional[int] = None,
                 mem_budget: Optional[int] = None,
                 ram_budget: Optional[int] = None,
                 disk_budget: Optional[int] = None,
                 buckets: Optional[BucketSpec] = None,
                 head: Optional[Callable] = None,
                 adaptive: bool = False, rtol: float = 1e-6,
                 atol: float = 1e-6, max_steps: int = 512,
                 spool_dir: Optional[str] = None,
                 queue: Optional[RequestQueue] = None,
                 fault_plan=None, registry=None, obs=None,
                 max_payload_bytes: int = 1 << 20, aging: float = 1.0,
                 capture: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.f = f
        self.theta = pytree.tree_map(
            lambda x: x.detach().to(self.device), theta)
        self.dim = int(dim)
        self.dt = float(dt)
        self.n_steps = int(n_steps)
        self.t0 = float(t0)
        self.method = method
        self.offload = offload
        self.offload_segment = offload_segment
        self.snaps_in_ram = snaps_in_ram
        self.buckets = buckets or BucketSpec()
        self.head = head if head is not None else (lambda u: u)
        self.adaptive = bool(adaptive)
        self.rtol, self.atol, self.max_steps = rtol, atol, int(max_steps)
        self.spool_dir = spool_dir
        self.fault_plan = fault_plan
        self.registry = registry
        self.obs = obs
        self.capture = bool(capture)
        self._aug = exact_trace_vf(f, self.dim)
        self.plan = None
        if mem_budget is not None or ram_budget is not None:
            proto = (torch.zeros((self.dim,), device=self.device),
                     torch.zeros((), device=self.device))
            self.plan = plan_odeint(
                self._aug, proto, self.theta, dt=self.dt,
                n_steps=self.n_steps, t0=self.t0, method=method,
                mem_budget=mem_budget, ram_budget=ram_budget,
                disk_budget=disk_budget, verify="model",
                batch=self.buckets.max_size)
            # the plan sizes the batched working set; its tier and RAM/disk
            # split hold (offload=None: the policy fits on the device)
            self.offload = self.plan.offload
            if self.plan.snaps_in_ram is not None:
                self.snaps_in_ram = self.plan.snaps_in_ram
        if self.offload not in (None, "spill", "disk"):
            raise ValueError(
                f"ODEEngine serves the lane-keyed spill/disk tiers (or "
                f"no offload); got offload={self.offload!r}")
        self.queue = queue if queue is not None else RequestQueue(
            kinds=self.KINDS, dim=self.dim,
            max_payload_bytes=max_payload_bytes, aging=aging,
            fault_plan=fault_plan, registry=registry, obs=obs)
        self._stores: Dict[int, Any] = {}
        self._fns: Dict[Tuple[str, int], Any] = {}
        self._solvers: Dict[str, AdaptiveSolver] = {}

    # -- stores and programs --------------------------------------------------
    def _store(self, bucket: int):
        """One store a bucket, shared by its kinds (``step`` runs one batch
        at a time), in a subdirectory of its own under ``spool_dir``, so
        that one store's sweep of stale files misses its siblings'."""
        if self.offload is None:
            return None
        if bucket not in self._stores:
            sub = None
            if self.spool_dir is not None:
                sub = os.path.join(self.spool_dir, f"bucket{bucket}")
                os.makedirs(sub, exist_ok=True)
            st = make_store(self.offload, fault_plan=self.fault_plan,
                            snaps_in_ram=self.snaps_in_ram, disk_dir=sub)
            if self.obs is not None:
                st.bind_obs(self.obs)
            st.lane_keys = (None,) * bucket
            self._stores[bucket] = st
        return self._stores[bucket]

    def _solver_kw(self, store) -> dict:
        kw = dict(dt=self.dt, n_steps=self.n_steps, t0=self.t0,
                  method=self.method, adjoint="pnode")
        if store is not None:
            kw.update(offload=self.offload,
                      offload_segment=self.offload_segment,
                      snaps_in_ram=self.snaps_in_ram, offload_store=store)
        return kw

    def _logp(self, theta, xb, kw) -> torch.Tensor:
        logdet0 = torch.zeros(xb.shape[:-1], dtype=xb.dtype,
                              device=xb.device)
        z, dlogdet = odeint(self._aug, (xb, logdet0), theta, **kw)
        return _base_log_prob(z, dlogdet)

    def _fn(self, kind: str, bucket: int):
        """The (kind, bucket) program, ``fn(theta, (xb,))`` on the (bucket,
        dim) block: a ``StepGraph`` on the device tier, an eager function
        on the spill/disk tiers.  At most ``len(KINDS) * len(sizes)`` are
        ever built."""
        key = (kind, bucket)
        if key in self._fns:
            return self._fns[key]
        kw = self._solver_kw(self._store(bucket))

        def density(theta, xb):
            with torch.no_grad():
                return self._logp(theta, xb, kw)

        def score(theta, xb):
            # the gradient of the lanes' summed log-densities: lane b's
            # row is d log p(x_b) / d x_b, the lanes being independent
            with torch.enable_grad():
                x = xb.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(self._logp(theta, x, kw).sum(), x)
            return g

        def classify(theta, xb):
            with torch.no_grad():
                return self.head(odeint(self.f, xb, theta, **kw))

        prog = {"density": density, "score": score,
                "classify": classify}[kind]

        def fn(held, copied):
            return prog(held, copied[0])

        if self.offload is None and self.capture:
            fn = StepGraph(fn, clone_outputs=True)
        self._fns[key] = fn
        return fn

    # -- the adaptive (per-request) path --------------------------------------
    def _adaptive_kw(self) -> dict:
        kw = dict(t0=self.t0, t1=self.t0 + self.dt * self.n_steps,
                  rtol=self.rtol, atol=self.atol, max_steps=self.max_steps,
                  capture=self.capture)
        if self.offload is not None:
            kw.update(offload=self.offload,
                      offload_segment=self.offload_segment)
            if self.offload == "spill":
                kw.update(snaps_in_ram=self.snaps_in_ram)
        return kw

    def _adaptive_fn(self, kind: str):
        """The single-lane program of ``kind``, ``fn(x) -> row`` on a (dim,)
        point: one solver a kind, shared by every request, unfused."""
        key = (f"adaptive.{kind}", 1)
        if key in self._fns:
            return self._fns[key]
        kw = self._adaptive_kw()
        if kind == "classify":
            solver = AdaptiveSolver(self.f, **kw)

            def fn(x):
                with torch.no_grad():
                    return self.head(solver(x, self.theta)[0])
        else:
            cnf = AdaptiveCNF(self.f, self.dim, **kw)
            solver = cnf.solver

            def fn(x):
                if kind == "density":
                    with torch.no_grad():
                        return cnf.log_prob(x, self.theta)[0]
                with torch.enable_grad():
                    x = x.detach().requires_grad_(True)
                    (g,) = torch.autograd.grad(
                        cnf.log_prob(x, self.theta)[0], x)
                return g
        self._solvers[kind] = solver
        self._fns[key] = fn
        return fn

    def graph_stats(self) -> Dict[str, Any]:
        """{program: (warmup_ms, capture_ms, pool_bytes)} of every captured
        program (None on the CPU): "kind/bucket" on the device tier,
        "adaptive.kind/step" on the adaptive path."""
        out = {f"{k}/{b}": (g.warmup_ms, g.capture_ms, g.pool_bytes)
               for (k, b), g in self._fns.items()
               if isinstance(g, StepGraph)}
        for kind, solver in self._solvers.items():
            for step, st in solver.graph_stats().items():
                out[f"adaptive.{kind}/{step}"] = st
        return out

    # -- serving --------------------------------------------------------------
    def submit(self, kind: str, x, *, priority: float = 0.0,
               rid: Optional[str] = None) -> Ticket:
        return self.queue.submit(kind, x, priority=priority, rid=rid)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device)

    def warmup(self, kinds=None, buckets=None) -> int:
        """Build (and, captured, warm up and capture) the (kind, bucket)
        programs on zeros with all-padding lane keys, which store nothing;
        returns the number built."""
        n = 0
        for kind in (kinds or self.KINDS):
            if self.adaptive:
                self._adaptive_fn(kind)(
                    self._tensor(np.zeros(self.dim, np.float32)))
                self._release_adaptive(kind)
                n += 1
                continue
            for b in (buckets or self.buckets.sizes):
                store = self._store(b)
                if store is not None:
                    store.lane_keys = (None,) * b
                self._fn(kind, b)(self.theta, (self._tensor(
                    np.zeros((b, self.dim), np.float32)),))
                n += 1
        self._sync()
        return n

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _resolve(self, batch, rows: List[np.ndarray], tick: int) -> None:
        for (req, ticket), row in zip(batch, rows):
            if not np.all(np.isfinite(row)):
                if self.registry is not None:
                    self.registry.inc("serve.errors")
                ticket.set_error(RuntimeError(
                    f"request {req.rid}: non-finite result "
                    f"(poisoned decode?)"), tick)
            else:
                if self.registry is not None:
                    self.registry.inc("serve.completed")
                ticket.set_result(row, tick)

    def step(self) -> int:
        """One scheduling quantum: claim a same-kind batch, pad it to a
        bucket, run its program with the batch's lane keys, tick the
        ``serve.decode`` fault site, resolve the tickets (a poisoned lane
        fails alone) and free every request's slots.  Returns the number of
        requests served (0: the queue is idle)."""
        batch = self.queue.next_batch(self.buckets.max_size)
        if not batch:
            return 0
        kind = batch[0][0].kind
        if self.adaptive:
            return self._step_adaptive(kind, batch)
        bucket = self.buckets.bucket_for(len(batch))
        xb = np.zeros((bucket, self.dim), np.float32)
        lanes: List[Optional[str]] = [None] * bucket
        for i, (req, _) in enumerate(batch):
            xb[i] = req.payload
            lanes[i] = req.rid
        store = self._store(bucket)
        stats0 = dict(store.stats) if store is not None else {}
        if store is not None:
            store.lane_keys = tuple(lanes)
        fn = self._fn(kind, bucket)
        t_start = time.perf_counter()
        out = fn(self.theta, (self._tensor(xb),)).cpu().numpy()
        wall = time.perf_counter() - t_start
        out = out.copy()  # poisoning below must not alias a held buffer
        if self.fault_plan is not None:
            spec = self.fault_plan.tick("serve.decode")
            if spec is not None and spec.kind == "nan":
                out[0] = np.nan  # the first real lane: a request's fault
        tick = self.queue.tick
        self._resolve(batch, [out[i] for i in range(len(batch))], tick)
        cbs = 0
        if store is not None:
            for req, _ in batch:
                store.free_request(req.rid)
            store.lane_keys = (None,) * bucket
            cbs = sum(store.stats[k] - stats0.get(k, 0)
                      for k in ("write_cb", "read_cb", "dispatch_cb",
                                "prefetch_hit_cb"))
        occ = len(batch) / bucket
        if self.registry is not None:
            self.registry.observe("serve.batch_occupancy", occ)
            self.registry.observe("serve.callbacks_per_request",
                                  cbs / len(batch))
            self.registry.observe("serve.batch_wall_s", wall)
        if self.obs is not None:
            self.obs.record("serve.batch", _runtime=True, req_kind=kind,
                            bucket=bucket, lanes=len(batch),
                            occupancy=occ, callbacks=cbs, wall_s=wall)
        return len(batch)

    def _release_adaptive(self, kind: str) -> None:
        """Drop the slots a request's recording pass left in its solver's
        store (the JAX package's per-request store goes with its solve);
        the store's prefetch worker serves the next request."""
        solver = self._solvers.get(kind)
        if solver is not None and solver.store is not None:
            solver.store.clear()

    def _step_adaptive(self, kind: str, batch) -> int:
        """The per-request loop: each request is its own single-lane
        adaptive solve, at occupancy 1."""
        fn = self._adaptive_fn(kind)
        rows = []
        t_start = time.perf_counter()
        for req, _ in batch:
            out = np.atleast_1d(fn(self._tensor(req.payload)).cpu().numpy())
            self._release_adaptive(kind)
            out = out.copy()
            if self.fault_plan is not None:
                spec = self.fault_plan.tick("serve.decode")
                if spec is not None and spec.kind == "nan":
                    out[...] = np.nan
            rows.append(out)
        wall = time.perf_counter() - t_start
        tick = self.queue.tick
        self._resolve(batch, rows, tick)
        if self.registry is not None:
            self.registry.observe("serve.batch_occupancy", 1.0)
            self.registry.observe("serve.batch_wall_s", wall)
        if self.obs is not None:
            self.obs.record("serve.batch", _runtime=True, req_kind=kind,
                            bucket=1, lanes=len(batch), occupancy=1.0,
                            adaptive=True, wall_s=wall)
        return len(batch)

    def run(self, max_steps: int = 10_000) -> int:
        """Drain the queue; returns the requests served."""
        served = 0
        for _ in range(max_steps):
            n = self.step()
            if n == 0 and self.queue.depth() == 0:
                break
            served += n
        return served

    def _all_stores(self):
        return list(self._stores.values()) + [
            s.store for s in self._solvers.values() if s.store is not None]

    def slot_census(self) -> Dict[str, int]:
        """Live slots summed over every store of the engine (0 everywhere
        when no request is in flight: departures freed their slots)."""
        total = {"ram": 0, "disk": 0, "disk_files": 0}
        for st in self._all_stores():
            for k, v in st.slot_census().items():
                total[k] = total.get(k, 0) + v
        return total

    def close(self) -> None:
        """Stop the stores' prefetch workers and drop their slots and
        files now; the engine stays usable."""
        for st in self._all_stores():
            st.close()

    def __enter__(self) -> "ODEEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _Wave:
    """One cohort of lanes decoding in lockstep (one shared position)."""

    def __init__(self, batch, state, tok, pos0: int, max_gen: int):
        self.batch = batch              # [(Request, Ticket)] real lanes
        self.state = state
        self.tok = tok                  # (lanes, 1) int64, last sampled
        self.pos0 = int(pos0)
        self.max_gen = int(max_gen)
        self.emitted: List[torch.Tensor] = []   # per-step (lanes,) tokens
        self.errored: set = set()               # lanes with non-finite logits

    @property
    def done(self) -> bool:
        return len(self.emitted) >= self.max_gen


class LMEngine:
    """Wave-based continuous batching for the LM prefill/decode path.

    ``params`` is a tree on ``device`` (e.g. from ``convert.params_from_jax``)
    or None for random weights drawn from ``seed`` on a generator on that
    device.  Sampling is greedy at ``temperature <= 0``: ``argmax``, which
    returns the first maximal index, as ``jnp.argmax`` does.  Above 0 it
    draws with the Gumbel-max rule from a ``torch.Generator`` on the device
    seeded from ``seed + 1``; those draws cannot match ``jax.random``'s.

    ``call_log`` records every device call (op, wall seconds, tokens
    emitted, lanes, and ``compile``, which here marks the first call of
    each op, the one that pays the kernel build, the CUDA/cuBLAS set-up
    and the decode graph's warm-up and capture).  ``launch/serve.py``
    splits warm-up from steady state with it.

    ``aging`` is the queue's ticks-to-priority rate: 0 dispatches by
    strict priority, the default 1.0 lets waiting requests age.

    The static decode state adds ``init_decode_state(cfg, lanes,
    max_seq)``'s bytes to the device memory, and the captured graph its
    pool (``decode_graph.pool_bytes``).  Decode is captured with
    ``index_copy_`` writing the KV cache, which a capture refuses under
    ``torch.use_deterministic_algorithms(True)``.

    ``fault_plan``, ``registry`` and ``obs`` are the module docstring's.
    """

    def __init__(self, cfg, *, lanes: int, prompt_len: int, max_gen: int,
                 decode_slice: int = 4, temperature: float = 0.0,
                 seed: int = 0, params=None, device="cuda",
                 aging: float = 1.0, fault_plan=None, registry=None,
                 obs=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lanes = int(lanes)
        self.prompt_len = int(prompt_len)
        self.max_gen = int(max_gen)
        self.decode_slice = max(1, int(decode_slice))
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.max_seq = self.prompt_len + self.max_gen
        self.fault_plan = fault_plan
        self.registry = registry
        self.obs = obs
        self.queue = RequestQueue(
            kinds=("lm",), dim=self.prompt_len,
            max_payload_bytes=max(1 << 20, 8 * self.prompt_len),
            aging=aging, fault_plan=fault_plan, registry=registry, obs=obs)
        self.call_log: List[Dict[str, Any]] = []
        self._active: Optional[_Wave] = None
        self._staged: Optional[_Wave] = None
        self._decode_calls = 0
        self.pos0 = self.prompt_len
        if params is None:
            gen = torch.Generator(self.device).manual_seed(self.seed)
            params = lm_mod.init_params(cfg, gen, device=self.device)
        self.params = params
        self._prefill_fn = make_prefill_step(cfg, max_seq=self.max_seq)
        self._decode_fn = make_decode_step(cfg)
        self._gen = torch.Generator(self.device).manual_seed(self.seed + 1)
        # what the decode graph reads at fixed addresses: the static state
        # and position here, the token in the graph's own buffer
        self._state = lm_mod.init_decode_state(cfg, self.lanes, self.max_seq,
                                               device=self.device)
        self._pos = torch.zeros((), dtype=torch.long, device=self.device)
        self.decode_graph = StepGraph(self._decode_logits,
                                      clone_outputs=False)

    @property
    def static_state_bytes(self) -> int:
        """Device bytes of the static decode state the graph reads."""
        return sum(t.numel() * t.element_size()
                   for t in pytree.tree_leaves(self._state))

    # -- client API ----------------------------------------------------------
    def submit(self, prompt, *, gen: Optional[int] = None,
               priority: float = 0.0, rid: Optional[str] = None) -> Ticket:
        """Admit one prompt (``(prompt_len,)`` int tokens).  ``gen`` caps
        this request's emitted tokens (<= engine ``max_gen``)."""
        gen = self.max_gen if gen is None else min(int(gen), self.max_gen)
        return self.queue.submit("lm", np.asarray(prompt, np.int32),
                                 priority=priority, rid=rid,
                                 meta={"gen": gen})

    # -- internals -----------------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=self._gen,
                       device=logits.device).clamp_(min=1e-20)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits.float() / self.temperature + gumbel,
                            dim=-1)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill_next(self) -> Optional[_Wave]:
        batch = self.queue.next_batch(self.lanes, kind="lm")
        if not batch:
            return None
        toks = np.zeros((self.lanes, self.prompt_len), np.int32)
        for i, (req, _) in enumerate(batch):
            toks[i] = req.payload
        prompt = {"tokens": torch.from_numpy(toks).to(self.device)}
        compile_ = not self.call_log  # the first call of the engine
        t_start = time.time()
        with torch.no_grad():
            state, logits = self._prefill_fn(self.params, prompt)
            tok = self._sample(logits)[:, None]
        self._sync()
        wall = time.time() - t_start
        max_gen = max(r.meta["gen"] for r, _ in batch)
        wave = _Wave(batch, state, tok, self.pos0, max_gen)
        # the prefill's sampled token is token #1 of every lane and counts
        # toward throughput
        wave.emitted.append(tok[:, 0])
        self.call_log.append({"op": "prefill", "wall_s": wall,
                              "tokens": len(batch), "compile": compile_,
                              "lanes": len(batch)})
        if self.obs is not None:
            self.obs.record("serve.prefill", _runtime=True,
                            lanes=len(batch), wall_s=wall)
        if self.registry is not None:
            self.registry.observe("serve.batch_occupancy",
                                  len(batch) / self.lanes)
        return wave

    def _decode_logits(self, held, copied) -> torch.Tensor:
        """The captured step: logits of one decode step, whose state
        update lands in the static state in place."""
        (params, state), (tok, pos) = held, copied
        logits, _ = self._decode_fn(params, state, tok, pos)
        return logits

    def _activate(self, wave: _Wave) -> None:
        """Move ``wave`` onto the static state.  The engine's first wave
        warms up and captures the decode graph first, on the static state
        that no wave holds yet; then the wave's prefill state is copied in
        leaf by leaf and dropped."""
        held = (self.params, self._state)
        if not self.decode_graph.captured:
            self.decode_graph.capture(held, (wave.tok, self._pos))
        for dst, src in zip(pytree.tree_leaves(self._state),
                            pytree.tree_leaves(wave.state)):
            dst.copy_(src)
        wave.state = self._state

    def _decode_slice(self, wave: _Wave) -> None:
        k = min(self.decode_slice, wave.max_gen - len(wave.emitted))
        if k <= 0:
            return
        compile_ = self._decode_calls == 0
        armed = self.fault_plan is not None
        t_start = time.time()
        with torch.no_grad():
            if wave.state is not self._state:
                self._activate(wave)
            held = (self.params, self._state)
            for _ in range(k):
                i = len(wave.emitted) - 1  # decode steps taken so far
                self._pos.fill_(wave.pos0 + i)
                logits = self.decode_graph(held, (wave.tok, self._pos))
                if armed:
                    spec = self.fault_plan.tick("serve.decode")
                    if spec is not None and spec.kind == "nan":
                        # poison exactly one lane's logits: a request-level
                        # fault, not a batch-level one
                        logits = logits.clone()
                        logits[0] = float("nan")
                    bad = (~torch.isfinite(logits)).any(dim=-1).cpu()
                    wave.errored.update(
                        int(j) for j in torch.nonzero(bad).flatten())
                # read before the next replay overwrites the logits
                wave.tok = self._sample(torch.nan_to_num(logits))[:, None]
                wave.emitted.append(wave.tok[:, 0])
        self._sync()
        wall = time.time() - t_start
        self._decode_calls += 1
        self.call_log.append({"op": "decode", "wall_s": wall,
                              "tokens": k * len(wave.batch), "steps": k,
                              "compile": compile_, "lanes": len(wave.batch)})

    def _retire(self, wave: _Wave) -> None:
        tick = self.queue.tick
        grid = torch.stack(wave.emitted, dim=1).cpu().numpy().astype(np.int32)
        for i, (req, ticket) in enumerate(wave.batch):
            if i in wave.errored:
                if self.registry is not None:
                    self.registry.inc("serve.errors")
                ticket.set_error(RuntimeError(
                    f"request {req.rid}: poisoned decode (serve.decode)"),
                    tick)
                continue
            if self.registry is not None:
                self.registry.inc("serve.completed")
            ticket.set_result(grid[i, :req.meta["gen"]].copy(), tick)
        if self.obs is not None:
            self.obs.record("serve.retire", _runtime=True,
                            lanes=len(wave.batch),
                            tokens=len(wave.emitted) * len(wave.batch),
                            errored=len(wave.errored))

    def step(self) -> bool:
        """One scheduling quantum.  Activates a staged/new wave, decodes
        one slice, and interleaves the NEXT wave's prefill between slices
        of the active one.  Returns False when fully idle."""
        if self._active is None:
            self._active = self._staged or self._prefill_next()
            self._staged = None
            return self._active is not None
        self._decode_slice(self._active)
        if self._active.done:
            self._retire(self._active)
            self._active = None
            return True
        if self._staged is None and self.queue.depth() > 0:
            self._staged = self._prefill_next()
        return True

    def run(self, max_quanta: int = 100_000) -> None:
        """Drive until queue + waves drain."""
        for _ in range(max_quanta):
            busy = self.step()
            if not busy and self.queue.depth() == 0 \
                    and self._active is None and self._staged is None:
                return
        raise RuntimeError("LMEngine.run did not drain "
                           f"within {max_quanta} quanta")
