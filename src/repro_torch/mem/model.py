"""Analytic per-policy memory/compute cost model (the paper's Table 2).

Maps every adjoint policy to (peak live bytes, extra reverse-pass f
evaluations) as a function of N_t (steps), the tableau's stage counts, the
state size, and — for revolve — N_c (checkpoint slots):

  policy      ckpt storage (bytes)                 NFE-B (extra f evals)
  naive       N_t * N_s * A_f    (AD residuals)    0
  continuous  0                                    N_s * N_t   (not rev-acc)
  anode       N_t * N_s * A_f    (recompute+AD)    2 N_s N_t
  aca         N_t * S                              2 N_s N_t
  pnode       N_t * (N_s+1) * S                    N_s^a N_t
  pnode2      N_t * S                              (N_s + N_s^a) N_t
  revolve     (N_c+1) * (N_s+1) * S                N_s p~(N_t,N_c) + N_s^a N_t
  revolve2    (N_c+1+seg*(N_s+1)) * S              ~N_s (N_t-N_c) + N_s^a N_t

with S = state bytes, N_s^a = stages the discrete adjoint linearizes
(``adjoint_stages``), p~ the Prop-2 recompute optimum, and A_f the bytes
one f evaluation leaves behind (``f_activation_bytes``: the N_l-dependent
term that makes NODE-naive the steepest curve in Fig. 3).  An ``offload``
tier moves the checkpoint-storage term off the device; it never changes
NFE-B.  Off-device storage is two-tiered: ``snaps_in_ram`` caps the slots
kept in host RAM, the rest sink to disk, priced by the ``ram_bytes`` /
``disk_bytes`` / ``io_seconds`` columns.  Implicit theta-methods
(``method="beuler"|"cn"``) have their own column: a slot is one converged
state, the reverse step's working set is the transposed-GMRES Krylov
basis, and a recomputed step costs a full Newton solve.

The arithmetic is the JAX package's (``repro/mem/model.py``): the same
inputs give the same integers.  Two parts are the port's own:

- ``f_activation_bytes`` sums the output bytes of every aten op of one
  ``f`` evaluation, run on meta copies of the inputs (no memory, no time);
- ``measure_reverse_cost``, the model's ground truth, runs one gradient
  and reads its peak from the CUDA caching allocator on the card, or from
  a live-tensor tracker on the CPU.  With ``offload`` the gradient runs on
  that tier: the checkpoints then sit in host memory (pinned tensors,
  numpy arrays or files), which neither reading counts.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import revolve as revolve_mod
from repro_torch.core.adjoint import (_FUSED_POLICIES, checkpoint_floats,
                                      nfe_backward)
from repro_torch.core.implicit import (IMPLICIT_POLICIES,
                                       implicit_checkpoint_floats,
                                       implicit_nfe_backward,
                                       is_implicit_method)
from repro_torch.core.tableaus import get_tableau

PyTree = Any

#: policies whose gradients are exact reorderings of the naive chain rule
REVERSE_ACCURATE = ("naive", "anode", "aca", "pnode", "pnode2", "revolve",
                    "revolve2")

#: the model's coarse transfer constants, as the JAX package sets them:
#: host-RAM copies, segment-file disk I/O and one host callback round
#: trip.  The planner uses the RAM:disk ratio to price the snaps_in_ram
#: split; they are not figures measured on any card.
HOST_COPY_BW = 8e9       # bytes/s
DISK_BW = 500e6          # bytes/s
CALLBACK_LATENCY_S = 50e-6


def default_segment(n_steps: int) -> int:
    """Default checkpoint-segment length of the spill tiers:
    ceil(sqrt(n_steps)) (the JAX package's ``mem/offload.py``)."""
    if n_steps <= 1:
        return 1
    r = int(np.sqrt(n_steps))
    return int(r if r * r >= n_steps else r + 1)


def slot_bytes(method: str, state_bytes: int) -> int:
    """Bytes of ONE checkpoint slot: (N_s+1)*S for explicit tableaus
    (state + staged k_i), S for implicit methods (converged states only).
    The unit of the ``snaps_in_ram`` RAM/disk split."""
    if is_implicit_method(method):
        return int(state_bytes)
    return (get_tableau(method).num_stages + 1) * int(state_bytes)


def _offload_io(offload: Optional[str], ckpt_bytes: int, callbacks: int,
                method: str, state_bytes: int,
                snaps_in_ram: Optional[int]) -> Tuple[int, int, float]:
    """(ram_bytes, disk_bytes, io_seconds) of one fwd+bwd round trip: the
    off-device checkpoint set split across the RAM/disk media, each byte
    written once and read once at its tier's bandwidth."""
    if offload not in ("host", "spill", "disk") or ckpt_bytes <= 0:
        return 0, 0, 0.0
    if offload == "disk":
        ram, disk = 0, int(ckpt_bytes)
    elif offload == "spill" and snaps_in_ram is not None:
        sb = max(1, slot_bytes(method, state_bytes))
        ram = min(int(ckpt_bytes), int(snaps_in_ram) * sb)
        disk = int(ckpt_bytes) - ram
    else:  # host, or spill with unlimited RAM
        ram, disk = int(ckpt_bytes), 0
    io = 2.0 * (ram / HOST_COPY_BW + disk / DISK_BW) \
        + callbacks * CALLBACK_LATENCY_S
    return ram, disk, io


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree: PyTree) -> int:
    """Total bytes of a pytree of tensors (meta tensors count too); a
    non-tensor leaf counts as its numpy array."""
    total = 0
    for leaf in pytree.tree_leaves(tree):
        if torch.is_tensor(leaf):
            total += _tensor_bytes(leaf)
        else:
            total += int(np.asarray(leaf).nbytes)
    return total


class _OutputBytes(TorchDispatchMode):
    """Sums the bytes of every tensor that an aten op returns."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.total += sum(_tensor_bytes(t) for t in pytree.tree_leaves(out)
                          if torch.is_tensor(t))
        return out


def _meta(tree: PyTree) -> PyTree:
    return pytree.tree_map(
        lambda x: torch.empty_like(x, device="meta")
        if torch.is_tensor(x) else x, tree)


def f_activation_bytes(f: Callable, u0: PyTree, theta: PyTree,
                       t: float = 0.0) -> int:
    """Bytes one ``f`` evaluation leaves behind: the summed output bytes
    of every aten op of ``f(u0, theta, t)``, run on meta copies of the
    inputs — the O(N_l) depth term that naive/anode pay per stage and the
    high-level adjoint avoids.  At least the state's bytes; just those
    where ``f`` cannot run on meta tensors (it reads a value on the host,
    or mixes in a real tensor of its own)."""
    counter = _OutputBytes()
    u_meta, th_meta = _meta(u0), _meta(theta)
    try:
        with counter:
            f(u_meta, th_meta, t)
    except (NotImplementedError, RuntimeError):
        return tree_bytes(u0)
    return max(counter.total, tree_bytes(u0))


@dataclass(frozen=True)
class CostEstimate:
    """One Table-2 row instantiated at concrete sizes."""
    policy: str
    ncheck: Optional[int]
    offload: Optional[str]
    ckpt_bytes: int        # checkpoint storage between fwd and bwd sweeps
    work_bytes: int        # transient working set of one reverse step
    extra_fevals: int      # NFE-B: reverse-pass f evaluations
    reverse_accurate: bool
    host_callbacks: int = 0  # host round-trips per reverse pass (spill tier)
    ram_bytes: int = 0       # off-device ckpt bytes resident in host RAM
    disk_bytes: int = 0      # off-device ckpt bytes sunk to segment files
    io_seconds: float = 0.0  # modeled fwd-write + bwd-read transfer time

    @property
    def peak_bytes(self) -> int:
        """Predicted device-live peak: offloaded ckpt storage leaves the
        device, everything else stays (including, for the spill tiers, the
        segment staging buffer folded into work_bytes)."""
        if self.offload in ("host", "spill", "disk"):
            return self.work_bytes
        return self.ckpt_bytes + self.work_bytes


def spill_callback_counts(policy: str, n_steps: int, *,
                          ncheck: Optional[int] = None,
                          segment: Optional[int] = None) -> Dict[str, int]:
    """Host round trips one reverse pass issues on the spill tier: pnode's
    sweeps move ``segment`` checkpoints a trip (forward writes, backward
    prefetches); the revolve policies pay one per checkpoint-schedule
    action (puts/gets/frees)."""
    from repro_torch.core.implicit import _segment_bounds
    if policy == "pnode":
        seg = min(segment or default_segment(n_steps), n_steps)
        n_segments = -(-n_steps // seg)
        return {"forward": n_segments, "backward": n_segments,
                "total": 2 * n_segments}
    if policy == "revolve":
        fwd = ncheck + 1  # one put per sweep checkpoint
        bwd = 0
        for act in revolve_mod.reverse_schedule(n_steps, ncheck):
            bwd += {"advance": 2, "adjoint": 2, "free": 1}[act[0]]
        return {"forward": fwd, "backward": bwd, "total": fwd + bwd}
    if policy == "revolve2":
        nb = len(_segment_bounds(n_steps, ncheck))
        return {"forward": nb, "backward": 2 * nb, "total": 3 * nb}
    return {"forward": 0, "backward": 0, "total": 0}


#: state copies one implicit reverse step keeps in flight beyond the
#: transposed-GMRES Krylov basis (lam, lam_s, u_n, u_next)
_IMPLICIT_WORK_STATES = 4


def _implicit_policy_cost(policy: str, *, n_steps: int, state_bytes: int,
                          theta_bytes: int, ncheck: Optional[int],
                          offload: Optional[str], segment: Optional[int],
                          newton_iters: int, gmres_iters: int,
                          snaps_in_ram: Optional[int] = None,
                          method: str = "cn") -> CostEstimate:
    """Implicit-family Table-2 row: checkpoints are converged states only
    (S bytes a slot), work is Krylov-basis dominated, recompute is Newton
    solves."""
    if policy not in IMPLICIT_POLICIES:
        raise ValueError(
            f"policy {policy!r} is not available for implicit methods; "
            f"one of {IMPLICIT_POLICIES} (AD-through-the-solver policies "
            "have no reverse rule for the Newton/GMRES loops)")
    work = (int(gmres_iters) + _IMPLICIT_WORK_STATES) * state_bytes \
        + 3 * theta_bytes
    ckpt = implicit_checkpoint_floats(n_steps, policy, state_bytes,
                                      ncheck=ncheck)
    extra = implicit_nfe_backward(n_steps, policy, ncheck=ncheck,
                                  newton_iters=newton_iters,
                                  gmres_iters=gmres_iters)
    callbacks = 0
    if offload in ("spill", "disk"):
        callbacks = spill_callback_counts(policy, n_steps, ncheck=ncheck,
                                          segment=segment)["total"]
        if policy == "pnode":
            # segment staging buffer (states only: no stages to stage)
            seg = min(segment or default_segment(n_steps), n_steps)
            work += seg * state_bytes
    ram, disk, io = _offload_io(offload, int(ckpt), callbacks, method,
                                state_bytes, snaps_in_ram)
    return CostEstimate(policy=policy, ncheck=ncheck, offload=offload,
                        ckpt_bytes=int(ckpt), work_bytes=int(work),
                        extra_fevals=int(extra), reverse_accurate=True,
                        host_callbacks=int(callbacks), ram_bytes=ram,
                        disk_bytes=disk, io_seconds=io)


def policy_cost(policy: str, *, method: str, n_steps: int, state_bytes: int,
                theta_bytes: int = 0, f_act_bytes: Optional[int] = None,
                ncheck: Optional[int] = None,
                offload: Optional[str] = None,
                segment: Optional[int] = None,
                newton_iters: int = 10,
                gmres_iters: int = 20,
                snaps_in_ram: Optional[int] = None) -> CostEstimate:
    """Analytic (peak bytes, extra f-evals) for one policy instance.
    ``newton_iters``/``gmres_iters`` only affect implicit methods;
    ``snaps_in_ram`` prices the spill tier's RAM/disk slot split
    (``ram_bytes``/``disk_bytes``/``io_seconds`` columns)."""
    if is_implicit_method(method):
        return _implicit_policy_cost(policy, n_steps=n_steps,
                                     state_bytes=state_bytes,
                                     theta_bytes=theta_bytes, ncheck=ncheck,
                                     offload=offload, segment=segment,
                                     newton_iters=newton_iters,
                                     gmres_iters=gmres_iters,
                                     snaps_in_ram=snaps_in_ram,
                                     method=method)
    tab = get_tableau(method)
    s = tab.num_stages
    fa = f_act_bytes if f_act_bytes is not None else state_bytes
    # one step's stages + a few state copies in flight + grad accumulators
    work = (s + 3) * state_bytes + 3 * theta_bytes

    if policy in ("naive", "anode"):
        # AD through the (re)computed forward: every stage's f residuals
        ckpt = n_steps * s * fa
        if policy == "anode":
            ckpt += state_bytes  # the block-input checkpoint itself
    elif policy == "continuous":
        ckpt = 0
    else:
        ckpt = checkpoint_floats(method, n_steps, policy,
                                 state_bytes, ncheck=ncheck)
    extra = nfe_backward(method, n_steps, policy,
                         ncheck=ncheck) if policy != "naive" else 0
    callbacks = 0
    if offload in ("spill", "disk"):
        callbacks = spill_callback_counts(policy, n_steps, ncheck=ncheck,
                                          segment=segment)["total"]
        if policy == "pnode":
            # segment staging buffer: the batched sweeps hold one segment
            # of (state, stages) checkpoints on device between callbacks
            seg = min(segment or default_segment(n_steps), n_steps)
            work += seg * (s + 1) * state_bytes
    ram, disk, io = _offload_io(offload, int(ckpt), callbacks, method,
                                state_bytes, snaps_in_ram)
    return CostEstimate(policy=policy, ncheck=ncheck, offload=offload,
                        ckpt_bytes=int(ckpt), work_bytes=int(work),
                        extra_fevals=int(extra),
                        reverse_accurate=policy in REVERSE_ACCURATE,
                        host_callbacks=int(callbacks), ram_bytes=ram,
                        disk_bytes=disk, io_seconds=io)


def max_fitting_ncheck(budget: int, *, method: str, n_steps: int,
                       state_bytes: int, theta_bytes: int = 0,
                       newton_iters: int = 10,
                       gmres_iters: int = 20) -> Optional[int]:
    """Largest N_c whose revolve checkpoint set fits the byte budget
    (Table-2 storage (N_c+1)(N_s+1)S explicit, (N_c+1)S implicit — only
    converged states are stored), clamped to the valid [1, N_t-1] range;
    None if even N_c = 1 does not fit."""
    probe = policy_cost("revolve", method=method, n_steps=n_steps,
                        state_bytes=state_bytes, theta_bytes=theta_bytes,
                        ncheck=1, newton_iters=newton_iters,
                        gmres_iters=gmres_iters)
    avail = budget - probe.work_bytes
    if is_implicit_method(method):
        per_slot = state_bytes
    else:
        per_slot = (get_tableau(method).num_stages + 1) * state_bytes
    if per_slot <= 0:
        return n_steps - 1
    k = avail // per_slot - 1
    if k < 1:
        return None
    return int(min(k, n_steps - 1))


# ---------------------------------------------------------------------------
# measurement: the model's ground truth
# ---------------------------------------------------------------------------

class LiveTensors(TorchDispatchMode):
    """Tracks the bytes of the tensor storages that aten ops create while
    the mode is on: a storage counts from the op that returns it fresh
    (a return with no alias: not a view, not in place) until it is freed,
    which a weakref to it reports.  ``peak`` is the most that was live at
    once; storages that existed before the mode never count."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}
        self._finalizers = []

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if all(r.alias_info is None for r in func._schema.returns):
            for t in pytree.tree_leaves(out):
                if not torch.is_tensor(t):
                    continue
                st = t.untyped_storage()
                key = id(st)  # stable while the storage lives
                if key in self._sizes:
                    continue
                self._sizes[key] = st.nbytes()
                self.live += self._sizes[key]
                self.peak = max(self.peak, self.live)
                self._finalizers.append(weakref.finalize(st, self._free, key))
        return out

    def __exit__(self, *exc):
        super().__exit__(*exc)
        for fin in self._finalizers:
            fin.detach()
        self._finalizers.clear()


def live_tensor_peak(fn: Callable[[], Any]) -> int:
    """Peak bytes of the storages ``fn()`` creates that were live at once
    (``LiveTensors``), counting its result."""
    with LiveTensors() as tracker:
        out = fn()
    del out
    return tracker.peak


def allocator_peak(fn: Callable[[], Any], device: torch.device) -> int:
    """Peak bytes that the CUDA caching allocator held above what was
    allocated before ``fn()``, counting its result.  One warm-up call
    first, so that cuBLAS and cuDNN workspaces exist before the window,
    after the allocator's cached free blocks are released: a block cut
    from a cached segment can be up to 1 MiB larger than asked for, so
    the reading would depend on what earlier work left cached.  It
    resets the device's peak statistics."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    fn()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    out = fn()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del out
    return int(peak)


def reverse_pass(f: Callable, u0: PyTree, theta: PyTree, *, dt: float,
                 n_steps: int, t0: float = 0.0, method: str = "rk4",
                 policy: str = "pnode", ncheck: Optional[int] = None,
                 loss_fn: Optional[Callable] = None,
                 solver_opts: Optional[Dict[str, Any]] = None,
                 fused_stages: bool = False,
                 mem_budget: Optional[int] = None,
                 offload: Optional[str] = None
                 ) -> Callable[[], Tuple[torch.Tensor, ...]]:
    """A call that runs one gradient of ``loss_fn(u_final)`` (default: the
    sum of squares of ``u_final``) w.r.t. the floating leaves of ``u0`` and
    ``theta``, taken as new leaves on their storage, and returns it.
    ``policy="auto"`` with ``mem_budget`` solves through the planner;
    ``offload`` is the solve's checkpoint tier."""
    from repro_torch.core.adjoint import odeint  # late: import cycle
    from repro_torch.core.implicit import odeint_implicit

    def run():
        with torch.enable_grad():
            leaves, spec = pytree.tree_flatten((u0, theta))
            wrt = []
            for i, x in enumerate(leaves):
                if torch.is_tensor(x) and x.is_floating_point():
                    leaves[i] = x.detach().requires_grad_(True)
                    wrt.append(leaves[i])
            u0_, th_ = pytree.tree_unflatten(leaves, spec)
            if is_implicit_method(method):
                uf = odeint_implicit(f, u0_, th_, dt=dt, n_steps=n_steps,
                                     t0=t0, method=method, adjoint=policy,
                                     ncheck=ncheck, mem_budget=mem_budget,
                                     offload=offload, **(solver_opts or {}))
            else:
                uf = odeint(f, u0_, th_, dt=dt, n_steps=n_steps, t0=t0,
                            method=method, adjoint=policy, ncheck=ncheck,
                            mem_budget=mem_budget, fused_stages=fused_stages,
                            offload=offload)
            if loss_fn is not None:
                loss = loss_fn(uf)
            else:
                loss = sum(torch.sum(x * x) for x in pytree.tree_leaves(uf))
            return torch.autograd.grad(loss, wrt, allow_unused=True)

    return run


_MEASURE_CACHE: Dict[Tuple, Tuple[Tuple, Dict[str, Any]]] = {}
#: cache misses of ``measure_reverse_cost``: the gradients it has measured
measurements = 0


def _struct_key(tree: PyTree) -> Tuple:
    leaves, spec = pytree.tree_flatten(tree)
    return (str(spec),) + tuple(
        (tuple(x.shape), str(x.dtype)) if torch.is_tensor(x)
        else (type(x).__name__,) for x in leaves)


def _device_of(tree: PyTree) -> torch.device:
    for x in pytree.tree_leaves(tree):
        if torch.is_tensor(x):
            return x.device
    return torch.device("cpu")


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def measure_reverse_cost(f: Callable, u0: PyTree, theta: PyTree, *,
                         dt: float, n_steps: int, t0: float = 0.0,
                         method: str = "rk4", policy: str = "pnode",
                         ncheck: Optional[int] = None,
                         offload: Optional[str] = None,
                         loss_fn: Optional[Callable] = None,
                         solver_opts: Optional[Dict[str, Any]] = None,
                         fused_stages: bool = False) -> Dict[str, Any]:
    """Run one gradient of a scalar loss of the solve (``reverse_pass``)
    and measure its peak.  ``peak_bytes`` counts the bytes allocated above
    what was allocated before the gradient: its residuals, working set and
    result, not ``u0``/``theta`` themselves.  That is the number the
    model's ``peak_bytes`` is compared with.

      on the card  ``source="cuda_allocator"``: the caching allocator's
                   peak (``allocator_peak``: a warm-up gradient, then the
                   measured one), workspaces and 512-byte rounding included;
      on the CPU   ``source="live_tensors"``: the most bytes of tensor
                   storage live at once (``LiveTensors``).

    ``offload`` ("host", "spill", "disk") runs the gradient on that
    checkpoint tier: the device staging buffer and the prefetched segment
    count, the host copies (pinned tensors, numpy arrays, files) do not.

    ``argument_bytes`` are the bytes of ``u0`` and ``theta``.
    ``loss_fn(u_final) -> scalar`` measures the caller's loss; the default
    is the sum-of-squares surrogate.  ``solver_opts`` (newton_iters,
    newton_tol, gmres_iters, gmres_tol) goes to ``odeint_implicit`` for
    implicit methods.  ``fused_stages`` runs the checkpointing policies
    through the fused stage kernel, as the caller's solve will.

    Results are cached on (f and loss_fn identity, the structure, shapes
    and dtypes of u0 and theta, the device, the solve's configuration),
    with strong references to f and loss_fn, so a planner's walk measures
    each candidate once a process.  A miss while a CUDA graph is capturing
    raises ``RuntimeError``: measure before the capture (``StepGraph``'s
    eager warm-up does)."""
    global measurements
    fused = bool(fused_stages) and policy in _FUSED_POLICIES \
        and not is_implicit_method(method)
    device = _device_of((u0, theta))
    opts_key = None if solver_opts is None else \
        tuple(sorted(solver_opts.items()))
    key = (id(f), None if loss_fn is None else id(loss_fn), _struct_key(u0),
           _struct_key(theta), str(device), float(dt), int(n_steps),
           float(t0), method, policy, ncheck, opts_key, fused,
           None if offload == "device" else offload)
    hit = _MEASURE_CACHE.get(key)
    if hit is not None:
        return hit[1]
    if _capturing(device):
        raise RuntimeError(
            "measure_reverse_cost: no measurement of this solve is cached "
            "and a CUDA graph is capturing; a measurement synchronizes and "
            "resets the allocator's peak, which a capture forbids.  Run the "
            "call once eagerly before capturing it (StepGraph's warm-up "
            "does)")
    fn = reverse_pass(f, u0, theta, dt=float(dt), n_steps=int(n_steps),
                      t0=float(t0), method=method, policy=policy,
                      ncheck=ncheck, loss_fn=loss_fn,
                      solver_opts=solver_opts, fused_stages=fused,
                      offload=offload)
    if device.type == "cuda":
        peak, source = allocator_peak(fn, device), "cuda_allocator"
    else:
        peak, source = live_tensor_peak(fn), "live_tensors"
    out = {"peak_bytes": int(peak),
           "argument_bytes": tree_bytes(u0) + tree_bytes(theta),
           "source": source}
    measurements += 1
    # the entry keeps strong references to f / loss_fn: id() keys would
    # otherwise be reusable after garbage collection and alias different
    # functions
    _MEASURE_CACHE[key] = ((f, loss_fn), out)
    return out
