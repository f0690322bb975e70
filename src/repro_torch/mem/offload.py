"""Checkpoint stores: where adjoint checkpoints live between the forward
and the reverse sweep.

The revolve and pnode adjoints of ``core/adjoint.py``, the adaptive ring of
``core/adaptive.py`` and the eager implicit route of ``core/implicit.py``
write their (state, stages) checkpoints through one of these stores.  Four
tiers, the JAX package's (``repro/mem/offload.py``):

  device   the checkpoints stay device tensors in a Python dict (the
           solvers' own lists where they keep none), as without a store.
  host     slot-addressed: every ``put`` copies the slot's tensors into
           pinned CPU tensors (``pin_memory=True``) with
           ``copy_(non_blocking=True)`` on a dedicated copy stream; ``get``
           brings them back on the same stream and the compute stream
           waits on the copy's event.  With no CUDA device the tier
           degrades to ``device`` and says so in ``effective_tier``, as the
           JAX package does on a backend without a pinned memory space.
  spill    the checkpoints leave the device for a dict of host byte arrays
           (one ``numpy.uint8`` array a leaf a slot: raw bytes, so bf16 and
           fp64 round-trip and a CRC sees the exact payload).
  disk     the spill store with every slot in segment files
           (``repro_spill_*.npz`` under a temporary or caller directory).

Segment-batched I/O (the scanned sweeps): ``write_batch(base, tree)``
ships ``seg`` consecutive slots whose leaves are stacked on axis 0, one
device-to-host transfer a batch, and ``prefetch(base, seg)`` brings them
back stacked, one host-to-device transfer.  ``prefetch_issue(base, seg)``
hands the host-side gather of a later ``prefetch`` to the store's one
worker thread, so the reverse sweep reads segment k-1 from RAM or disk
while segment k's adjoint runs; the worker only fills a pinned buffer, and
the thread that consumes the data issues the copy to the device.  The slot
interface (``put``/``get``/``pop``/``free``) serves the revolve schedules
on every tier.

Transfers on the card go through one copy stream a device and a small pool
of pinned byte buffers reused across batches and stores.  A device-to-host
copy waits for the compute stream's work before it, records an event, and
marks its source with ``record_stream`` so the allocator cannot hand the
block out before the copy has read it; ``write_batch`` returns that event,
and a caller that overwrites the source (a staging buffer) makes the
compute stream wait on it first.  The host reads a pinned buffer only
after synchronizing on its copy's event: pending writes land in the RAM
dict or a file at the next operation of the store that reads (``get``,
``prefetch``, ``slot_census``, ``spill_stats``) or writes again.  A
host-to-device copy waits for the compute stream too (its target may be a
block the compute stream freed), and the compute stream waits on its
event before it reads the target.

Multi-tier split (``snaps_in_ram=K``): at most K slots stay in the RAM
dict and whole write batches overflow to disk files (a slot on the
revolve path follows the same rule), dolfin-adjoint's
``snaps_in_ram``/``snaps_on_disk``; ``make_store("disk")`` is the K = 0
corner.  A disk file holds one write batch (one ``np.savez`` extent, no
pickle), with a slot-to-file index, a one-file read cache, deletion once
its last slot is dropped, a sweep of stale files when a caller directory
is set (counted in ``swept_files``), and a ``weakref.finalize`` that
deletes the store's files and its own temporary directory.

``integrity=True`` records a crc32 over each slot's clean bytes when they
land on the host; ``prefetch_checked`` returns ``ok=False`` on a missing
slot or a mismatch and counts it in ``integrity_fail``, so the implicit
adjoint's ``resilient`` route can recompute the segment.

Fault injection (``make_store(fault_plan=...)``, a
``repro_torch.ft.FaultPlan``; spill and disk tiers): ``spill.write`` ticks
once a device-to-host transfer, on the caller's thread in issue order,
and its fault is applied where the transfer lands: ``drop`` stores
nothing for it, ``corrupt`` XORs the stored bytes after the crc32 is
taken (with the JAX package's per-slot salt, so the same plan corrupts
the same bytes).  ``spill.read`` ticks once a read attempt, also on the
caller's thread (the prefetch worker only gathers): a ``flake`` is
retried up to ``max_retries`` times with exponential backoff from
``retry_backoff_s``, each retry counted in ``retry_cb``; a read that
still flakes raises (its message says "retries"), except on the checked
route, where ``prefetch_checked`` returns ``ok=False`` and the caller
recomputes the segment.  A read never returns zeros for a flaked slot.
``effective_tier`` walks the degradation ladder past tiers a plan marks
down.

Flight recorder (``store.bind_obs(recorder)``): the device and host tiers
record ``store.put``/``store.get``/``store.free`` (``runtime=False``,
the schedule: once a call, or once at capture inside a ``StepGraph``);
the spill and disk tiers record ``spill.write``, ``spill.read``,
``spill.free``, ``spill.dispatch``, ``spill.retry`` and
``spill.integrity`` (``runtime=True``), with ``store``, ``base``,
``slots``, ``bytes`` and ``medium`` ("ram" or "disk").  A write is
recorded when it lands, with the medium it landed in.  The host work of
each is a ``host_annotation`` frame (``obs:spill/...``) under
``torch.profiler``.

Counters: every spill/disk store keeps its own (``store.stats``, by
``store_id``) and mirrors each increment into a process-wide aggregate
under one lock:
``spill_stats()``, ``per_store_spill_stats()``, ``reset_spill_stats()``,
with the JAX package's keys.  ``write_cb``/``read_cb`` count transfers (a
batch or a slot), ``*_slots`` the slots they moved, ``*_bytes`` their
payload; ``dispatch_cb`` the issued prefetches and ``prefetch_hit_cb`` the
prefetches they served.  ``store.copies`` counts the ``copy_`` calls a
store issued each way on the card (one a leaf a transfer).

Per-request lane keys (``ODEEngine``'s contract, the JAX package's):
``store.lane_keys = (rid_0, ..., rid_{B-1})``, one entry per lane of the
solve's batch (``None`` for a padding lane), splits each segment-batched
write into per-lane rows keyed ``(rid_b, base + i)``: padding lanes store
nothing, ``prefetch`` puts the block back together with zeros for them,
``request_slots(rid)`` counts one request's live slots and
``free_request(rid)`` drops them (a segment file goes with its last live
slot).  The lane axis of a checkpoint leaf is the leading axis of the
state leaf it holds: ``write_batch(lane_axes=)`` says where it sits in
each slot's leaf (0 by default; the pnode sweep's stacked stages carry it
second).  The keys are read when a transfer runs, once a transfer (the
landing of a card's batch uses the keys of its issue), never when a
program is built, so one program serves every batch composition.  With
``lane_keys = None`` every path moves the bytes and counts what it did
before.

Not here, as the JAX package's offload module has them: the token
threading, ``pure_callback`` and its payload cap, ``batch_scale`` and the
memory-kind query (the host is in control between kernels here).
"""
from __future__ import annotations

import glob
import itertools
import os
import shutil
import tempfile
import threading
import time
import weakref
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.mem.model import default_segment, tree_bytes
from repro_torch.obs.profile import host_annotation

__all__ = ["TIERS", "make_store", "effective_tier", "default_segment",
           "CheckpointStore", "DeviceStore", "HostStore", "SpillStore",
           "DiskStore", "spill_stats", "reset_spill_stats",
           "per_store_spill_stats"]

PyTree = Any

TIERS = ("device", "host", "spill", "disk")

#: filename prefix of the disk tier's segment files; a caller directory is
#: swept of stale matches (files left by a dead run) before it is used
_DISK_PREFIX = "repro_spill_"

#: byte alignment of each leaf's region in a host batch buffer (a typed
#: view of the buffer needs its offset to be a multiple of the item size)
_ALIGN = 64

#: counter keys of every spill/disk store (per store and in the aggregate),
#: the JAX package's: ``*_cb`` transfers, ``*_slots`` slots moved,
#: ``*_bytes`` payload; ``dispatch_cb`` issued prefetches,
#: ``prefetch_hit_cb`` prefetches served by one; ``disk_*_bytes`` the
#: traffic that hit segment files; ``ram_bytes_peak`` the RAM dict's
#: high-water mark (max-merged, not summed); ``retry_cb`` repeated reads
#: (none without a fault plan); ``integrity_fail`` slots that failed their
#: presence or checksum check
_STAT_KEYS = ("write_cb", "read_cb", "free_cb",
              "write_slots", "read_slots", "write_bytes", "read_bytes",
              "dispatch_cb", "prefetch_hit_cb",
              "disk_write_bytes", "disk_read_bytes", "ram_bytes_peak",
              "retry_cb", "integrity_fail")

#: guards all counter mutation and the reset, so that stores driven from
#: several threads count and reset atomically (the prefetch worker only
#: gathers; the threads that issue copies count)
_STATS_LOCK = threading.RLock()

#: process-wide aggregate, kept apart from the per-call store objects
_AGG: Dict[str, int] = {k: 0 for k in _STAT_KEYS}

#: live spill/disk stores by id, weakly
_STORES: "weakref.WeakValueDictionary[str, SpillStore]" = \
    weakref.WeakValueDictionary()
_STORE_IDS = itertools.count()


def reset_spill_stats() -> None:
    """Zero the aggregate and every live store's counters atomically."""
    with _STATS_LOCK:
        for k in _STAT_KEYS:
            _AGG[k] = 0
        for st in list(_STORES.values()):
            for k in _STAT_KEYS:
                st.stats[k] = 0


def _land_all() -> None:
    for st in list(_STORES.values()):
        st.sync()


def spill_stats() -> Dict[str, int]:
    """Copy of the aggregate counters of every spill/disk store, after the
    pending writes of the live stores have landed on the host."""
    _land_all()
    with _STATS_LOCK:
        return dict(_AGG)


def per_store_spill_stats() -> Dict[str, Dict[str, int]]:
    """Counters by ``store_id`` of every live spill/disk store that has
    counted something since its creation or the last reset."""
    _land_all()
    with _STATS_LOCK:
        return {sid: dict(st.stats) for sid, st in sorted(_STORES.items())
                if any(st.stats.values())}


#: degradation ladder: where a tier falls when a fault plan marks it down
_LADDER = {"spill": "disk", "disk": "host", "host": "device"}


def effective_tier(tier: Optional[str], fault_plan=None, *,
                   scanned: bool = False, obs=None) -> Optional[str]:
    """Walk the ladder spill -> disk -> host -> device past the tiers that
    ``fault_plan.tier_disabled(tier)`` says are down; the first tier up is
    returned.  ``scanned=True`` (a segment-batched sweep, which cannot use
    the slot-addressed host tier) sends a downed disk tier straight to the
    device.  Each hop is recorded on ``obs`` (``store.degrade``) when one
    is given."""
    if fault_plan is None or tier in (None, "device"):
        return tier
    cur = tier
    while cur not in (None, "device") and fault_plan.tier_disabled(cur):
        nxt = "device" if (scanned and cur == "disk") else _LADDER[cur]
        if obs is not None:
            obs.record("store.degrade", requested=tier, from_tier=cur,
                       to_tier=nxt, scanned=bool(scanned))
        cur = nxt
    return cur


def make_store(tier: Optional[str], *, fault_plan=None,
               integrity: bool = False, max_retries: int = 3,
               retry_backoff_s: float = 1e-3,
               snaps_in_ram: Optional[int] = None,
               disk_dir: Optional[str] = None) -> "CheckpointStore":
    """A store for ``tier`` (None is the device).  ``integrity`` turns on
    the per-slot crc32 of the spill/disk tiers (``prefetch_checked`` needs
    it), ``snaps_in_ram`` caps the RAM-resident slots of a spill store
    (the rest sink to disk files), ``disk_dir`` pins the segment files to
    a caller directory (swept of stale files; by default a temporary
    directory the store deletes).  ``fault_plan`` arms the spill/disk
    tiers' fault sites and ``max_retries``/``retry_backoff_s`` bound their
    read retries (module docstring).  ``store.requested_tier`` records what
    was asked for."""
    if tier in (None, "device"):
        st: CheckpointStore = DeviceStore()
    elif tier == "host":
        st = HostStore()
    elif tier in ("spill", "disk"):
        sp = DiskStore() if tier == "disk" else SpillStore()
        sp.fault_plan = fault_plan
        sp.integrity = bool(integrity)
        sp.max_retries = int(max_retries)
        sp.retry_backoff_s = float(retry_backoff_s)
        if tier == "spill" and snaps_in_ram is not None:
            sp.snaps_in_ram = int(snaps_in_ram)
        if disk_dir is not None:
            sp.set_disk_dir(disk_dir)
        st = sp
    else:
        raise ValueError(f"unknown offload tier {tier!r}; one of {TIERS}")
    st.requested_tier = tier
    return st


# ---------------------------------------------------------------------------
# the card's side: one copy stream a device, a pool of pinned buffers
# ---------------------------------------------------------------------------

_COPY_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The copy stream of a CUDA device (made on first use)."""
    i = _index(device)
    s = _COPY_STREAMS.get(i)
    if s is None:
        s = _COPY_STREAMS[i] = torch.cuda.Stream(device=i)
    return s


class _PinnedPool:
    """Pinned host byte buffers, each with the event of the last copy that
    used it, reused across batches and stores.  Only the thread that issues
    copies takes and gives buffers; a taken buffer belongs to its taker (the
    prefetch worker fills buffers it was handed)."""

    CAP = 4

    def __init__(self):
        self._free: List[Tuple[torch.Tensor, Any]] = []

    def take(self, nbytes: int) -> torch.Tensor:
        fits = [i for i, (b, _) in enumerate(self._free)
                if b.numel() >= nbytes]
        if fits:
            i = min(fits, key=lambda j: self._free[j][0].numel())
            buf, ev = self._free.pop(i)
            if ev is not None:
                ev.synchronize()
            return buf
        if len(self._free) >= self.CAP:
            self._free.pop(min(range(len(self._free)),
                               key=lambda j: self._free[j][0].numel()))
        return torch.empty(max(int(nbytes), 1), dtype=torch.uint8,
                           pin_memory=True)

    def give(self, buf: torch.Tensor, event=None) -> None:
        self._free.append((buf, event))
        while len(self._free) > self.CAP:
            self._free.pop(0)


_POOLS: Dict[int, _PinnedPool] = {}


def _pool(device: torch.device) -> _PinnedPool:
    return _POOLS.setdefault(_index(device), _PinnedPool())


def _no_capture() -> None:
    """A transfer synchronizes the host with its copy, which a CUDA-graph
    capture forbids: refuse clearly instead of failing inside it."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "offload: a checkpoint store's copies cannot run inside a "
            "CUDA-graph capture; solve with offload=None (the device tier) "
            "where the gradient is captured")


def wait_copy(event) -> None:
    """Make the current stream wait on a copy's event (None: nothing); a
    caller that overwrites a buffer ``write_batch`` read from calls it
    first."""
    if event is not None:
        torch.cuda.current_stream().wait_event(event)


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = dtype.itemsize
    for d in shape:
        n *= int(d)
    return n


def _regions(metas, m: int) -> Tuple[List[int], int]:
    """Byte offsets of each leaf's region of a batch of ``m`` slots, and the
    batch's total, each region aligned to ``_ALIGN``."""
    offs, off = [], 0
    for shape, dtype in metas:
        offs.append(off)
        off += -(-m * _nbytes(shape, dtype) // _ALIGN) * _ALIGN
    return offs, off


def _bytes_of(x: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bytes as a flat numpy view (no copy)."""
    x = x.detach().contiguous()
    if x.numel() == 0:
        return np.zeros(0, np.uint8)
    return x.reshape(-1).view(torch.uint8).numpy()


def _crc_leaves(arrs) -> int:
    """One crc32 over the concatenated bytes of a slot's leaves (the JAX
    package's checksum: the same bytes give the same value)."""
    c = 0
    for a in arrs:
        c = zlib.crc32(np.ascontiguousarray(a).tobytes(), c)
    return c


def _slot_salt(slot) -> int:
    """The corruption salt of a slot key (the JAX package's): an int
    passes through, another key hashes through the crc32 of its repr,
    stable across processes."""
    if isinstance(slot, (int, np.integer)):
        return int(slot)
    return zlib.crc32(repr(slot).encode("utf-8"))


def _lane_take(row: np.ndarray, shape, dtype: torch.dtype, axis: int,
               b: int) -> np.ndarray:
    """Lane ``b``'s bytes of one slot's leaf (``row``: the raw bytes of a
    ``shape`` tensor): its slice at index ``b`` of ``axis``."""
    v = row.reshape(tuple(shape) + (dtype.itemsize,))
    return np.ascontiguousarray(v[(slice(None),) * axis + (b,)]).reshape(-1)


def _lane_put(dst: np.ndarray, shape, dtype: torch.dtype, axis: int, b: int,
              row: np.ndarray) -> None:
    """Write lane ``b``'s bytes ``row`` into ``dst``, the raw bytes of one
    slot's ``shape`` leaf (the inverse of ``_lane_take``)."""
    v = dst.reshape(tuple(shape) + (dtype.itemsize,))
    sub = v[(slice(None),) * axis + (b,)]
    sub[...] = row.reshape(sub.shape)


def _cleanup_disk(paths: List[str], root: Optional[str], owned: bool) -> None:
    """``weakref.finalize`` target: delete a store's segment files and, if
    the store made its own directory, the directory."""
    for p in paths:
        try:
            os.unlink(p)
        except OSError:
            pass
    if owned and root:
        shutil.rmtree(root, ignore_errors=True)


def _shutdown_exec(ex) -> None:
    ex.shutdown(wait=False)


# ---------------------------------------------------------------------------
# the stores
# ---------------------------------------------------------------------------

class CheckpointStore:
    """The common interface.  Slot-addressed (revolve): ``put(slot,
    tree)``, ``get(slot)``, ``pop(slot)`` (get, then free), ``free(slot)``.
    Segment-batched (spill and disk only): ``write_batch(base, tree)``,
    ``prefetch(base, seg)``, ``prefetch_checked(base, seg)`` and
    ``prefetch_issue(base, seg)``."""

    tier = "device"

    def __init__(self):
        self._vals: Dict[Any, PyTree] = {}
        self.effective_tier = self.tier
        self.requested_tier = self.tier
        self.store_id = f"{self.tier}-{next(_STORE_IDS)}"
        #: ``copy_`` calls issued on the card, each way
        self.copies = {"d2h": 0, "h2d": 0}
        self._obs = None

    def bind_obs(self, recorder) -> None:
        """Attach a ``repro_torch.obs.FlightRecorder`` (module
        docstring).  The recorder lands this store's pending writes before
        it reads its events."""
        self._obs = recorder
        recorder.watch(self)

    def _note(self, kind: str, slot, tree: PyTree = None) -> None:
        if self._obs is None:
            return
        self._obs.record(kind, store=self.store_id,
                         tier=self.effective_tier, slot=slot,
                         bytes=tree_bytes(tree) if tree is not None else 0)

    # -- slot-addressed ------------------------------------------------------
    def put(self, slot, tree: PyTree) -> None:
        self._note("store.put", slot, tree)
        self._vals[slot] = self._to_store(tree)

    def get(self, slot) -> PyTree:
        tree = self._from_store(self._vals[slot])
        self._note("store.get", slot, tree)
        return tree

    def pop(self, slot) -> PyTree:
        tree = self._from_store(self._vals.pop(slot))
        self._note("store.get", slot, tree)
        self._note("store.free", slot)
        return tree

    def free(self, slot) -> None:
        self._note("store.free", slot)
        self._vals.pop(slot, None)

    # -- segment-batched -----------------------------------------------------
    def write_batch(self, base: int, tree: PyTree):
        raise NotImplementedError(
            f"offload tier {self.tier!r} does not support segment-batched "
            "checkpoint writes; use 'spill' or 'disk'")

    def prefetch(self, base: int, seg: int, out=None):
        raise NotImplementedError(
            f"offload tier {self.tier!r} does not support segment "
            "prefetch; use 'spill' or 'disk'")

    def prefetch_checked(self, base: int, seg: int, out=None):
        raise NotImplementedError(
            f"offload tier {self.tier!r} does not support segment "
            "prefetch; use 'spill' or 'disk'")

    def prefetch_issue(self, base: int, seg: int) -> None:
        """A no-op on tiers without host I/O."""

    def sync(self) -> None:
        """Land pending writes on the host (a no-op without any)."""

    # -- transfer points -----------------------------------------------------
    def _to_store(self, tree: PyTree) -> PyTree:
        return tree

    def _from_store(self, tree: PyTree) -> PyTree:
        return tree


class DeviceStore(CheckpointStore):
    tier = "device"


class HostStore(CheckpointStore):
    """Pinned host tensors a slot, copied on the copy stream (degrades to
    the device tier without a CUDA device)."""

    tier = "host"

    def __init__(self):
        super().__init__()
        self.effective_tier = "host" if torch.cuda.is_available() \
            else "device"

    def _to_store(self, tree: PyTree) -> PyTree:
        leaves, spec = pytree.tree_flatten(tree)
        cuda = [torch.is_tensor(x) and x.is_cuda for x in leaves]
        if self.effective_tier != "host" or not any(cuda):
            return ("as_is", tree)
        dev = next(x.device for x, c in zip(leaves, cuda) if c)
        _no_capture()
        stream = _copy_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        out = []
        with torch.cuda.stream(stream):
            for x, c in zip(leaves, cuda):
                if not c:
                    out.append(x)
                    continue
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x.detach(), non_blocking=True)
                x.record_stream(stream)
                self.copies["d2h"] += 1
                out.append((h, x.device))
        return ("pinned", spec, out, cuda)

    def _from_store(self, packed) -> PyTree:
        if packed[0] == "as_is":
            return packed[1]
        _, spec, held, cuda = packed
        dev = next(h[1] for h, c in zip(held, cuda) if c)
        # targets are allocated on the compute stream; the copy stream
        # waits for it, as a target may be a block it freed
        targets = [torch.empty(h[0].shape, dtype=h[0].dtype, device=h[1])
                   if c else None for h, c in zip(held, cuda)]
        stream = _copy_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for t, h, c in zip(targets, held, cuda):
                if c:
                    t.copy_(h[0], non_blocking=True)
                    self.copies["h2d"] += 1
            ev = torch.cuda.Event()
            ev.record(stream)
        wait_copy(ev)
        return pytree.tree_unflatten(
            [t if c else h for t, h, c in zip(targets, held, cuda)], spec)


class SpillStore(CheckpointStore):
    """Host-side spill: slot payloads (raw bytes a leaf) in a RAM dict and,
    past ``snaps_in_ram`` slots, in disk segment files.  All host-side slot
    state is guarded by ``_io_lock``: the prefetch worker gathers
    concurrently with the caller."""

    tier = "spill"

    def __init__(self):
        super().__init__()
        self._host: Dict[Any, List[np.ndarray]] = {}
        #: per-slot leaf metadata, as the JAX package keys it: "slot" for
        #: the slot-addressed path, "idx" for the segment-batched one
        self._meta: Dict[str, Tuple[Any, List[Tuple[tuple, torch.dtype]]]] \
            = {}
        self.stats: Dict[str, int] = {k: 0 for k in _STAT_KEYS}
        _STORES[self.store_id] = self
        #: fault plan and integrity/retry knobs (``make_store``); dormant
        #: by default
        self.fault_plan = None
        self.integrity = False
        self.max_retries = 3
        self.retry_backoff_s = 1e-3
        self._sums: Dict[Any, int] = {}
        self.snaps_in_ram: Optional[int] = None
        self._ram_bytes = 0
        self._disk_dir: Optional[str] = None
        self._disk_dir_owned = False
        self._disk: Dict[Any, str] = {}            # slot -> segment file
        self._file_slots: Dict[str, set] = {}      # file -> live slots
        self._created: List[str] = []              # files this store made
        self._read_cache: Tuple[Optional[str], Optional[dict]] = (None, None)
        self._file_seq = itertools.count()
        self.swept_files = 0
        self._io_lock = threading.RLock()
        self._exec = None
        #: issued gathers by base: (future, host buffer, seg, lanes)
        self._inflight: Dict[int, Tuple[Any, Any, int, Any]] = {}
        #: device-to-host batches in flight: (slots, pinned buffer, region
        #: offsets, per-slot leaf metas, event, device, fault spec, bytes,
        #: lane keys of the transfer)
        self._pending: List[tuple] = []
        self._dev = torch.device("cpu")
        #: per-request lane keys (module docstring): one request id a lane
        #: of the solve's batch, None for a padding lane; read when a
        #: transfer runs, so set them between solves to re-key a program
        self.lane_keys: Optional[Tuple[Any, ...]] = None

    # -- disk backend ----------------------------------------------------------
    def set_disk_dir(self, path: str) -> None:
        """Pin the segment files to a caller directory.  Stale
        ``repro_spill_*.npz`` files there (a dead run's) are deleted and
        counted in ``swept_files``; this store's own files go at GC, the
        directory stays."""
        os.makedirs(path, exist_ok=True)
        swept = 0
        for p in glob.glob(os.path.join(path, _DISK_PREFIX + "*.npz")):
            try:
                os.unlink(p)
                swept += 1
            except OSError:  # pragma: no cover - races with an external rm
                pass
        self.swept_files = swept
        self._disk_dir = path
        self._disk_dir_owned = False
        weakref.finalize(self, _cleanup_disk, self._created, path, False)

    def _disk_root(self) -> str:
        if self._disk_dir is None:
            self._disk_dir = tempfile.mkdtemp(prefix="repro-spill-")
            self._disk_dir_owned = True
            weakref.finalize(self, _cleanup_disk, self._created,
                             self._disk_dir, True)
        return self._disk_dir

    def _host_insert(self, slot, leaves) -> None:
        # under _io_lock
        old = self._host.get(slot)
        if old is not None:
            self._ram_bytes -= sum(a.nbytes for a in old)
        self._host[slot] = leaves
        self._ram_bytes += sum(a.nbytes for a in leaves)
        with _STATS_LOCK:
            if self._ram_bytes > self.stats["ram_bytes_peak"]:
                self.stats["ram_bytes_peak"] = self._ram_bytes
            if self._ram_bytes > _AGG["ram_bytes_peak"]:
                _AGG["ram_bytes_peak"] = self._ram_bytes

    def _drop_slot(self, slot) -> None:
        """Remove every copy of ``slot``; a segment file goes with its last
        live slot."""
        with self._io_lock:
            old = self._host.pop(slot, None)
            if old is not None:
                self._ram_bytes -= sum(a.nbytes for a in old)
            path = self._disk.pop(slot, None)
            if path is not None:
                live = self._file_slots.get(path)
                if live is not None:
                    live.discard(slot)
                    if not live:
                        self._file_slots.pop(path, None)
                        if self._read_cache[0] == path:
                            self._read_cache = (None, None)
                        try:
                            os.unlink(path)
                        except OSError:  # pragma: no cover
                            pass

    def _ram_has_room(self, slots) -> bool:
        # under _io_lock
        if self.snaps_in_ram is None:
            return True
        projected = len(self._host) + sum(1 for s in slots
                                          if s not in self._host)
        return projected <= self.snaps_in_ram

    def _disk_write_rows(self, rows: Dict[Any, List[np.ndarray]]) -> int:
        # under _io_lock; one savez extent a write batch, no pickle
        path = os.path.join(
            self._disk_root(),
            f"{_DISK_PREFIX}{self.store_id}_{next(self._file_seq)}.npz")
        np.savez(path, **{f"s{slot}_l{k}": a for slot, leaves in rows.items()
                          for k, a in enumerate(leaves)})
        self._created.append(path)
        self._file_slots[path] = set(rows)
        for slot in rows:
            # a rewrite supersedes any earlier copy in either medium
            self._drop_slot(slot)
            self._disk[slot] = path
            self._file_slots[path].add(slot)
        return sum(a.nbytes for leaves in rows.values() for a in leaves)

    def _store_rows(self, rows: Dict[Any, List[np.ndarray]]) -> str:
        """Route a batch of slots to RAM or to one disk file, by
        ``snaps_in_ram``; returns the medium ("ram" or "disk")."""
        if not rows:
            return "ram"
        with self._io_lock:
            if self._ram_has_room(rows):
                for slot, leaves in rows.items():
                    if slot in self._disk:
                        self._drop_slot(slot)
                    self._host_insert(slot, leaves)
                return "ram"
            dbytes = self._disk_write_rows(rows)
        self._tally_counter("disk_write_bytes", dbytes)
        return "disk"

    def _disk_read_slot(self, slot):
        # under _io_lock; the one-file cache fits the segment-aligned reads
        path = self._disk.get(slot)
        if path is None:
            return None
        cpath, cdata = self._read_cache
        if cpath != path:
            with np.load(path, allow_pickle=False) as z:
                cdata = {k: z[k] for k in z.files}
            self._read_cache = (path, cdata)
        leaves, k = [], 0
        while f"s{slot}_l{k}" in cdata:
            leaves.append(cdata[f"s{slot}_l{k}"])
            k += 1
        return leaves or None

    def _slot_read_any(self, slot):
        """(leaves, disk bytes read) of one slot from whichever medium
        holds it; (None, 0) if it is missing."""
        with self._io_lock:
            leaves = self._host.get(slot)
            if leaves is not None:
                return leaves, 0
            leaves = self._disk_read_slot(slot)
            if leaves is None:
                return None, 0
            return leaves, sum(a.nbytes for a in leaves)

    def slot_census(self) -> Dict[str, int]:
        """Live slots by medium, after pending writes have landed."""
        self.sync()
        with self._io_lock:
            return {"ram": len(self._host), "disk": len(self._disk),
                    "disk_files": len(self._file_slots)}

    # -- lane keys ------------------------------------------------------------
    @staticmethod
    def _check_lanes(metas, axes, keys) -> None:
        """Every leaf must carry the lane axis, with one lane a key: anything
        else is a serving engine's wiring fault (the JAX package's
        errors)."""
        for (shape, _), ax in zip(metas, axes):
            if len(shape) <= ax:
                raise ValueError(
                    f"lane_keys requires exactly one mapped batch axis on "
                    f"every checkpoint leaf, got a slot leaf of shape "
                    f"{tuple(shape)} with no axis {ax} (solve the request "
                    "batch as the leading axis of the state)")
            if shape[ax] != len(keys):
                raise ValueError(
                    f"lane_keys has {len(keys)} entries but the mapped batch "
                    f"axis has {shape[ax]} lanes")

    def _lanes(self, metas, axes):
        """The lane keys as this transfer sees them (one snapshot a
        transfer), checked against its leaves, with their axes; None
        without keys."""
        keys = self.lane_keys
        if keys is None:
            return None
        keys = tuple(keys)
        self._check_lanes(metas, axes, keys)
        return keys, tuple(axes)

    def _request_keys(self, request_id) -> List[Any]:
        # under _io_lock
        return [k for k in set(self._host) | set(self._disk)
                if isinstance(k, tuple) and k[0] == request_id]

    def request_slots(self, request_id) -> int:
        """Live lane-keyed slots of one request (both media)."""
        self.sync()
        with self._io_lock:
            return len(self._request_keys(request_id))

    def free_request(self, request_id) -> int:
        """Drop every lane-keyed slot of a departed request, in both media
        (a segment file goes with its last live slot); its batch-mates'
        slots stay.  Called between solves, never while one that still
        reads the slots runs.  Returns the number of slots dropped."""
        self.sync()
        with host_annotation("spill/free_request"):
            self._settle()
            with self._io_lock:
                victims = self._request_keys(request_id)
                for k in victims:
                    self._drop_slot(k)
                    self._sums.pop(k, None)
            if victims:
                self._tally_counter("free_cb")
            self._event("spill.free_request", request=request_id,
                        slots=len(victims))
        return len(victims)

    def clear(self) -> None:
        """Land pending writes and drop every slot now (segment files
        included); the prefetch worker keeps running."""
        self.sync()
        self._settle()
        self._inflight.clear()
        with self._io_lock:
            for slot in list(self._host) + list(self._disk):
                self._drop_slot(slot)
            self._sums.clear()

    def close(self) -> None:
        """``clear``, and stop the prefetch worker now rather than at
        garbage collection.  The store stays usable."""
        self.clear()
        if self._exec is not None:
            self._exec.shutdown(wait=True)
            self._exec = None

    # -- counters --------------------------------------------------------------
    def _tally_counter(self, key: str, n: int = 1) -> None:
        with _STATS_LOCK:
            self.stats[key] += n
            _AGG[key] += n

    def _tally(self, direction: str, *, slots: int, nbytes: int,
               disk_bytes: int = 0) -> None:
        keys = [(f"{direction}_cb", 1), (f"{direction}_slots", slots),
                (f"{direction}_bytes", nbytes)]
        if direction == "read" and disk_bytes:
            keys.append(("disk_read_bytes", disk_bytes))
        with _STATS_LOCK:
            for key, n in keys:
                self.stats[key] += n
                _AGG[key] += n

    def _event(self, kind: str, **data) -> None:
        if self._obs is not None:
            self._obs.record(kind, _runtime=True, store=self.store_id,
                             **data)

    def _read_attempt_ok(self, base) -> bool:
        """One logical read, retried with exponential backoff while the
        fault plan flakes it.  Every attempt ticks ``spill.read`` on the
        caller's thread (a spec's ``count`` window spans retries:
        transient faults are escaped by retrying, persistent ones exhaust
        the budget).  False only when all ``max_retries`` retries
        flaked."""
        if self.fault_plan is None:
            return True
        for attempt in range(self.max_retries + 1):
            spec = self.fault_plan.tick("spill.read")
            if spec is None or spec.kind != "flake":
                return True
            if attempt == self.max_retries:
                return False
            self._tally_counter("retry_cb")
            self._event("spill.retry", base=base, attempt=attempt + 1)
            time.sleep(self.retry_backoff_s * (2 ** attempt))
        return False

    def _leaves_intact(self, slot, leaves) -> bool:
        """Present and, with integrity on, matching the write-time crc32."""
        if leaves is None:
            return False
        if not self.integrity:
            return True
        want = self._sums.get(slot)
        return want is None or _crc_leaves(leaves) == want

    # -- device <-> host --------------------------------------------------------
    def _device(self, leaves) -> torch.device:
        return next((x.device for x in leaves if torch.is_tensor(x)),
                    torch.device("cpu"))

    def _send(self, slots: List[Any], leaves: List[torch.Tensor],
              metas, lanes=None) -> Optional["torch.cuda.Event"]:
        """Copy ``len(slots)`` slots whose leaves are stacked on axis 0 to
        the host; on the card as one pending batch (landed later), on the
        CPU at once.  The transfer ticks ``spill.write`` here, in issue
        order; its fault applies where it lands, and so does the lane split
        of ``lanes`` (the keys of this transfer and their axes).  Returns
        the card's copy event."""
        m = len(slots)
        dev = self._device(leaves)
        spec = (self.fault_plan.tick("spill.write")
                if self.fault_plan is not None else None)
        nbytes = sum(x.numel() * x.element_size() for x in leaves)
        if dev.type != "cuda":
            views = [_bytes_of(x).reshape(m, -1) for x in leaves]
            self._land(slots, [[v[i] for v in views] for i in range(m)],
                       spec, nbytes, lanes, metas)
            return None
        _no_capture()
        self.sync()  # one batch in flight a store: its buffer is freed
        offs, total = _regions(metas, m)
        buf = _pool(dev).take(total)
        stream = _copy_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for x, off, (shape, dtype) in zip(leaves, offs, metas):
                n = m * _nbytes(shape, dtype)
                if n == 0:
                    continue
                buf[off:off + n].view(dtype).view((m,) + tuple(shape)).copy_(
                    x.detach(), non_blocking=True)
                x.record_stream(stream)
                self.copies["d2h"] += 1
            ev = torch.cuda.Event()
            ev.record(stream)
        self._pending.append((slots, buf, offs, metas, ev, dev, spec, nbytes,
                              lanes))
        return ev

    def sync(self) -> None:
        """Land every pending device-to-host batch: wait for its copy, then
        move its bytes into the RAM dict or a disk file."""
        while self._pending:
            slots, buf, offs, metas, ev, dev, spec, nbytes, lanes = \
                self._pending.pop(0)
            ev.synchronize()  # the host reads the buffer only after this
            host = buf.numpy()
            rows = []
            for i in range(len(slots)):
                row = []
                for off, (shape, dtype) in zip(offs, metas):
                    rb = _nbytes(shape, dtype)
                    row.append(host[off + i * rb:off + (i + 1) * rb])
                rows.append(row)
            self._land(slots, rows, spec, nbytes, lanes, metas)
            _pool(dev).give(buf)

    def _settle(self) -> None:
        """Wait for the issued gathers: a write or a free after an issue
        must not change what that issue reads."""
        for fut, *_ in list(self._inflight.values()):
            fut.exception()

    def _land(self, slots, rows, spec=None, nbytes: int = 0, lanes=None,
              metas=None) -> None:
        """Copy each slot's leaf bytes off their buffer (split into per-lane
        rows keyed ``(lane key, slot)`` when ``lanes`` is given, padding
        lanes dropped), checksum them when integrity is on, apply the
        transfer's ``spill.write`` fault (the checksum is over the clean
        bytes: corruption at rest), and store them."""
        with host_annotation("spill/write"):
            self._settle()
            base, n = (slots[0] if slots else -1), len(slots)
            if lanes is not None:
                keys, axes = lanes
                keyed = [((rk, slot), [_lane_take(a, shape, dtype, ax, b)
                                       for a, (shape, dtype), ax
                                       in zip(row, metas, axes)])
                         for b, rk in enumerate(keys) if rk is not None
                         for slot, row in zip(slots, rows)]
                slots = [k for k, _ in keyed]
                rows = [r for _, r in keyed]
            out = {}
            for slot, row in zip(slots, rows):
                arrs = [np.array(a, dtype=np.uint8, copy=True) for a in row]
                if self.integrity:
                    self._sums[slot] = _crc_leaves(arrs)
                if spec is not None and spec.kind == "drop":
                    self._drop_slot(slot)
                    continue
                if spec is not None and spec.kind == "corrupt":
                    arrs = self.fault_plan.corrupt_arrays(
                        arrs, salt=_slot_salt(slot))
                out[slot] = arrs
            medium = self._store_rows(out)
            self._event("spill.write", base=base, slots=n, bytes=nbytes,
                        medium=medium)

    def _gather(self, host: np.ndarray, offs, metas, base: int, seg: int,
                lanes=None):
        """Fill a host batch buffer with slots ``[base, base+seg)`` (zeros
        for a missing slot), with ``lanes`` from each lane's keyed rows
        (zeros for a padding lane).  Returns (disk bytes, [(slot key,
        leaves or None)] of the slots that should be there); raw I/O only,
        so the prefetch worker can run it."""
        dbytes, got = 0, []
        with self._io_lock:
            for i in range(seg):
                dsts = [(host[off + i * _nbytes(shape, dtype):
                              off + (i + 1) * _nbytes(shape, dtype)],
                         shape, dtype) for off, (shape, dtype)
                        in zip(offs, metas)]
                if lanes is None:
                    leaves, db = self._slot_read_any(base + i)
                    got.append((base + i, leaves))
                    dbytes += db
                    for k, (dst, _, _) in enumerate(dsts):
                        dst[:] = 0 if leaves is None else leaves[k]
                    continue
                keys, axes = lanes
                for dst, _, _ in dsts:
                    dst[:] = 0
                for b, rk in enumerate(keys):
                    if rk is None:  # padding lane: nothing stored
                        continue
                    leaves, db = self._slot_read_any((rk, base + i))
                    got.append(((rk, base + i), leaves))
                    dbytes += db
                    if leaves is None:
                        continue
                    for (dst, shape, dtype), ax, a in zip(dsts, axes, leaves):
                        _lane_put(dst, shape, dtype, ax, b, a)
        return dbytes, got

    def _host_buffer(self, dev: torch.device, nbytes: int):
        """A host batch buffer: pinned from the pool on the card, a fresh
        numpy array on the CPU."""
        if dev.type == "cuda":
            return _pool(dev).take(nbytes)
        return np.empty(max(nbytes, 1), np.uint8)

    def _receive(self, buf, offs, metas, m: int, dev: torch.device,
                 out=None) -> List[torch.Tensor]:
        """Copy a filled host batch of ``m`` slots to ``dev``: into ``out``
        (tensors of the stacked shapes) or into new tensors."""
        if out is None:
            out = [torch.empty((m,) + tuple(shape), dtype=dtype, device=dev)
                   for shape, dtype in metas]
        if dev.type != "cuda":
            for t, off, (shape, dtype) in zip(out, offs, metas):
                n = m * _nbytes(shape, dtype)
                if n:
                    t.copy_(torch.from_numpy(buf[off:off + n]).view(dtype)
                            .view(t.shape))
            return out
        _no_capture()
        stream = _copy_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for t, off, (shape, dtype) in zip(out, offs, metas):
                n = m * _nbytes(shape, dtype)
                if n:
                    t.copy_(buf[off:off + n].view(dtype).view(t.shape),
                            non_blocking=True)
                    self.copies["h2d"] += 1
            ev = torch.cuda.Event()
            ev.record(stream)
        wait_copy(ev)
        _pool(dev).give(buf, ev)
        return out

    @staticmethod
    def _metas(leaves, strip: bool):
        return [(tuple(x.shape[1:]) if strip else tuple(x.shape), x.dtype)
                for x in leaves]

    # -- slot-addressed ----------------------------------------------------------
    def put(self, slot, tree: PyTree) -> None:
        leaves, spec = pytree.tree_flatten(tree)
        self._meta["slot"] = (spec, self._metas(leaves, strip=False))
        self._dev = self._device(leaves)
        self._send([slot], [x.unsqueeze(0) for x in leaves],
                   self._meta["slot"][1])
        self._tally("write", slots=1,
                    nbytes=sum(x.numel() * x.element_size() for x in leaves))

    def _read_slot(self, slot):
        self.sync()
        with host_annotation("spill/read"):
            return self._read_slot_host(slot)

    def _read_slot_host(self, slot):
        if not self._read_attempt_ok(slot):
            # the slot-addressed schedule has no recompute fallback
            raise RuntimeError(
                f"spill store: read of slot {slot} still failing after "
                f"{self.max_retries} retries")
        leaves, dbytes = self._slot_read_any(slot)
        if leaves is None:
            # a schedule bug or a reordered free: fail loudly rather than
            # contribute zero gradients
            raise KeyError(f"spill store: slot {slot} read before it was "
                           "written (or after free)")
        if not self._leaves_intact(slot, leaves):
            self._tally_counter("integrity_fail")
            raise RuntimeError(
                f"spill store: slot {slot} failed its integrity check "
                "(checksum mismatch) and the slot-addressed path has no "
                "recompute fallback")
        spec, metas = self._meta["slot"]
        offs, total = _regions(metas, 1)
        buf = self._host_buffer(self._dev, total)
        host = buf.numpy() if torch.is_tensor(buf) else buf
        for off, a in zip(offs, leaves):
            host[off:off + a.nbytes] = a
        out = self._receive(buf, offs, metas, 1, self._dev)
        nbytes = sum(_nbytes(s, d) for s, d in metas)
        self._tally("read", slots=1, nbytes=nbytes, disk_bytes=dbytes)
        self._event("spill.read", base=slot, slots=1, bytes=nbytes,
                    medium="disk" if dbytes else "ram")
        return pytree.tree_unflatten([t[0] for t in out], spec)

    def get(self, slot) -> PyTree:
        return self._read_slot(slot)

    def pop(self, slot) -> PyTree:
        tree = self._read_slot(slot)
        self.free(slot)
        return tree

    def free(self, slot) -> None:
        self.sync()  # a pending write of the slot must not land after this
        with host_annotation("spill/free"):
            self._settle()
            self._drop_slot(slot)
            self._sums.pop(slot, None)
            self._tally_counter("free_cb")
            self._event("spill.free", base=slot, slots=1, bytes=0,
                        medium="ram")

    # -- segment-batched ---------------------------------------------------------
    def write_batch(self, base: int, tree: PyTree, lane_axes=None):
        """Store slots ``[base, base+seg)`` whose leaves are stacked on axis
        0, as one transfer.  ``lane_axes`` gives each leaf's lane axis
        within a slot (0 for every leaf by default), which the lane keys
        split on.  Returns the copy's event on the card (the caller makes
        the compute stream wait on it before it overwrites the source),
        None on the CPU."""
        leaves, spec = pytree.tree_flatten(tree)
        metas = self._metas(leaves, strip=True)
        axes = (tuple(int(a) for a in lane_axes) if lane_axes is not None
                else (0,) * len(leaves))
        self._meta["idx"] = (spec, metas, axes)
        seg = int(leaves[0].shape[0]) if leaves else 0
        self._dev = self._device(leaves)
        ev = self._send([base + i for i in range(seg)], leaves, metas,
                        self._lanes(metas, axes))
        self._tally("write", slots=seg,
                    nbytes=sum(x.numel() * x.element_size() for x in leaves))
        return ev

    def prefetch_issue(self, base: int, seg: int) -> None:
        """Hand the host-side gather of slots ``[base, base+seg)`` to the
        store's worker thread; the ``prefetch`` at the same base consumes
        it.  The copy to the device stays with the consumer."""
        if "idx" not in self._meta:
            return  # nothing written yet: the prefetch reads cold
        self.sync()  # the worker reads landed slots only
        _, metas, axes = self._meta["idx"]
        lanes = self._lanes(metas, axes)
        offs, total = _regions(metas, seg)
        buf = self._host_buffer(self._dev, total)
        host = buf.numpy() if torch.is_tensor(buf) else buf
        if self._exec is None:
            from concurrent.futures import ThreadPoolExecutor
            self._exec = ThreadPoolExecutor(
                max_workers=1,
                thread_name_prefix=f"spill-prefetch-{self.store_id}")
            weakref.finalize(self, _shutdown_exec, self._exec)
        fut = self._exec.submit(self._gather, host, offs, metas, base, seg,
                                lanes)
        self._inflight[base] = (fut, buf, seg, lanes)
        self._tally_counter("dispatch_cb")
        self._event("spill.dispatch", base=base, slots=seg)

    def _fetch(self, base: int, seg: int, checked: bool, out):
        self.sync()
        with host_annotation("spill/prefetch"):
            return self._fetch_host(base, seg, checked, out)

    def _fetch_host(self, base: int, seg: int, checked: bool, out):
        ok = self._read_attempt_ok(base)
        if not ok and not checked:
            raise RuntimeError(
                f"spill store: prefetch at base {base} still failing after "
                f"{self.max_retries} retries and this path has no "
                "recompute fallback")
        spec, metas, axes = self._meta["idx"]
        lanes = self._lanes(metas, axes)
        offs, total = _regions(metas, seg)
        hit = None
        staged = self._inflight.pop(base, None)
        if staged is not None:
            fut, buf, n, issued = staged
            dbytes, got = fut.result()
            if n == seg and issued == lanes:
                hit = (buf, dbytes, got)
        if hit is None:
            buf = self._host_buffer(self._dev, total)
            host = buf.numpy() if torch.is_tensor(buf) else buf
            dbytes, got = self._gather(host, offs, metas, base, seg, lanes)
        else:
            buf, dbytes, got = hit
            self._tally_counter("prefetch_hit_cb")
        if not ok:  # flaked past every retry: the checked caller recomputes
            (buf if torch.is_tensor(buf) else torch.from_numpy(buf)).zero_()
        elif checked:
            for slot, leaves in got:
                if not self._leaves_intact(slot, leaves):
                    ok = False
                    self._tally_counter("integrity_fail")
                    self._event("spill.integrity", slot=slot, base=base)
        tensors = self._receive(buf, offs, metas, seg, self._dev, out)
        nbytes = seg * sum(_nbytes(s, d) for s, d in metas)
        self._tally("read", slots=seg, nbytes=nbytes, disk_bytes=dbytes)
        self._event("spill.read", base=base, slots=seg, bytes=nbytes,
                    medium="disk" if dbytes and ok else "ram")
        return ok, pytree.tree_unflatten(tensors, spec)

    def prefetch(self, base: int, seg: int, out=None) -> PyTree:
        """Slots ``[base, base+seg)`` stacked on axis 0, as one transfer
        (a missing slot reads as zeros), into ``out`` (a flat list of
        tensors of the stacked shapes) when given; served by a
        ``prefetch_issue`` of the same base when one is in flight."""
        return self._fetch(base, seg, False, out)[1]

    def prefetch_checked(self, base: int, seg: int, out=None):
        """``(ok, tree)``: ``prefetch`` plus a verdict, False if a slot is
        missing or fails its crc32 (``integrity=True``); the caller then
        recomputes the segment instead of reading ``tree``."""
        return self._fetch(base, seg, True, out)


class DiskStore(SpillStore):
    """All-disk spill: the ``snaps_in_ram=0`` corner of ``SpillStore`` as a
    tier of its own."""

    tier = "disk"

    def __init__(self):
        super().__init__()
        self.snaps_in_ram = 0
        self.effective_tier = "disk"
