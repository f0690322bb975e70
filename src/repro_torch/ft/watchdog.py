"""Fault tolerance for long multi-pod runs (a copy of the JAX package's
``repro/ft/watchdog.py``: numpy and threads).

Three pieces, composed by ``TrainSupervisor`` (used in launch/train.py):

* ``Heartbeat`` — a watchdog thread that fires a callback if the training
  loop fails to check in within ``timeout_s``.  On a real cluster the
  callback escalates (kill the stuck step, checkpoint-restart the job); on
  this runtime it records the stall and raises in the loop thread.

* ``StragglerDetector`` — robust per-step timing statistics (median + MAD).
  A step slower than ``median + k*MAD`` (and over an absolute floor) is
  flagged.  The mitigation hook is pluggable: the default logs and, after
  ``evict_after`` consecutive flags, requests an elastic re-mesh (on real
  hardware: evict the slow host, shrink 'data').

* ``elastic_remesh_plan`` — given a failed/evicted device count, returns the
  largest (data, model) mesh that keeps the model axis intact (TP degree is
  load-bearing for memory; the data axis absorbs the loss).  A checkpoint
  written under the old mesh restores onto the new one via
  ``ckpt.load_checkpoint(..., shardings=new)`` — global arrays, new
  placement — so elastic shrink/grow is restore + continue.

Recovery invariant (tested): deterministic data (``data/pipeline.py`` keys
batches by step) + checkpointed (params, opt_state, step) means a restarted
job replays losses bit-identically from the restore point.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np


class Heartbeat:
    """Watchdog: ``beat()`` every step; if no beat for ``timeout_s`` the
    ``on_stall`` callback fires (once per stall)."""

    def __init__(self, timeout_s: float = 300.0,
                 on_stall: Optional[Callable[[float], None]] = None,
                 poll_s: float = 1.0):
        self.timeout_s = timeout_s
        self.on_stall = on_stall or (lambda age: None)
        self.poll_s = poll_s
        # _last/_stalled are touched by the loop thread (beat) and the
        # watchdog thread (_run) concurrently — lock both, so a beat
        # racing the poll can't leave _stalled latched after a fresh beat
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._stalled = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0

    def start(self) -> "Heartbeat":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def beat(self) -> None:
        with self._lock:
            self._last = time.monotonic()
            self._stalled = False

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            fire = False
            with self._lock:
                age = time.monotonic() - self._last
                if age > self.timeout_s and not self._stalled:
                    self._stalled = True
                    self.stall_count += 1
                    fire = True
            if fire:  # callback outside the lock: it may call beat()
                self.on_stall(age)

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


@dataclasses.dataclass
class StragglerDetector:
    """Flags steps whose wall time exceeds median + k*MAD of the trailing
    window (robust to the compile-time spike of step 0)."""
    window: int = 50
    k_mad: float = 6.0
    min_abs_s: float = 0.05
    warmup: int = 3

    def __post_init__(self):
        self._times: list[float] = []
        self.flagged_steps: list[int] = []
        self._step = 0

    def record(self, dt_s: float) -> bool:
        """Record one step time; returns True if it is a straggler."""
        self._step += 1
        is_straggler = False
        if len(self._times) >= self.warmup:
            med = float(np.median(self._times))
            mad = float(np.median(np.abs(np.array(self._times) - med)))
            thresh = med + self.k_mad * max(mad, 0.01 * med)
            if dt_s > max(thresh, self.min_abs_s):
                is_straggler = True
                self.flagged_steps.append(self._step)
        # straggler samples pollute the baseline — exclude them
        if not is_straggler:
            self._times.append(dt_s)
            if len(self._times) > self.window:
                self._times.pop(0)
        return is_straggler

    @property
    def median_s(self) -> float:
        return float(np.median(self._times)) if self._times else 0.0


def elastic_remesh_plan(n_devices: int, model_axis: int,
                        lost: int = 0) -> tuple[int, int]:
    """Largest (data, model) mesh on ``n_devices - lost`` devices keeping
    the model axis fixed.  Returns (data, model); raises if even data=1
    does not fit."""
    avail = n_devices - lost
    if avail < model_axis:
        raise RuntimeError(
            f"cannot re-mesh: {avail} devices < model axis {model_axis}")
    data = avail // model_axis
    return data, model_axis


class TrainSupervisor:
    """Composes heartbeat + straggler detection around a step function and
    drives checkpoint-restart.  See launch/train.py for the integration."""

    def __init__(self, *, heartbeat_timeout_s: float = 600.0,
                 straggler: Optional[StragglerDetector] = None,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.straggler = straggler or StragglerDetector()
        self.on_straggler = on_straggler or (lambda step, dt: None)
        self.stall_event = threading.Event()
        self.heartbeat = Heartbeat(
            timeout_s=heartbeat_timeout_s,
            on_stall=lambda age: self.stall_event.set())
        self.step_times: list[float] = []

    def __enter__(self) -> "TrainSupervisor":
        self.heartbeat.start()
        return self

    def __exit__(self, *exc) -> None:
        self.heartbeat.stop()

    def step(self, fn: Callable[[], None], step_idx: int) -> float:
        """Run one training step under supervision; returns its wall time."""
        if self.stall_event.is_set():
            raise TimeoutError(
                f"heartbeat watchdog fired before step {step_idx}")
        t0 = time.monotonic()
        fn()
        dt = time.monotonic() - t0
        # re-check AFTER fn() too: a stall during the final step of a run
        # would otherwise go unreported forever (no next step to notice)
        if self.stall_event.is_set():
            raise TimeoutError(
                f"heartbeat watchdog fired during step {step_idx} "
                f"({dt:.1f}s elapsed, timeout "
                f"{self.heartbeat.timeout_s:.0f}s)")
        self.heartbeat.beat()
        self.step_times.append(dt)
        if self.straggler.record(dt):
            self.on_straggler(step_idx, dt)
        return dt
