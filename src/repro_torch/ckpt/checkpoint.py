"""Checkpointing with async writes and keep-N retention: the port of the JAX
package's ``repro/ckpt/checkpoint.py``, with its on-disk format, so a
directory one package writes restores in the other.

Format: one directory per step, ``step_<k:010d>/``, containing
  * ``tree.json``   pytree leaves by flattened key path: shapes, dtypes
  * ``arrays.npz``  one entry per leaf, keyed by the flattened path (no
                    pickle)
  * ``DONE``        commit marker written last; restore ignores
                    directories without it, so a job killed mid-write
                    never corrupts the latest checkpoint.
A save stages into ``.tmp_step_<k>_*`` and renames it into place.

Key paths: a leaf's key is its ``torch.utils._pytree`` key path joined
with ``SEP``: a ``MappingKey`` gives its key, a ``SequenceKey`` its
index, a ``GetAttrKey`` (a NamedTuple field) its name, the strings the
JAX package makes of ``DictKey``/``SequenceKey``/``GetAttrKey``.

Leaves are tensors (any device), numpy arrays, or Python numbers (e.g.
``AdamWState.step``, an int): a number is saved as a numpy scalar and
restored as the template's type.  numpy has no bfloat16, so a bf16 tensor
is saved as its raw 16-bit payload (uint16) with ``"bfloat16"`` as its
dtype in ``tree.json``.

``CheckpointManager.save`` snapshots the tree on the caller's thread and
commits it to disk on a background thread.  On the card the snapshot is
a copy into pinned host tensors with ``copy_(non_blocking=True)`` on a
copy stream that first waits on the compute stream.  The compute stream
then waits on the copy's event, so work queued after ``save`` (the
donated optimizer step writes the params and moments in place) runs
after the copy has read them; each source is also marked with
``record_stream``, so the caching allocator does not hand its memory to
later work (a functional step drops the tensors it replaced) before the
copy is done.  The commit thread waits on the copy's event before it
reads the pinned bytes.  The caller's thread never waits for the copy.

Elastic restore onto another mesh (``shardings=``) is ROADMAP Queue 1
item 14 and raises.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.ft.inject import SimulatedPreemption

SEP = "::"

_BF16 = "bfloat16"


class CheckpointWriteError(RuntimeError):
    """A background checkpoint commit failed.  Raised on the caller's
    thread at the next ``save``/``wait``/restore: a full disk (or any other
    commit failure) must not silently disable checkpointing."""


def _path_part(p) -> str:
    if isinstance(p, pytree.MappingKey):
        return str(p.key)
    if isinstance(p, pytree.SequenceKey):
        return str(p.idx)
    if isinstance(p, pytree.GetAttrKey):
        return str(p.name)
    return str(p)


def _key(path) -> str:
    return SEP.join(_path_part(p) for p in path)


def _flatten_with_paths(tree) -> Dict[str, Any]:
    leaves, _ = pytree.tree_flatten_with_path(tree)
    return {_key(path): leaf for path, leaf in leaves}


def _to_numpy(leaf):
    """(array, dtype name) of a leaf on the host."""
    if torch.is_tensor(leaf):
        x = leaf.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = x.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(directory: str | Path, step: int, tree: Any,
                    fault_plan=None) -> Path:
    """Synchronous save.  Returns the committed checkpoint path.

    ``fault_plan=`` (a ``repro_torch.ft.FaultPlan``) is the chaos hook:
    site ``"ckpt.write"`` fires after the data files are staged but before
    the DONE marker; kind ``preempt`` raises ``SimulatedPreemption`` and
    leaves the uncommitted ``.tmp_step_*`` directory behind (a real
    SIGKILL runs no cleanup), kind ``error`` raises ``OSError`` (a full
    disk) through the normal cleanup path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:010d}"
    tmp = Path(tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=directory))
    try:
        arrays = {}
        meta = {"step": step, "leaves": {}, "treedef": None}
        for key, leaf in _flatten_with_paths(tree).items():
            arr, dtype = _to_numpy(leaf)
            arrays[key] = arr
            meta["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype}
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "tree.json").write_text(json.dumps(meta))
        if fault_plan is not None:
            spec = fault_plan.tick("ckpt.write")
            if spec is not None and spec.kind == "preempt":
                raise SimulatedPreemption(
                    f"injected preemption mid-write of step {step}")
            if spec is not None and spec.kind == "error":
                raise OSError(f"injected commit failure at step {step} "
                              "(disk full)")
        (tmp / "DONE").write_text(str(time.time()))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    except SimulatedPreemption:
        # a simulated SIGKILL runs no handlers: keep the stale tmp dir so
        # recovery (ignore it, clean it at the next manager) is exercised
        raise
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _restore_leaf(key: str, arr: np.ndarray, dtype: Optional[str], leaf):
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
    if tuple(arr.shape) != shape:
        raise ValueError(
            f"checkpoint leaf {key!r} has shape {tuple(arr.shape)} but "
            f"the restore template expects {shape} — the checkpoint was "
            "written by a different model config/mesh than this job is "
            "running")
    if torch.is_tensor(leaf):
        if dtype == _BF16:
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return arr.astype(leaf.dtype)
    if isinstance(leaf, (bool, int, float, complex)):
        return type(leaf)(arr.item())
    return arr


def load_checkpoint(directory: str | Path, template: Any,
                    step: Optional[int] = None,
                    shardings: Any = None) -> tuple[Any, int]:
    """Restore the latest (or a specific) committed checkpoint into the
    structure of ``template``: each leaf on the template leaf's device and
    in its dtype (a Python number as its type).  ``shardings`` other than
    None (elastic restore onto another mesh) is ROADMAP Queue 1 item 14."""
    if shardings is not None:
        raise NotImplementedError(
            "load_checkpoint: shardings= (elastic restore onto another "
            "mesh) is not ported yet: ROADMAP Queue 1 item 14 (the mesh "
            "and sharded replicas)")
    directory = Path(directory)
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints under {directory}")
    if step is None:
        step = steps[-1]
    if step not in steps:
        raise FileNotFoundError(f"step {step} not in {steps}")
    path = directory / f"step_{step:010d}"
    meta = json.loads((path / "tree.json").read_text()).get("leaves", {})
    leaves, spec = pytree.tree_flatten_with_path(template)
    keys = [_key(p) for p, _ in leaves]
    with np.load(path / "arrays.npz", allow_pickle=False) as data:
        missing = set(keys) - set(data.files)
        extra = set(data.files) - set(keys)
        if missing:
            raise ValueError(
                f"checkpoint missing leaves: {sorted(missing)[:5]}")
        if extra:
            raise ValueError(
                f"checkpoint has unknown leaves: {sorted(extra)[:5]}")
        out = [_restore_leaf(k, data[k], meta.get(k, {}).get("dtype"), leaf)
               for k, (_, leaf) in zip(keys, leaves)]
    return pytree.tree_unflatten(out, spec), step


def available_steps(directory: str | Path) -> list[int]:
    directory = Path(directory)
    if not directory.exists():
        return []
    out = []
    for p in sorted(directory.iterdir()):
        if p.name.startswith("step_") and (p / "DONE").exists():
            out.append(int(p.name.split("_")[1]))
    return sorted(out)


_COPY_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    i = device.index if device.index is not None \
        else torch.cuda.current_device()
    s = _COPY_STREAMS.get(i)
    if s is None:
        s = _COPY_STREAMS[i] = torch.cuda.Stream(device=i)
    return s


def _snapshot(tree: Any):
    """``(host_tree, events)``: the tree's leaves on the host, without
    waiting.  Card tensors are copied into pinned tensors on a copy stream
    (module docstring) and ``events`` holds one event a device, to be
    synchronized before the host reads them; CPU tensors are cloned (the
    caller may change them in place), numpy arrays copied, numbers kept."""
    leaves, spec = pytree.tree_flatten(tree)
    out: List[Any] = []
    streams: Dict[torch.device, Any] = {}
    for x in leaves:
        if torch.is_tensor(x) and x.is_cuda:
            s = streams.get(x.device)
            if s is None:
                s = streams[x.device] = _copy_stream(x.device)
                s.wait_stream(torch.cuda.current_stream(x.device))
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            with torch.cuda.stream(s):
                h.copy_(x.detach(), non_blocking=True)
            x.record_stream(s)
            out.append(h)
        elif torch.is_tensor(x):
            out.append(x.detach().clone())
        elif isinstance(x, np.ndarray):
            out.append(x.copy())
        else:
            out.append(x)
    events = []
    for dev, s in streams.items():
        ev = torch.cuda.Event()
        ev.record(s)
        # in-place writes queued later wait for the copy to read
        torch.cuda.current_stream(dev).wait_event(ev)
        events.append(ev)
    return pytree.tree_unflatten(out, spec), events


class CheckpointManager:
    """Async keep-N checkpoint manager.

    ``save`` snapshots the tree to host memory on the caller's thread
    (``_snapshot``: on the card a copy it does not wait for) and commits it
    to disk on a background thread, keeping the training step off the I/O
    critical path.  ``wait`` joins outstanding writes (call before
    exit/restore).  Retention keeps the newest ``keep_n`` committed
    checkpoints.

    A failed background commit is NOT swallowed: the exception is kept and
    re-raised (wrapped in ``CheckpointWriteError``) on the next
    ``save``/``wait``/restore call, then cleared.  Stale ``.tmp_step_*``
    directories from a job killed mid-write are removed at init (restore
    already ignores them: no DONE marker).
    """

    def __init__(self, directory: str | Path, keep_n: int = 3,
                 async_write: bool = True, fault_plan=None):
        self.directory = Path(directory)
        self.keep_n = keep_n
        self.async_write = async_write
        self.fault_plan = fault_plan
        self._lock = threading.Lock()
        self._pending: list[threading.Thread] = []
        self._errors: list[tuple[int, BaseException]] = []
        self.saved_steps: list[int] = available_steps(self.directory)
        for stale in self.directory.glob(".tmp_step_*"):
            shutil.rmtree(stale, ignore_errors=True)

    def _raise_pending_errors(self) -> None:
        with self._lock:
            errs, self._errors = self._errors, []
        if errs:
            step, exc = errs[0]
            raise CheckpointWriteError(
                f"{len(errs)} background checkpoint commit(s) failed; "
                f"first failure at step {step}: {exc!r}") from exc

    def save(self, step: int, tree: Any) -> None:
        self._raise_pending_errors()
        host_tree, events = _snapshot(tree)

        def commit():
            for ev in events:
                ev.synchronize()  # the host reads the pinned bytes after
            save_checkpoint(self.directory, step, host_tree,
                            fault_plan=self.fault_plan)
            with self._lock:
                self.saved_steps.append(step)
                self.saved_steps = sorted(set(self.saved_steps))
                self._retain()

        if self.async_write:
            def commit_captured():
                try:
                    commit()
                except BaseException as exc:  # incl. SimulatedPreemption
                    with self._lock:
                        self._errors.append((step, exc))

            t = threading.Thread(target=commit_captured, daemon=True)
            t.start()
            self._pending = [th for th in self._pending if th.is_alive()]
            self._pending.append(t)
        else:
            commit()

    def _retain(self) -> None:
        while len(self.saved_steps) > self.keep_n:
            victim = self.saved_steps.pop(0)
            shutil.rmtree(self.directory / f"step_{victim:010d}",
                          ignore_errors=True)

    def wait(self) -> None:
        for t in self._pending:
            t.join()
        self._pending = []
        self._raise_pending_errors()

    def restore_latest(self, template: Any, shardings: Any = None):
        self.wait()
        return load_checkpoint(self.directory, template, shardings=shardings)

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = available_steps(self.directory)
        return steps[-1] if steps else None
