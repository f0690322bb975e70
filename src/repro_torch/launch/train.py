"""End-to-end LM training driver: synthetic data + AdamW + depth remat +
fault tolerance (watchdog, straggler detection, non-finite sentinel,
checkpoint-restart), the port of ``repro/launch/train.py`` on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt   # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch smollm-135m --steps 6 --batch 4 --seq 64

The CLI runs the reduced config of ``--arch`` unless ``--production``
asks for the full one (here: on the one card).  Deterministic restart:
the data pipeline is keyed by step and the checkpoint carries (params,
opt_state, and with ``--compress int8`` the error-feedback residual
``comp_state``), so rerunning with the same ``--ckpt-dir`` resumes and replays
the same loss curve.  The step runs eagerly on the device and, as the
JAX package's jitted step donates its buffers, it is the donated step
(``make_train_step(donate=True)``): params, moments and int8's residual
are updated in place, so a rollback restores from a checkpoint, never
from a live tensor.  ``mesh=`` (the sharded mesh) is ROADMAP Queue 1
item 14.
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import time

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeCell, reduced
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.ft import StragglerDetector, TrainSupervisor
from repro_torch.launch.steps import init_compress_state, make_train_step
from repro_torch.mem.model import tree_bytes
from repro_torch.models import lm
from repro_torch.models.ode_nets import resolve_device
from repro_torch.obs import MetricsSink, StructuredLogger
from repro_torch.optim.adamw import AdamW


def train(cfg: ModelConfig, cell: ShapeCell, *, steps: int, mesh=None,
          ckpt_dir: str | None = None, ckpt_every: int = 50,
          accum: int = 1, lr: float = 3e-4, log_every: int = 10,
          seed: int = 0, grad_dtype: str | None = None,
          compress: str | None = None, log_fn=print,
          sink: MetricsSink | None = None,
          predicted_peak_bytes: int | None = None,
          fault_plan=None, sentinel: bool = True,
          sentinel_bad_steps: int = 3, max_rollbacks: int = 2,
          device="cuda") -> dict:
    """Returns {"losses": [...], "resumed_from": step|None, ...}, the JAX
    package's loop on one device (on the card unless ``device="cpu"``).

    ``compress`` ("bf16", "int8") wires ``optim/compress.py`` into the
    step (``launch/steps.py``); int8's residual is checkpointed under
    ``"comp_state"`` and restored on resume and rollback.

    ``sink`` receives one ``train.step`` record per committed step (loss,
    global grad norm, wall ms) and one ``train.compile`` record: the
    measured peak is the CUDA allocator's peak over the first step
    (``reset_peak_memory_stats`` before it, ``max_memory_allocated``
    after), None on the CPU, against ``predicted_peak_bytes`` (the
    planner's live bytes plus the params, moments and batch) with drift
    beyond 25 % warned through ``log_fn``.

    Fault tolerance, as in the JAX package.  ``sentinel=True`` builds the
    step with the non-finite sentinel (launch/steps.py): a step whose loss
    or grads are non-finite (injected or natural) commits nothing and is
    retried (the pipeline is keyed by step, so a clean retry reproduces
    the fault-free loss bitwise).  After ``sentinel_bad_steps``
    consecutive bad attempts the loop rolls back to the last committed
    checkpoint and replays; after ``max_rollbacks`` rollbacks, or with no
    checkpoint, it raises ``FloatingPointError``.  SIGTERM finishes the
    in-flight step, writes a final checkpoint and drains the pending
    commits (``result["preempted"]``).  ``fault_plan`` site
    ``"train.step"`` kinds ``nan`` (poison that attempt) and ``preempt``
    (shut down after that step).  ``result["losses"][i]`` is the committed
    loss of step ``start + i``."""
    if mesh is not None:
        raise NotImplementedError(
            "train(mesh=...): the sharded mesh is not ported yet "
            "(ROADMAP Queue 1 item 14); the port trains on one device")
    device = resolve_device(device)
    on_card = device.type == "cuda"
    slog = StructuredLogger(log_fn=log_fn, sink=sink)
    opt = AdamW(lr=lr, total_steps=max(steps, 2),
                warmup_steps=min(100, steps // 10 + 1),
                grad_dtype=grad_dtype)
    pipe = SyntheticLM(cfg, cell, seed=seed)
    params = lm.init_params(cfg, torch.Generator(device).manual_seed(seed),
                            device=device)
    opt_state = opt.init(params)
    start_step = 0
    int8 = compress == "int8"
    comp_state = init_compress_state(compress, params) if int8 else None

    def ckpt_tree():
        # the int8 error-feedback residual is training state: dropping it
        # on resume would fork the loss trajectory
        tree = {"params": params, "opt_state": opt_state}
        if int8:
            tree["comp_state"] = comp_state
        return tree

    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep_n=3, fault_plan=fault_plan)
        if mgr.latest_step() is not None:
            restored, start_step = mgr.restore_latest(ckpt_tree())
            params, opt_state = restored["params"], restored["opt_state"]
            if int8:
                comp_state = restored["comp_state"]
            slog.log("train.resume", f"[train] resumed from step {start_step}",
                     step=start_step)

    step_fn = make_train_step(cfg, opt, accum=accum, compress=compress,
                              sentinel=sentinel, donate=True)

    def batch_at(step):
        return {k: v.to(device) for k, v in pipe.batch(step).items()}

    measured_peak = None
    peak_pending = sink is not None
    detector = StragglerDetector()
    stragglers: list[int] = []
    loss_by_step: dict[int, float] = {}
    skipped = rollbacks = consec_bad = 0
    preempted = False
    saved_at = None
    stop = {"sig": False}
    try:  # SIGTERM = finish the in-flight step, checkpoint, drain
        prev_handler = signal.signal(
            signal.SIGTERM,
            lambda signum, frame: stop.__setitem__("sig", True))
    except ValueError:  # not on the main thread; no handler swap
        prev_handler = None
    step = start_step
    try:
        with TrainSupervisor(
                heartbeat_timeout_s=600.0, straggler=detector,
                on_straggler=lambda s, dt: stragglers.append(s)) as sup:
            while step < steps:
                if stop["sig"]:
                    preempted = True
                    break
                batch = batch_at(step)
                poison = want_preempt = False
                if fault_plan is not None:
                    spec = fault_plan.tick("train.step")
                    if spec is not None and spec.kind == "nan":
                        poison = sentinel
                    elif spec is not None and spec.kind == "preempt":
                        want_preempt = True
                holder = {}

                def do_step():
                    if int8:
                        p, o, c, m = step_fn(params, opt_state, comp_state,
                                             batch, step, poison)
                        holder.update(c=c)
                    else:
                        p, o, m = step_fn(params, opt_state, batch, step,
                                          poison)
                    holder.update(p=p, o=o, m=m, loss=float(m["loss"]))

                if peak_pending and on_card:
                    torch.cuda.synchronize(device)
                    torch.cuda.reset_peak_memory_stats(device)
                dt = sup.step(do_step, step)
                if peak_pending:
                    peak_pending = False
                    if on_card:
                        measured_peak = torch.cuda.max_memory_allocated(device)
                    predicted = drift = None
                    if measured_peak is not None and predicted_peak_bytes:
                        # the planner prices live activations; the peak also
                        # holds the params, the moments and the batch
                        predicted = predicted_peak_bytes + tree_bytes(
                            (params, opt_state.m, opt_state.v, batch))
                        drift = measured_peak / predicted - 1.0
                        if abs(drift) > 0.25:
                            slog.log("train.peak_drift",
                                     f"[train] WARNING: measured peak "
                                     f"{measured_peak} B is {drift:+.0%} off "
                                     f"the planner's {predicted} B",
                                     measured_peak_bytes=measured_peak,
                                     predicted_peak_bytes=predicted,
                                     drift=drift)
                    slog.metric("train.compile",
                                measured_peak_bytes=measured_peak,
                                predicted_peak_bytes=predicted, drift=drift)
                params, opt_state, m = holder["p"], holder["o"], holder["m"]
                if int8:  # a skipped step hands back the old residual
                    comp_state = holder["c"]
                if sentinel and bool(m["nonfinite"]):
                    skipped += 1
                    consec_bad += 1
                    slog.log("train.skip",
                             f"[train] step {step}: non-finite loss/grad - "
                             f"update skipped (streak {consec_bad})",
                             step=step, streak=consec_bad)
                    if consec_bad >= sentinel_bad_steps:
                        if mgr is None or mgr.latest_step() is None:
                            raise FloatingPointError(
                                f"training produced non-finite loss/grads "
                                f"for {consec_bad} consecutive attempts at "
                                f"step {step} and there is no checkpoint to "
                                "roll back to")
                        if rollbacks >= max_rollbacks:
                            raise FloatingPointError(
                                f"training still non-finite at step {step} "
                                f"after {rollbacks} rollbacks - giving up "
                                "(deterministic replay reproduces the "
                                "divergence; this is not a transient)")
                        restored, rstep = mgr.restore_latest(ckpt_tree())
                        params = restored["params"]
                        opt_state = restored["opt_state"]
                        if int8:
                            comp_state = restored["comp_state"]
                        rollbacks += 1
                        consec_bad = 0
                        for s in [s for s in loss_by_step if s >= rstep]:
                            del loss_by_step[s]
                        slog.log("train.rollback",
                                 f"[train] rolled back to step {rstep} after "
                                 f"{sentinel_bad_steps} consecutive bad "
                                 "steps", step=rstep, rollbacks=rollbacks)
                        step = rstep
                    # else: retry the same step; nothing was committed
                    continue
                consec_bad = 0
                loss = holder["loss"]
                loss_by_step[step] = loss
                if sink is not None:
                    gn = m.get("grad_norm")
                    slog.metric("train.step", step=step, loss=loss,
                                grad_norm=None if gn is None else float(gn),
                                step_ms=dt * 1e3)
                if step % log_every == 0 or step == steps - 1:
                    log_fn(f"[train] step {step:5d} loss {loss:.4f} "
                           f"({dt * 1e3:.0f} ms)")
                if mgr and (step + 1) % ckpt_every == 0:
                    mgr.save(step + 1, ckpt_tree())
                    saved_at = step + 1
                step += 1
                if want_preempt:
                    fault_plan.note("train.preempt", step)
                    preempted = True
                    break
    finally:
        if prev_handler is not None:
            try:
                signal.signal(signal.SIGTERM, prev_handler)
            except ValueError:
                pass
    if mgr:
        # ``step`` is the committed progress (the next step to run): the
        # final checkpoint lands there, unless the loop just saved it (two
        # commits of one step would race on its directory), and wait()
        # drains every commit
        if saved_at != step:
            mgr.save(step, ckpt_tree())
        mgr.wait()
    losses = [loss_by_step[s] for s in sorted(loss_by_step)]
    return {"losses": losses, "resumed_from": start_step or None,
            "stragglers": stragglers, "params": params,
            "skipped_steps": skipped, "rollbacks": rollbacks,
            "preempted": preempted, "measured_peak_bytes": measured_peak}


def parse_bytes(spec: str) -> int:
    """'512M' / '8G' / '1e9' / '123456' -> bytes."""
    spec = str(spec).strip()
    mult = {"K": 2 ** 10, "M": 2 ** 20, "G": 2 ** 30, "T": 2 ** 40}
    if spec and spec[-1].upper() in mult:
        return int(float(spec[:-1]) * mult[spec[-1].upper()])
    return int(float(spec))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production", action="store_true",
                    help="the full config (on the one card)")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--grad-dtype", default=None)
    ap.add_argument("--compress", default="none",
                    choices=["none", "bf16", "int8"],
                    help="gradient wire compression (optim/compress.py); "
                         "int8 carries its residual in the checkpoint")
    ap.add_argument("--mem-budget", default=None,
                    help="activation-memory budget in bytes (suffixes "
                         "K/M/G); the repro_torch.mem planner picks the "
                         "depth remat policy for it, overriding --remat")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write per-step metrics as JSONL to PATH")
    ap.add_argument("--no-sentinel", action="store_true",
                    help="disable the non-finite loss/grad sentinel")
    ap.add_argument("--sentinel-bad-steps", type=int, default=3,
                    metavar="K",
                    help="roll back to the last committed checkpoint "
                         "after K consecutive non-finite steps (default 3)")
    ap.add_argument("--max-rollbacks", type=int, default=2,
                    help="give up (FloatingPointError) after this many "
                         "rollbacks (default 2)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    full = get_arch(args.arch)
    cfg = full if args.production else reduced(full)
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=args.remat)
    cell = ShapeCell("cli", args.seq, args.batch, "train")
    sink = MetricsSink(args.metrics) if args.metrics else None
    slog = StructuredLogger(sink=sink)
    predicted = None
    if args.mem_budget is not None:
        from repro_torch.mem.planner import (depth_remat_live_bytes,
                                             plan_depth_remat)
        budget = parse_bytes(args.mem_budget)
        remat, ncheck, fits = plan_depth_remat(cfg, cell, budget)
        predicted = depth_remat_live_bytes(cfg, cell, remat, ncheck)
        slog.log("train.plan",
                 f"[train] mem budget {budget} B -> depth remat={remat!r} "
                 f"ncheck={ncheck} (predicted live {predicted} B)",
                 mem_budget=budget, remat=remat, ncheck=ncheck, fits=fits,
                 predicted_peak_bytes=predicted)
        if not fits:
            slog.log("train.plan_overflow",
                     "[train] WARNING: no depth-checkpointing policy fits "
                     "this budget - proceeding with the minimum-memory "
                     "plan, expect to exceed it", mem_budget=budget)
        cfg = dataclasses.replace(cfg, remat=remat, ncheck=ncheck)
    t0 = time.time()
    try:
        out = train(cfg, cell, steps=args.steps, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, accum=args.accum, lr=args.lr,
                    grad_dtype=args.grad_dtype,
                    compress=None if args.compress == "none"
                    else args.compress,
                    sink=sink, predicted_peak_bytes=predicted,
                    sentinel=not args.no_sentinel,
                    sentinel_bad_steps=args.sentinel_bad_steps,
                    max_rollbacks=args.max_rollbacks, device=args.device)
        slog.log("train.done",
                 f"[train] done in {time.time() - t0:.1f}s; final loss "
                 f"{out['losses'][-1]:.4f}" if out["losses"] else
                 f"[train] done in {time.time() - t0:.1f}s; no step run",
                 final_loss=out["losses"][-1] if out["losses"] else None,
                 stragglers=out["stragglers"])
    finally:
        if sink is not None:
            sink.close()
    return out


if __name__ == "__main__":
    main()
