#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on
one NVIDIA GPU.  Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the last line is printed):

1. the card's name and power limit (``nvidia-smi``); build the CUDA kernels
   from ``src/repro_torch/csrc`` (nvcc, one process per source, in
   parallel);
2. kernel phase: ``fused_lincomb`` held BITWISE against its plain version
   ``lincomb_plain`` on the card (fp32 and fp64; static form with 1-7
   terms and base_coeff None / 0.0 / a float; scaled form with h on the
   device; the main path's shapes and odd sizes, as storage-offset views),
   then timed beside its bound and its plain version;
3. serving computation: CNF at the width of the POWER table
   (benchmarks/cnf_tables.py: dim 6, hidden (64, 64, 64)) on the paper's
   batch of 10,000, dopri5, N_t = 10, pnode, fused, exact trace: the
   log-density (forward only) and the score d log p / dx (a full reverse
   sweep);
4. training: the §5.1 ODE classifier at classifier_init's width (32
   channels, CIFAR-10 shape 32x32x3, 10 classes), batch 128, rk4, N_t = 4,
   pnode, fused, AdamW, 5 steps on seeded synthetic data;
   then phases 3-4 captured: the CNF request and the classifier gradient
   through ``repro_torch.launch.graphs.StepGraph`` (one CUDA graph each,
   ``fused_lincomb`` launched from the replay; AdamW eager), BITWISE
   equal to the eager runs (density, score, step-0 gradients, every
   step's loss), with the first call (warm-up + capture), the replays,
   the graph pools and a traced replay beside the eager times;
5. flash kernel phase: ``flash_attention_bhsd`` against ``attention_plain``
   on the card, with the limits of ``repro_torch.kernels.flash_cases``:
   bf16 (the tensor-core kernel, p rounded to bf16 once) within the
   elementwise limit derived from that arithmetic, at diffuse and sharp
   scores, worst ratio printed; fp32 (the CUDA-core kernel, the TPU
   kernel's arithmetic) within rtol = atol = 2e-5, the tolerance of
   tests/test_kernels.py; over that file's grid, cross lengths, every
   head dim at ragged S and Sq != Sk, and the LM slice's shape (8, 32, 4,
   1920, 64).  Four deliberately wrong answers must exceed the bf16
   limit 10x.  ``flash_attention`` on strided (B,S,H,Dh) views must equal
   the contiguous call bitwise and launch nothing but the kernel.  Then
   timed at the slice's shape beside its bound, its plain version, the
   earlier CUDA-core kernel's 5.1872 ms and
   ``scaled_dot_product_attention`` (a yardstick the port never calls);
6. LM serving at TinyLlama-1.1B's full width (22 layers, d 2048, 32/4
   heads, bf16, ``attn_impl="pallas"``, random weights drawn on the card
   from seed 0) through ``repro_torch.launch.serve.serve``: batch 8,
   prompt 1920, 128 greedy tokens (max_seq 2048), decode slices of 8,
   decode replayed from a CUDA graph inside ``LMEngine``; then one traced
   prefill and one traced replayed decode slice; then an eager greedy loop
   (``lm.prefill`` + ``lm.decode_step``, 24 tokens) that must give the
   serve's tokens bitwise, and its times beside the replayed ones;
7. agreement: the kernel's prefill against the naive one on the same
   weights (bf16 at full depth; fp32 at full width and 2 layers, with 16
   greedy decode steps), and the card against the port on the CPU (fp32,
   full width, 2 layers, batch 2, prompt 64, 8 teacher-forced decode
   steps);
8. RWKV6 kernel phase: ``rwkv6_chunked_bhsd`` against ``rwkv6_plain``
   (fp32: rtol = 2**-14 plus 2**-14 of max|out|, from fp32 rounding of the
   same algorithm; bf16: one output ulp, rtol 2**-7 plus 1e-3 of
   max|out|; the fp32 final state at the fp32 limit) and against the
   sequential ``rwkv6_ref`` at the JAX package's limits, over that file's
   grid in fp32 and bf16 and the slice's shape (8, 64, 2048, 64), chunk
   64; ragged S through ``rwkv6_chunked``; chunk 16 against chunk 64.
   ``rwkv6_plain`` with the bonus term dropped and with the state read
   one chunk late must exceed each limit 10x.  The model path's
   ``rwkv6_chunked_fp32``, which reads (B,S,H,dh) views in place (bf16
   r/k/v upcast on load, fp32 logw and out, the ragged last chunk
   masked), at the slice's shape and at S = 2047, for bf16 and fp32
   inputs: out and state within the fp32 limit of ``rwkv6_plain`` on the
   upcast, padded copies (padding stripped), and BITWISE equal to
   ``rwkv6_chunked`` on ``.float()`` copies (the same kernel on upcast,
   padded, contiguous tensors).  Then both are timed at the slice's shape
   beside their bounds and plain versions (fp32 on (B,H,S,dh); bf16 in
   place, with the upcast/pad route it replaced; no PyTorch call computes
   the recurrence: no library yardstick);
9. RWKV6-7B serving at full width (32 layers, d 4096, 64 heads of dh 64,
   d_ff 14336, vocab 65536, bf16, random weights drawn on the card from
   seed 0), after TinyLlama's weights are freed: batch 8, prompt 2048
   (above the 256-token switch, so every layer's prefill runs the
   kernel), 64 greedy tokens, decode slices of 8, decode replayed; then
   one traced prefill (with its count of kernels and of copy kernels), one
   traced replayed decode slice and the eager loop as for TinyLlama;
10. RWKV6 agreement: the chunked time-mix (the kernel) against the
   sequential scan at full width (fp32, batch 2 x 512), and the card
   against the port on the CPU (fp32, full width, 2 layers, batch 2,
   prompt 300, every layer's state and 8 teacher-forced decode steps);
12. adaptive CNF at POWER width (phase 3's weights) through
   ``repro_torch.core.cnf.AdaptiveCNF``: Dopri5 from t = 0 to 1 at
   rtol = atol = 1e-6 with at most 512 steps (the JAX ``ODEEngine``'s
   adaptive settings), the density and the score, ``fused_lincomb`` in
   its scaled form (h a 0-d tensor on the card).  First the engine's
   request, one point a solve with its own steps: an eager fused request
   (counted: its launches must equal ``expected_adaptive_lincomb_calls``),
   then one captured solver (one CUDA graph an attempt, with and without
   the ring write, one an adjoint step; the host reads the loop's
   ``live`` flag every 4 attempts) serving a stream of 16 points,
   BITWISE equal to eager on the first, one of them against the port on
   the CPU, the per-request and aggregate times and one traced request.
   Then the 10,000 points as ONE state (one step sequence for the batch,
   which the engine does not serve): eager fused (counted), eager unfused
   and captured, with the same steps and BITWISE equal results; the
   ring's bytes against the peak; the card against the port on the CPU
   on 256 points; the times.  Last the scaled form timed at the leaves
   of both;
13. the stiff Robertson example (paper §5.3) through
   ``repro_torch.examples.stiff_robertson.run``, fp64, eager and
   captured (one ``ImplicitSolver`` and one ``AdaptiveSolver`` an
   interval, CUDA graphs replayed): the beuler truth and 3 CN and 3
   Dopri5 training epochs of ``mlp_vf`` from seed 0; every CN solve
   converged, captured BITWISE equal to eager (every epoch's losses,
   epoch 0's gradients, the Newton iterations), no host read in a
   captured CN solve but the ``live`` flag every 4 units and the stats
   once, the pnode, revolve and revolve2 CN gradients BITWISE equal
   under capture, one traced captured loss + gradient of each, and epoch
   0's loss and gradient against the port's CPU run of the same seed;
14. the stiff ensemble at the reference's width
   (``benchmarks/stiff_ensemble.py:73-137``, its in-device half): 1,024
   Robertson systems in fp64 on lanes (``ImplicitSolver(lanes=True)``),
   per-lane log-multipliers from numpy's seed 0; the beuler truth, the
   CN pnode gradient eager and captured (BITWISE equal), the
   convergence audit at c_true (lane 164 of this sample diverges, as in
   the JAX reference), 5 AdamW steps (no lane diverges, the loss falls),
   a lane permutation (BITWISE permuted), 64 lanes solved alone (same
   Newton iterations, states within 1e-12) and 64 against the port on
   the CPU (rtol 1e-8 / atol 1e-10), with times, replays, host reads,
   graph pools, one trace and the peak;
15. the memory planner (``repro_torch.mem``) at the classifier's width
   (phase 4's ODE block: state 128 x 32 x 32 x 32 fp32, phase 4's seeded
   weights and first batch, rk4): naive, pnode, pnode2 and revolve(2) at
   N_t = 4 and 8, each gradient's peak from the CUDA allocator
   (``measure_reverse_cost``) beside the Table-2 model and the live
   tensor tracker; the Fig. 3 contracts of ``tests/test_mem.py`` (order
   naive > pnode > pnode2 measured and modelled, pnode slope ratio in
   (0.2, 5)); ``odeint(adjoint="auto", mem_budget=B, fused_stages=True)``
   at each measured peak, twice naive's and naive's modelled peak: the
   plan measured within B and again in a window of its own, the
   classifier gradient (counted: ``expected_lincomb_calls`` of each
   plan, no measurement) BITWISE the chosen policy's and within
   ``CLS_GRAD_TOL`` of naive's; then the Robertson example's
   ``--mem-budget 400000``: its plan line the CPU's, its epoch 0 the
   explicit policy's;
16. the offload tiers (``repro_torch.mem.offload``) at the classifier's
   width (phase 4's ODE block, rk4, N_t = 16, fused): pnode's gradient
   on the device, spill, disk and spill with ``snaps_in_ram=8`` tiers
   and revolve(2) on the device and host tiers, each BITWISE its
   policy's device tier, with its allocator peak (spill and disk below
   the device tier's), ms, copies, ``spill_stats()`` and counted
   launches; the planner one byte under its cheapest in-device
   candidate: pnode + spill, measured against the budget, the auto
   classifier gradient BITWISE pnode's; the adaptive CNF batched state at
   POWER width with its ring on the spill tier, captured, BITWISE phase
   12's device ring; the Robertson example's ``--mem-budget 2000`` (pnode
   + spill, the CN solvers eager: ROADMAP Queue 1 item 10a), its CN epoch
   0 BITWISE phase 15's in-device plan's;
17. the flight recorder, fault injection and checkpoints
   (``repro_torch.obs``, ``.ft``, ``.ckpt``): phase 16's pnode + spill
   gradient with a ``FlightRecorder``, BITWISE the unobserved one, its
   ``spill_traffic()`` the store's counters, timed without and with it;
   phase 12's one-point adaptive CNF request with ``obs=``, eager
   (counted) and captured, BITWISE each other and the unobserved request,
   the captured attempt log the eager one, ``accepted_rejected()`` the
   solve's; the request with attempts 2-3 poisoned (captured): finite,
   2+ rejections, within 1e-5 of the clean one; a ``FevalCounter`` on the
   captured forward pass (the dead attempts' f evaluations); Robertson
   fp64 CN pnode + spill: ``spill.write`` corrupt and drop, a transient
   ``spill.read`` flake (``resilient``), Newton diverge and NaN
   (``rescue``), each BITWISE the fault-free gradient, a persistent flake
   raising; the classifier checkpointed after step 2 by the async
   ``CheckpointManager`` and restored, steps 3-5 BITWISE the
   uninterrupted run, a ``ckpt.write`` preemption recovered; and (run
   after phase 7, while TinyLlama's weights are on the card, as "17e")
   TinyLlama-1.1B serving batch 8 with lane 0 poisoned at decode step 0:
   lane 0 errors, lanes 1-7 BITWISE the clean run, injected malformed and
   oversize requests refused and counted;
18. ODE serving (``repro_torch.serve.ODEEngine``) at phase 3's width
   and weights (dopri5, dt 0.1, 10 steps, unfused as the JAX engine runs
   it), buckets (8, 64), segment 4: 72 requests (48 density, 16 score, 8
   classify) through the device tier captured (6 graphs: warm-up ms,
   capture ms, pool bytes) and eager, the spill and the disk tiers, every
   result BITWISE the same on all four; again with 12 new requests first
   and the rest reversed (other batch-mates and lanes; on the spill tier
   its scores), BITWISE; the scores on the RAM/disk split with
   ``serve.decode`` poisoning the first lane (it fails alone, its
   batch-mates BITWISE); a request a kind through an eager bucket-1
   program against its batched bits, and one evaluation of f and of the
   trace at M = 1 against inside M = 64 (printed in ulps); the adaptive
   engine on 16 points, captured, BITWISE its eager run on the first;
   every census empty after each run; the spill engine's transfers a
   solve independent of its lanes; requests per second for each kind
   and bucket, and the spill and disk walls against the device tier's;
   no ``fused_lincomb`` launch and no plain call (counted);
19. LM training (``repro_torch.launch.train``), deterministic algorithms
   on: (a) the RWKV6 backward kernel ``rwkv6_chunked_bwd_fp32`` against
   ``rwkv6_plain_vjp`` within ``RWKV6_BWD_TOL`` over dh 16/32/64, chunk
   32/64, ragged S, fp32 and bf16 r/k/v and the training shape (B, S, H,
   dh) = (4, 2048, 64, 64) with bf16 r/k/v read in place, BITWISE on a
   second call, its three wrong answers beyond 10x, timed beside its bound
   and plain version (no library call computes it); (b) one
   ``make_train_step`` step of reduced TinyLlama (fp32, the chunked custom
   backward at 600 positions: two 512-row blocks, the second ragged) and
   RWKV6-7B (S 300, the RWKV6 kernels, counted) on the card against the
   port on the CPU from the same parameters, and the none/full/sqrt/
   revolve(1) depth remat gradients BITWISE equal on the card; (c)
   TinyLlama-1.1B at its full config (22 layers, bf16, remat sqrt, the
   chunked custom backward) for 4 steps of batch 2 x 4096 with a
   checkpoint directory and a ``MetricsSink`` (step ms, tokens/s, the
   allocator's peak over the first step), then again with step 2 poisoned:
   one step skipped, the committed losses BITWISE the clean run's; (d)
   RWKV6-7B at full width with 4 of its 32 layers (the fp32 moments of 32
   layers do not fit 80 GB) for 3 steps of batch 4 x 2048, its RWKV6
   forward and backward launches counted against
   ``expected_rwkv6_train_calls``;
11. last: one JSON line with each kernel's launches on its main path
   (which must equal ``expected_lincomb_calls`` (phases 3-4, 15 and 16) +
   ``expected_adaptive_lincomb_calls`` / ``expected_flash_calls`` /
   ``expected_rwkv6_calls`` / ``expected_rwkv6_train_calls``), its error
   against the plain version and
   its times; then the nvidia-smi line; then the result line.

The kernels' launch counters are set to 0 just before each main path
(phases 3-4, each of phase 12's two eager fused runs, phase 15's
auto-planned classifier gradients and each of phase 16's counted
gradients, phase 17's counted gradients, adaptive request and
checkpointed training, phase 18's engines (0 expected) for
``fused_lincomb``, phase 6 and phase 17e's two
serves for the flash kernel, phase 9 for the RWKV6 kernel, phase 19d's
training for the RWKV6 forward and backward kernels) and read just after; comparisons
made outside those windows are not counted.  The counters count where the host launches,
which for a captured graph is the capture, not the replay, so the counts
come from the eager runs; the traced replays count the kernels the
device ran.  TF32 is off wherever the card is compared with the CPU;
phases 3-4, their captured runs and phase 12 use deterministic
algorithms.
"""
import os

# deterministic cuBLAS; must be set before torch initialises CUDA
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

import contextlib  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the main path's shapes: the classifier's ODE state (128 x 32 x 32 x 32),
# the CNF state (10000 x 6) and its log-density (10000,)
PATH_SHAPES = [(128, 32, 32, 32), (10000, 6), (10000,)]
ODD_SHAPES = [(1,), (7,), (4097,)]
WEIGHTS = [0.5, -0.25, 1 / 3, 2.0, -7 / 9, 0.1, 1e-3]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
CNF_TOL = dict(rtol=2e-4, atol=2e-5)   # fp32 card vs CPU, summation order
CLS_LOSS_RTOL = 1e-5
CLS_GRAD_TOL = 1e-3  # max|card - cpu| / max|cpu| per leaf
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
FP32_FLOP_PER_S = 67e12   # H100 SXM fp32 outside the tensor cores
# the flash kernels' limits, grid, inputs and wrong answers:
# repro_torch.kernels.flash_cases
# the bf16 CUDA-core kernel that the tensor-core one replaced, at the
# slice's shape (NVIDIA H100 80GB HBM3, 700 W)
EARLIER_FLASH_MS = 5.1872
# the LM slice: TinyLlama-1.1B at full width, the kernel's attention path
LM = dict(arch="tinyllama-1.1b", batch=8, prompt_len=1920, gen=128,
          decode_slice=8)
LM_BF16_REL_TOL = 5e-2   # pallas vs naive last logits, bf16, 22 layers:
#                          max|diff| / max|logit|, bf16 rounding of the
#                          residual stream in another order, 22 times
LM_FP32_REL_TOL = 1e-4   # pallas vs naive, fp32, 2 layers
LM_CPU_REL_TOL = 1e-4    # card vs CPU port, fp32 (TF32 off), 2 layers
# the RWKV6 kernel's limits, grid and inputs: repro_torch.kernels.rwkv6_cases
RWKV6_SLICE = (8, 64, 2048, 64)     # (B, H, S, dh) of the RWKV6 slice
WRONG_MARGIN = 10   # a deliberately wrong answer must exceed each limit 10x
# the RWKV6 slice: RWKV6-7B at full width; the prompt is above the
# 256-token switch, so every layer's prefill runs the kernel
RWKV = dict(arch="rwkv6-7b", batch=8, prompt_len=2048, gen=64,
            decode_slice=8)


#: results an earlier phase keeps for a later one's comparison
KEPT = {}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def bits(x):
    import torch
    return x.contiguous().view(torch.int32 if x.dtype == torch.float32
                               else torch.int64)


def rel_err(a, b):
    """max|a - b| / max|b|, in float64."""
    return max_abs(a, b) / max(float(b.double().abs().max()), 1e-30)


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def time_ms(fn, iters=50, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


SESSIONS = 4     # profiling sessions a traced window may take
LEAD_MARKS = 1024  # spin kernels that open every traced window
TAIL_MARKS = 64    # spin kernels that close every traced window
TAIL_PAUSE_S = 0.05  # host seconds a session runs on after its last mark
# what the sessions lost: their count, the most opening marks one session
# lost, and the sessions that lost every mark at one end
PROFILER_LOSS = {"sessions": 0, "most_opening_marks_lost": 0,
                 "sessions_failed": 0}


def device_kernels(fn, iters=1):
    """[(kernel name, device microseconds, start us, end us)] of the
    kernels ``fn`` runs, from the profiler's CUPTI records, and the host
    milliseconds of the window (ending in a synchronize).

    ``torch.profiler`` on the H100 machine loses records at the ends of a
    session, never in the middle, in two ways.  At the start it drops the
    first records of every session, a count that grows with the sessions
    the process has run, so ``LEAD_MARKS`` spin kernels open the window.
    At the end it drops the records whose kernels finished just before
    the session stopped, more of them after a large window, so the
    session stays open ``TAIL_PAUSE_S`` after the ``TAIL_MARKS`` closing
    marks.  The window's records are complete when a mark survives at
    both ends; a session where one end lost every mark is traced again,
    calling ``fn`` anew, up to ``SESSIONS`` sessions; then the run
    fails."""
    import gc

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def marks(n):
        for _ in range(n):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    for _ in range(SESSIONS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marks(LEAD_MARKS)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            marks(TAIL_MARKS)
            time.sleep(TAIL_PAUSE_S)
        recs = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        del prof
        is_mark = ["spin_kernel" in e.name for e in recs]
        lead = next((i for i, m in enumerate(is_mark) if not m), len(recs))
        PROFILER_LOSS["sessions"] += 1
        PROFILER_LOSS["most_opening_marks_lost"] = max(
            PROFILER_LOSS["most_opening_marks_lost"], LEAD_MARKS - lead)
        if recs and is_mark[0] and is_mark[-1]:
            return [(e.name, e.time_range.elapsed_us(), e.time_range.start,
                     e.time_range.end) for e, m in zip(recs, is_mark)
                    if not m], wall_ms
        PROFILER_LOSS["sessions_failed"] += 1
        tail = next((i for i, m in enumerate(reversed(is_mark)) if not m),
                    len(recs))
        print(f"  (profiler: a session lost the records at one end of its "
              f"window; {len(recs)} records, {lead} of {LEAD_MARKS} opening "
              f"and {tail} of {TAIL_MARKS} closing marks left)", flush=True)
        del recs
        gc.collect()
    fail(f"the profiler lost records of a traced window in {SESSIONS} "
         "sessions")


def device_ms(fn, iters=20):
    """Device time per call: the durations of the kernels ``fn`` runs."""
    fn()
    kernels, _ = device_kernels(fn, iters)
    return sum(k[1] for k in kernels) / iters / 1e3


def busy_us(kernels):
    """Device busy time of ``device_kernels`` records: the length of the
    union of their intervals, which is less than the sum of their
    durations where kernels overlap (cuDNN's FFT convolutions run
    branches on streams of their own, which a graph captures as parallel
    nodes)."""
    total, end = 0.0, None
    for _, _, a, b in sorted(kernels, key=lambda k: k[2]):
        if end is None or a >= end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def traced(label, fn, kernel, card, replayed=False):
    """Trace one call of ``fn`` (``device_kernels``) and print where its
    time goes: host wall, device busy, idle share, kernel count, the
    launches and share of ``kernel`` (a substring of its name) and the six
    kernels that take the most time.  A window whose records hold no
    kernel is reported as such: for a replayed graph that means the
    profiler did not resolve the graph's kernel records, never that the
    graph ran none."""
    kernels, wall_ms = device_kernels(fn)
    busy = busy_us(kernels) / 1e3
    summed = sum(k[1] for k in kernels) / 1e3
    kn = [k[1] for k in kernels if kernel in k[0]]
    # copies: dtype casts, .contiguous(), padding (PyTorch's copy kernels)
    copies = [k[1] for k in kernels if "copy" in k[0].lower()]
    res = dict(wall_ms=wall_ms, kernels=len(kernels),
               kernel_launches=len(kn), kernel_ms=sum(kn) / 1e3,
               summed_ms=summed, copy_kernels=len(copies),
               copy_ms=sum(copies) / 1e3)
    if not kernels:
        print(f"traced {label}: wall {wall_ms:.1f} ms; the profiler "
              "recorded no kernel in the window"
              + (" (it did not resolve the replayed graph's kernel "
                 "records: busy time and idle share not measured)"
                 if replayed else "") + f" {card}", flush=True)
        return dict(res, busy_ms=None, idle_share=None, kernel_share=None,
                    top=[])
    res.update(busy_ms=busy, idle_share=1 - busy / wall_ms,
               kernel_share=sum(kn) / 1e3 / summed)
    print(f"traced {label}: wall {wall_ms:.1f} ms, device busy {busy:.3f} "
          f"ms (kernel durations summed {summed:.3f}), idle share "
          f"{1 - busy / wall_ms:.4f}; {len(kernels)} kernels; "
          f"{kernel} {len(kn)} launches, {sum(kn) / 1e3:.3f} ms = "
          f"{sum(kn) / 1e3 / summed:.4f} of kernel time; copy kernels "
          f"{len(copies)} = {len(copies) / len(kernels):.4f} of the kernels, "
          f"{sum(copies) / 1e3:.3f} ms = {sum(copies) / 1e3 / summed:.4f} of "
          f"kernel time {card}", flush=True)
    by_name = {}
    for n, us, _, _ in kernels:
        cnt, tot = by_name.get(n, (0, 0.0))
        by_name[n] = (cnt + 1, tot + us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    res["top"] = [(n[:80], c, t / 1e3) for n, (c, t) in top]
    for n, (c, t) in top:
        print(f"    {t / 1e3:9.3f} ms {t / 1e3 / summed:.4f} x{c:<5d} "
              f"{n[:100]}")
    return res


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

def operands(shape, dtype, n_terms, gen, device):
    """base and terms as views into one buffer at storage offsets >= 1."""
    import torch
    n = math.prod(shape)
    buf = torch.randn(1 + (n_terms + 1) * n, generator=gen,
                      dtype=dtype).to(device)
    views = [buf[1 + i * n: 1 + (i + 1) * n].view(shape)
             for i in range(n_terms + 1)]
    return views[0], views[1:]


def kernel_phase(card):
    import torch
    from repro_torch.kernels.ops import fused_lincomb
    from repro_torch.kernels.ref import lincomb_plain

    gen = torch.Generator().manual_seed(1)
    dev = torch.device("cuda")
    n_cases, worst = 0, 0.0
    for dtype in (torch.float32, torch.float64):
        for shape in PATH_SHAPES + ODD_SHAPES:
            for k in range(1, 8):
                base, terms = operands(shape, dtype, k, gen, dev)
                ws = WEIGHTS[:k]
                h = torch.tensor(0.0123, dtype=dtype).to(dev)
                for scale, bc in ((0.05, None), (0.05, 0.0), (None, -1.5),
                                  (h, None), (h, 2 / 3)):
                    out = fused_lincomb(base, terms, ws, scale, bc)
                    ref = lincomb_plain(base, terms, ws, scale, bc)
                    torch.cuda.synchronize()
                    check(out.shape == ref.shape and out.dtype == ref.dtype,
                          f"lincomb shape/dtype {shape} {dtype}")
                    check(torch.equal(bits(out), bits(ref)),
                          f"fused_lincomb != lincomb_plain bitwise: {dtype} "
                          f"{shape} terms={k} scale={scale} bc={bc} "
                          f"max|diff|={max_abs(out, ref)}")
                    worst = max(worst, max_abs(out, ref))
                    n_cases += 1
    # NaN and -0 travel through base_coeff=0.0 exactly as the eager chain
    lam = torch.tensor([float("nan"), -1.0, 1.0, -0.0], device=dev)
    zero = torch.zeros(4, device=dev)
    out = fused_lincomb(lam, [zero], [1.0], None, 0.0)
    check(torch.equal(bits(out), bits(lincomb_plain(lam, [zero], [1.0], None,
                                                    0.0))),
          "NaN/-0 propagation differs")
    print(f"kernel phase: fused_lincomb bitwise equal to lincomb_plain on "
          f"{n_cases} cases (fp32+fp64, static 1-7 terms, base_coeff "
          f"None/0.0/float, scaled with device h, path and odd shapes at "
          f"storage offsets); max|diff| = {worst} {card}", flush=True)

    # times at the main path's shapes: device time per call from the
    # profiler's kernel records, and the time per call of the Python call
    # (CUDA events around a loop of calls: host overhead included)
    rows = []
    for shape, k, form, dtype in [((128, 32, 32, 32), 4, "static", torch.float32),
                                  ((128, 32, 32, 32), 1, "static", torch.float32),
                                  ((128, 32, 32, 32), 4, "scaled", torch.float32),
                                  ((10000, 6), 6, "static", torch.float32),
                                  ((10000,), 6, "static", torch.float32)]:
        base, terms = operands(shape, dtype, k, gen, dev)
        scale = 0.25 if form == "static" else torch.tensor(0.25).to(dev)
        ws = WEIGHTS[:k]
        fused = lambda: fused_lincomb(base, terms, ws, scale)  # noqa: E731
        plain = lambda: lincomb_plain(base, terms, ws, scale)  # noqa: E731
        nbytes = (k + 2) * base.numel() * base.element_size()
        row = dict(shape=list(shape), n_terms=k, form=form,
                   dtype=str(dtype).replace("torch.", ""), bytes=nbytes,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   call_ms=time_ms(fused), plain_call_ms=time_ms(plain))
        row["ms"], row["plain_ms"] = device_ms(fused), device_ms(plain)
        rows.append(row)
        print(f"  lincomb {form:6s} {str(shape):18s} terms={k} "
              f"kernel {row['ms']:.6f} ms (call {row['call_ms']:.6f})  plain "
              f"{row['plain_ms']:.6f} ms (call {row['plain_call_ms']:.6f})  "
              f"bound {row['bound_ms']:.6f} ms "
              f"(bytes) {card}", flush=True)
    return worst, rows


# ---------------------------------------------------------------------------
# phase 3: CNF density + score at POWER width
# ---------------------------------------------------------------------------

CNF = dict(dim=6, hidden=(64, 64, 64), batch=10000, method="dopri5",
           n_steps=10, adjoint="pnode")


def cnf_requests(theta, x, fused):
    """(log-density, score) as the serving engine's two request kinds:
    a forward-only density and a score through the full reverse sweep."""
    import torch
    from repro_torch.core.cnf import cnf_log_prob
    from repro_torch.models.ode_nets import cnf_vf

    kw = dict(dt=1.0 / CNF["n_steps"], n_steps=CNF["n_steps"],
              method=CNF["method"], adjoint=CNF["adjoint"],
              fused_stages=fused)
    with torch.no_grad():
        density = cnf_log_prob(cnf_vf, x, theta, **kw)
    xg = x.detach().clone().requires_grad_(True)
    lp = cnf_log_prob(cnf_vf, xg, theta, **kw)
    (score,) = torch.autograd.grad(lp.sum(), xg)
    return density, score


# ---------------------------------------------------------------------------
# phase 4: classifier training
# ---------------------------------------------------------------------------

CLS = dict(channels=32, batch=128, method="rk4", n_steps=4, adjoint="pnode",
           steps=5, image_size=32)


def classifier_grads(params, images, labels, fused):
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.core.depth_ode import ODEBlock
    from repro_torch.models.ode_nets import (classifier_apply, conv_vf,
                                             softmax_xent)

    block = ODEBlock(conv_vf, n_steps=CLS["n_steps"], method=CLS["method"],
                     adjoint=CLS["adjoint"], fused_stages=fused)
    leaves = [p.detach().requires_grad_(True)
              for p in pytree.tree_leaves(params)]
    p = pytree.tree_unflatten(leaves, pytree.tree_structure(params))
    logits = classifier_apply(p, images,
                              odeint_fn=lambda vf, u, th: block(u, th))
    loss = softmax_xent(logits, labels)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


# ---------------------------------------------------------------------------
# phases 3b-4b: the CNF request and the classifier gradient captured
# ---------------------------------------------------------------------------

GRAPH_REPLAYS = 5   # replays of the captured CNF request that are timed


def untraced_idle(trace, wall_ms, label, card):
    """Put into ``trace`` (a ``traced`` result) the idle share of an
    untraced window of ``wall_ms`` with the traced window's busy time: the
    profiler's own host cost (a record for each of about 232k kernels in
    a CNF request) lengthens a traced window."""
    busy = trace["busy_ms"]
    trace["idle_share_untraced"] = None if busy is None \
        else 1 - busy / wall_ms
    if busy is not None:
        print(f"  {label}: idle share {trace['idle_share_untraced']:.4f} "
              f"against the untraced {wall_ms:.1f} ms (traced busy "
              f"{busy:.3f} ms) {card}", flush=True)


def graph_ode_phase(card, cnf_theta, x, eager_cnf, cls_params, batches,
                    eager_cls, opt):
    """The CNF request and the classifier gradient through ``StepGraph``
    (``fused_lincomb`` launched from the replayed graphs), against the
    eager counted runs of phases 3-4 on the same inputs: the density and
    score bitwise, the step-0 gradients and every step's loss bitwise (the
    classifier trains its 5 steps again from the same weights, AdamW
    eager).  Times: the first call (warm-up, capture and one replay), the
    median of ``GRAPH_REPLAYS`` replays, a classifier step; then one
    traced replayed request and step."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.launch.graphs import StepGraph

    density, score = eager_cnf["out"]
    cnf = StepGraph(lambda th, xx: cnf_requests(th, xx, fused=True),
                    clone_outputs=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_g, s_g = cnf(cnf_theta, x)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    replay_ms = []
    for _ in range(GRAPH_REPLAYS):
        t0 = time.perf_counter()
        d_r, s_r = cnf(cnf_theta, x)
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(torch.equal(bits(a), bits(b)) for a, b in
              ((d_g, density), (s_g, score), (d_r, density), (s_r, score))),
          "CNF replayed density/score differ from the eager run: max|diff| "
          f"{max_abs(d_r, density)}, {max_abs(s_r, score)}")
    c = dict(first_ms=first_ms, ms=float(np.median(replay_ms)),
             replay_ms=replay_ms, warmup_ms=cnf.warmup_ms,
             capture_ms=cnf.capture_ms, pool_bytes=cnf.pool_bytes,
             eager_ms=eager_cnf["ms"])
    print(f"CNF request captured: replayed density and score == eager "
          f"bitwise; first call {first_ms:.1f} ms (warm-up "
          f"{cnf.warmup_ms:.1f}, capture {cnf.capture_ms:.1f}), replay "
          f"{c['ms']:.1f} ms (median of {GRAPH_REPLAYS}: "
          + ", ".join(f"{v:.1f}" for v in replay_ms)
          + f"), graph pool {cnf.pool_bytes} B {card}", flush=True)
    print(f"eager vs captured CNF request: {eager_cnf['ms']:.1f} vs "
          f"{c['ms']:.1f} ms ({eager_cnf['ms'] / c['ms']:.2f}x) {card}",
          flush=True)
    c["trace"] = traced("CNF density+score request, replayed",
                        lambda: cnf(cnf_theta, x), "lincomb_kernel", card,
                        replayed=True)
    untraced_idle(c["trace"], c["ms"], "CNF request", card)
    del cnf, d_g, s_g, d_r, s_r

    def grads(held, copied):
        params, xb, lb = copied
        return classifier_grads(params, xb, lb, fused=True)

    cls = StepGraph(grads, clone_outputs=True)
    state = opt.init(cls_params)
    params, losses, step_ms = cls_params, [], []
    for step, (xb, lb) in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g = cls((), (params, xb, lb))
        if step == 0:
            grads0 = g
        with torch.no_grad():
            params, state, _ = opt.update(
                pytree.tree_unflatten(g, pytree.tree_structure(params)),
                state, params)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    check(all(torch.equal(bits(a), bits(b))
              for a, b in zip(grads0, eager_cls["grads0"])),
          "classifier replayed step-0 gradients differ from the eager ones")
    check(losses == eager_cls["losses"],
          f"classifier replayed losses {losses} != eager "
          f"{eager_cls['losses']}")
    k = dict(first_ms=step_ms[0], ms=float(np.median(step_ms[1:])),
             step_ms=step_ms, warmup_ms=cls.warmup_ms,
             capture_ms=cls.capture_ms, pool_bytes=cls.pool_bytes,
             eager_ms=eager_cls["ms"])
    print(f"classifier captured: replayed step-0 gradients == eager bitwise "
          f"and all {len(losses)} losses equal; first step {step_ms[0]:.1f} "
          f"ms (warm-up {cls.warmup_ms:.1f}, capture {cls.capture_ms:.1f}), "
          f"step {k['ms']:.1f} ms (median of steps 1-{len(step_ms) - 1}, "
          f"gradient replayed, AdamW eager), graph pool {cls.pool_bytes} B "
          f"{card}", flush=True)
    print(f"eager vs captured classifier step: {eager_cls['ms']:.1f} vs "
          f"{k['ms']:.1f} ms ({eager_cls['ms'] / k['ms']:.2f}x) {card}",
          flush=True)
    xb, lb = batches[0]

    def step():
        _, g = cls((), (cls_params, xb, lb))
        with torch.no_grad():
            opt.update(pytree.tree_unflatten(
                g, pytree.tree_structure(cls_params)), state, cls_params)

    k["trace"] = traced("classifier training step, gradient replayed", step,
                        "lincomb_kernel", card, replayed=True)
    untraced_idle(k["trace"], k["ms"], "classifier step", card)
    return dict(cnf=c, classifier=k)


# ---------------------------------------------------------------------------
# phase 5: the flash kernel against its plain version
# ---------------------------------------------------------------------------

def flash_phase(card, dev):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_cases as fc
    from repro_torch.kernels.ops import flash_attention, flash_attention_bhsd
    from repro_torch.kernels.ref import attention_plain

    rng = np.random.RandomState(2)
    b, h, hkv, s, dh = fc.FLASH_SLICE
    cases = [(shape, c, w) for shape in fc.FLASH_SHAPES
             for c, w in fc.FLASH_MASKS] + fc.FLASH_RAGGED
    cases.append(((b, h, hkv, s, s, dh), True, 0))
    worst = {"float32": 0.0, "bfloat16": 0.0}   # max|kernel - plain|
    ratios = {"float32": 0.0, "bfloat16": 0.0}  # worst ratio to the limit
    margins = dict.fromkeys(fc.WRONG_ANSWERS, 0.0)
    n_cases = 0
    for shape, causal, window in cases:
        mask = dict(causal=causal, window=window)
        # bf16, the tensor-core kernel: the derived elementwise limit at
        # diffuse and sharp scores; each wrong answer must exceed it
        for sharp in fc.FLASH_SHARPNESS:
            q, k, v = fc.flash_inputs(*shape, rng, device=dev,
                                      dtype=torch.bfloat16, sharpness=sharp)
            out = flash_attention_bhsd(q, k, v, **mask)
            torch.cuda.synchronize()
            plain = attention_plain(q, k, v, **mask)
            r = fc.bf16_ratio(out, q, k, v, plain=plain, **mask)
            check(out.dtype == torch.bfloat16 and out.shape == plain.shape
                  and r <= 1,
                  f"bf16 flash_attention_bhsd beyond the derived limit: "
                  f"{shape} {mask} sharpness {sharp}: ratio {r:.3f}, "
                  f"max|diff| {max_abs(out, plain)}")
            worst["bfloat16"] = max(worst["bfloat16"], max_abs(out, plain))
            ratios["bfloat16"] = max(ratios["bfloat16"], r)
            n_cases += 1
            if shape[3] <= 1024:
                for name, wrong in fc.WRONG_ANSWERS.items():
                    margins[name] = max(margins[name], fc.bf16_ratio(
                        wrong(q, k, v, **mask), q, k, v, plain=plain, **mask))
        # fp32, the CUDA-core kernel: the TPU kernel's arithmetic
        q, k, v = fc.flash_inputs(*shape, rng, device=dev)
        out = flash_attention_bhsd(q, k, v, **mask)
        torch.cuda.synchronize()
        plain = attention_plain(q, k, v, **mask)
        r = fc.fp32_ratio(out, plain)
        check(out.dtype == torch.float32 and out.shape == plain.shape
              and r <= 1, f"fp32 flash_attention_bhsd beyond {fc.FLASH_TOL}: "
              f"{shape} {mask}: max|diff| {max_abs(out, plain)}")
        worst["float32"] = max(worst["float32"], max_abs(out, plain))
        ratios["float32"] = max(ratios["float32"], r)
        n_cases += 1
    for name, m in margins.items():
        check(m >= fc.WRONG_MARGIN, f"a wrong flash answer ({name}) exceeds "
              f"the bf16 limit only {m:.2f}x (needs {fc.WRONG_MARGIN}x)")
    print(f"flash phase: flash_attention_bhsd within its limits on {n_cases} "
          f"cases (test_kernels grid, cross lengths 64x192, every head dim "
          f"at S = 150 x {len(fc.FLASH_MASKS)} masks; ragged and Sq != Sk "
          f"at every head dim; the slice's {fc.FLASH_SLICE}; bf16 at "
          f"sharpness {fc.FLASH_SHARPNESS}, and fp32): worst ratio to the "
          f"limit bf16 {ratios['bfloat16']:.4f} (the derived limit), fp32 "
          f"{ratios['float32']:.4f} ({fc.FLASH_TOL}); max|diff| bf16 "
          f"{worst['bfloat16']:.3e}, fp32 {worst['float32']:.3e} {card}",
          flush=True)
    print("  wrong answers over the bf16 limit (worst case, must be >= "
          f"{fc.WRONG_MARGIN}x): " + ", ".join(f"{k} {m:.1f}x"
                                              for k, m in margins.items()),
          flush=True)

    # the model layout: flash_attention on strided (B,S,H,Dh) views equals
    # the contiguous call bitwise, and launches the kernel and nothing else
    for dtype in (torch.bfloat16, torch.float32):
        qs, ks, vs = fc.flash_inputs(b, h, hkv, s, s, dh, rng, device=dev,
                                     dtype=dtype, layout="bshd")
        o = flash_attention(qs, ks, vs)
        oc = flash_attention_bhsd(*(t.transpose(1, 2).contiguous()
                                    for t in (qs, ks, vs)))
        check(o.shape == qs.shape and o.is_contiguous()
              and torch.equal(o, oc.transpose(1, 2)),
              f"{dtype} flash_attention on (B,S,H,Dh) views differs from the "
              "contiguous call")
        # a session can keep its bracketing marks and lose the window's
        # own record (torch.profiler on an H100 has done so): such an
        # empty window is traced again; a window with any kernel but the
        # flash kernel still fails
        for _ in range(SESSIONS):
            launched = [k[0] for k in
                        device_kernels(lambda: flash_attention(qs, ks, vs))[0]]
            if launched:
                break
        check(len(launched) == 1 and "flash_fwd_kernel" in launched[0],
              f"flash_attention launched {launched}: copies on the card")
        print(f"  model layout {dtype}: flash_attention on (B,S,H,Dh) views "
              f"of {fc.FLASH_SLICE} == the contiguous call bitwise; one "
              f"launch, no copies ({launched[0][:60]})", flush=True)
    del qs, ks, vs, o, oc

    # times at the slice's shape, causal: the kernel's device time (profiler
    # kernel records) and call time (CUDA events over a loop of Python
    # calls), the plain version's, and SDPA's as the library yardstick
    pairs = b * h * s * (s + 1) // 2          # unmasked (query, key) pairs
    flops = 4 * dh * pairs                    # q.k and p.v, 2 FLOP per MAC
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        q, k, v = fc.flash_inputs(b, h, hkv, s, s, dh, rng, device=dev,
                                  dtype=dtype)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
        kern = lambda: flash_attention_bhsd(q, k, v)  # noqa: E731
        plain = lambda: attention_plain(q, k, v)  # noqa: E731
        row = dict(shape=list(fc.FLASH_SLICE), dtype=name, causal=True,
                   flops=flops, bytes=nbytes,
                   bound_ms=max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3,
                   call_ms=time_ms(kern, 20, 3),
                   plain_call_ms=time_ms(plain, 3, 1))
        row["ms"] = device_ms(kern, iters=10)
        row["plain_ms"] = device_ms(plain, iters=3)
        row["bound_by"] = ("operations" if flops / peak
                           >= nbytes / HBM_BYTES_PER_S else "bytes")
        row["x_bound"] = row["ms"] / row["bound_ms"]
        if dtype == torch.bfloat16:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True, enable_gqa=True)
            row["library_ms"] = device_ms(lib, 10)
            row["library_call_ms"] = time_ms(lib, 20, 3)
            row["x_library"] = row["ms"] / row["library_ms"]
            check(torch.allclose(lib().float(), kern().float(), rtol=5e-2,
                                 atol=5e-2),
                  "SDPA and the flash kernel disagree at the slice's shape")
        rows[name] = row
        del q, k, v
    bf, f32 = rows["bfloat16"], rows["float32"]
    print(f"  flash bf16 (wgmma) {fc.FLASH_SLICE} causal: kernel "
          f"{bf['ms']:.4f} ms (call {bf['call_ms']:.4f}; the earlier "
          f"CUDA-core kernel {EARLIER_FLASH_MS}), bound "
          f"{bf['bound_ms']:.4f} ms "
          f"({bf['bound_by']}: {flops:.4e} FLOP at "
          f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s, {bf['bytes']} B), SDPA "
          f"{bf['library_ms']:.4f} ms (call {bf['library_call_ms']:.4f}): "
          f"{bf['x_library']:.3f}x SDPA, {bf['x_bound']:.3f}x the bound, "
          f"{flops / bf['ms'] / 1e9:.1f} TFLOP/s; plain {bf['plain_ms']:.4f} "
          f"ms (call {bf['plain_call_ms']:.4f}) {card}", flush=True)
    print(f"  flash fp32 (CUDA cores) {fc.FLASH_SLICE} causal: kernel "
          f"{f32['ms']:.4f} ms (call {f32['call_ms']:.4f}), bound "
          f"{f32['bound_ms']:.4f} ms ({f32['bound_by']} at "
          f"{FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s): {f32['x_bound']:.3f}x; "
          f"plain {f32['plain_ms']:.4f} ms (call {f32['plain_call_ms']:.4f})"
          f" {card}", flush=True)
    torch.cuda.empty_cache()
    return dict(worst=worst, ratios=ratios, margins=margins, rows=rows,
                cases=n_cases)


# ---------------------------------------------------------------------------
# phases 6-7: LM serving at TinyLlama-1.1B full width, and agreement
# ---------------------------------------------------------------------------

def traced_serve(cfg, params, spec, kernel, card, dev, decode_ms):
    """Where the time goes: one traced prefill wave and one traced decode
    slice of ``spec``'s engine, with ``kernel``'s share of device time.
    Each engine's first step prefills its wave and later steps decode
    slices, so a repeated profiling session takes a fresh engine for the
    prefill and the next slice for the decode.  An engine's first decode
    slice warms up and captures its decode graph, so it runs untraced and
    the traced slices are replays."""
    import numpy as np
    from repro_torch.serve import LMEngine

    prompts = np.random.RandomState(3).randint(
        0, cfg.vocab_size, (spec["batch"], spec["prompt_len"]))

    def engine():
        eng = LMEngine(cfg, lanes=spec["batch"],
                       prompt_len=spec["prompt_len"], max_gen=spec["gen"],
                       decode_slice=spec["decode_slice"], params=params,
                       device=dev)
        for p_ in prompts:
            eng.submit(p_)
        return eng

    fresh, prefilled = [engine() for _ in range(SESSIONS)], []

    def prefill_wave():
        prefilled.append(fresh.pop())
        prefilled[-1].step()

    shape = f"{spec['batch']} x {spec['prompt_len']}"
    traces = {"prefill": traced(f"{cfg.name} prefill ({shape})",
                                prefill_wave, kernel, card)}
    del fresh
    prefilled[-1].step()  # the first slice: warm-up and capture
    traces["decode slice"] = traced(
        f"{cfg.name} decode slice, replayed ({shape}, "
        f"{spec['decode_slice']} steps)", lambda: prefilled[-1].step(),
        kernel, card, replayed=True)
    untraced_idle(traces["decode slice"], spec["decode_slice"] * decode_ms,
                  f"{cfg.name} decode slice", card)
    del prefilled
    return traces


def serve_phase(cfg, spec, kernel, counts, expected, card, dev):
    """Serve ``spec`` (batch, prompt, greedy tokens, decode slice) through
    ``repro_torch.launch.serve.serve`` at ``cfg``'s full width, with
    random weights drawn on the card from seed 0; one engine whose lanes
    hold the whole batch, so one prefill wave.  The counters are set to 0
    just before the serve and ``counts()`` (kernel launches, plain calls)
    read just after: the launches must equal ``expected`` with no plain
    call.  Then one traced prefill and one traced decode slice.  Returns
    (params, results)."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm

    t0 = time.time()
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    print(f"LM: {cfg.name} full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, dh "
          f"{cfg.dh}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype}), {n_params} parameters drawn on the card in "
          f"{time.time() - t0:.1f} s", flush=True)

    param_bytes = sum(t.numel() * t.element_size()
                      for t in pytree.tree_leaves(params))
    allocated = torch.cuda.memory_allocated()
    # cuBLAS keeps a workspace for each stream a GEMM ran on, through the
    # caching allocator; clearing them (they come back at the next GEMM)
    # tells them apart from the earlier phases' live tensors
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    workspaces = None
    if clear is not None:
        clear()
        workspaces = allocated - torch.cuda.memory_allocated()
    print(f"memory_allocated before the {cfg.name} serve: {allocated} B = "
          f"parameters {param_bytes} B + other {allocated - param_bytes} B "
          + (f"(cuBLAS workspaces {workspaces} B, cleared now; earlier "
             f"phases' tensors {allocated - param_bytes - workspaces} B)"
             if clear is not None else "(this torch cannot clear cuBLAS "
             "workspaces: not split)"), flush=True)
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.time()
    tokens, stats = serve(cfg, batch=spec["batch"],
                          prompt_len=spec["prompt_len"], gen=spec["gen"],
                          decode_slice=spec["decode_slice"], temperature=0.0,
                          replicas=1, device=dev, params=params)
    wall_s = time.time() - t0
    launches, plain = counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"{kernel} launches on the {cfg.name} serve path: {launches} "
          f"(expected {expected}: one per layer that runs it x 1 prefill "
          f"wave); plain calls {plain}", flush=True)
    check(plain == 0, f"{plain} plain {kernel} calls on the card path")
    check(launches > 0 and launches == expected,
          f"{kernel} launches {launches} != expected {expected}")
    check(tuple(tokens.shape) == (spec["batch"], spec["gen"]),
          f"tokens shape {tuple(tokens.shape)}")
    check(int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size,
          "tokens out of the vocabulary")
    print(f"LM serve {cfg.name}: batch {spec['batch']}, prompt "
          f"{spec['prompt_len']}, gen {spec['gen']} (max_seq "
          f"{spec['prompt_len'] + spec['gen']}), decode_slice "
          f"{spec['decode_slice']}, greedy: tokens {tuple(tokens.shape)} in "
          f"[{int(tokens.min())}, {int(tokens.max())}]; warm-up "
          f"{stats['warmup_s'] * 1e3:.1f} ms, prefill "
          f"{stats['prefill_s'] * 1e3:.1f} ms, decode "
          f"{stats['decode_s'] * 1e3:.1f} ms, steady "
          f"{stats['tok_per_s_steady']:.1f} tok/s, end-to-end "
          f"{stats['tok_per_s']:.1f} tok/s, serve() wall {wall_s:.2f} s; "
          f"max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB; the "
          f"serve's own {peak - allocated} B above what was allocated "
          f"before it) {card}", flush=True)
    (graph,) = stats["decode_graphs"]
    steady_steps = stats["tok_per_s_steady"] * stats["steady_s"] \
        / spec["batch"]
    print(f"  decode replayed from a CUDA graph: warm-up "
          f"{graph['warmup_ms']:.1f} ms, capture {graph['capture_ms']:.1f} "
          f"ms, graph pool {graph['pool_bytes']} B, static decode state "
          f"{stats['static_state_bytes']} B (both inside the peak); "
          f"{stats['steady_s'] * 1e3 / steady_steps:.3f} ms a steady step "
          f"{card}", flush=True)
    traces = traced_serve(cfg, params, spec, kernel, card, dev,
                          stats["steady_s"] * 1e3 / steady_steps)
    return params, dict(launches=launches, expected=expected, stats=stats,
                        peak_bytes=peak, traces=traces, tokens=tokens,
                        allocated_before=allocated, param_bytes=param_bytes,
                        cublas_workspace_bytes=workspaces,
                        decode_ms=stats["steady_s"] * 1e3 / steady_steps)


LM_EAGER_TOKENS = 24   # greedy tokens of the eager comparison loops (>= 16)


def eager_decode_phase(cfg, params, spec, res, card, dev):
    """The engine's replayed decode against eager PyTorch on the card: an
    eager greedy loop over ``lm.prefill`` + ``lm.decode_step`` on the
    serve's weights and prompts (``SyntheticLM``, seed 0, as ``serve``
    draws them), sampling as the engine does, must give the serve's first
    ``LM_EAGER_TOKENS`` tokens bitwise; its times are the eager side of
    the comparison (prefill, decode ms a step, steady and end-to-end
    tok/s over its own tokens)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import lm

    b, n = spec["batch"], min(LM_EAGER_TOKENS, spec["gen"])
    cell = ShapeCell("serve", spec["prompt_len"], b, "prefill")
    prompt = SyntheticLM(cfg, cell, seed=0).batch(0)["tokens"].numpy()
    toks = torch.from_numpy(prompt.astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        state, logits = lm.prefill(cfg, params, {"tokens": toks},
                                   spec["prompt_len"] + spec["gen"])
        tok = torch.argmax(logits, dim=-1)[:, None]
        out = [tok[:, 0]]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(n - 1):
            logits, state = lm.decode_step(cfg, params, state, tok,
                                           spec["prompt_len"] + i)
            tok = torch.argmax(torch.nan_to_num(logits), dim=-1)[:, None]
            out.append(tok[:, 0])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    eager = torch.stack(out, 1).cpu().to(torch.int32)
    served = res["tokens"][:, :n]
    check(torch.equal(eager, served),
          f"{cfg.name}: the engine's replayed greedy tokens differ from the "
          f"eager loop's: {int((eager != served).sum())} of {eager.numel()}")
    stats = res["stats"]
    e = dict(prefill_ms=(t1 - t0) * 1e3, decode_ms=(t2 - t1) * 1e3 / (n - 1),
             tok_per_s_steady=b * (n - 1) / (t2 - t1),
             tok_per_s=b * n / (t2 - t0), tokens=n)
    c = dict(prefill_ms=stats["prefill_s"] * 1e3, decode_ms=res["decode_ms"],
             tok_per_s_steady=stats["tok_per_s_steady"],
             tok_per_s=stats["tok_per_s"], tokens=spec["gen"])
    print(f"agreement: {cfg.name} engine (decode replayed) == eager loop "
          f"(lm.prefill + lm.decode_step), greedy tokens bitwise, batch {b}, "
          f"{n} tokens {card}", flush=True)
    print(f"eager vs captured {cfg.name} decode: {e['decode_ms']:.3f} vs "
          f"{c['decode_ms']:.3f} ms a step "
          f"({e['decode_ms'] / c['decode_ms']:.2f}x); steady {e['tok_per_s_steady']:.1f} vs "
          f"{c['tok_per_s_steady']:.1f} tok/s; end to end "
          f"{e['tok_per_s']:.1f} tok/s ({n} tokens) vs {c['tok_per_s']:.1f} "
          f"tok/s ({spec['gen']} tokens, the capture included); prefill "
          f"{e['prefill_ms']:.1f} vs {c['prefill_ms']:.1f} ms {card}",
          flush=True)
    return dict(eager=e, captured=c)


def lm_agreement_phase(cfg, params, card, dev):
    import dataclasses
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.models import lm

    naive = dataclasses.replace(cfg, attn_impl="naive")
    rs = np.random.RandomState(5)

    # bf16, full depth: the kernel's prefill against the naive one
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (4, 1024))).to(dev)
    with torch.no_grad():
        _, last_p = lm.prefill(cfg, params, {"tokens": toks}, 1024)
        _, last_n = lm.prefill(naive, params, {"tokens": toks}, 1024)
    rel = rel_err(last_p, last_n)
    check(rel <= LM_BF16_REL_TOL and bool(torch.isfinite(last_p).all()),
          f"bf16 pallas vs naive prefill: max|diff|/max|logit| {rel}")
    print(f"agreement: bf16 prefill, {cfg.n_layers} layers, batch 4 x 1024, "
          f"pallas vs naive last logits max|diff|/max|logit| {rel:.3e} "
          f"(tolerance {LM_BF16_REL_TOL})", flush=True)

    # fp32, full width, 2 layers: logits and 16 greedy tokens
    f32 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                              compute_dtype="float32")
    p32 = lm.init_params(f32, torch.Generator(dev).manual_seed(1),
                         device=dev)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (4, 512))).to(dev)
    runs = {}
    with torch.no_grad():
        for c in (f32, dataclasses.replace(f32, attn_impl="naive")):
            state, last = lm.prefill(c, p32, {"tokens": toks}, 512 + 16)
            tok, out = torch.argmax(last, -1)[:, None], []
            for i in range(16):
                logits, state = lm.decode_step(c, p32, state, tok, 512 + i)
                tok = torch.argmax(logits, -1)[:, None]
                out.append(tok)
            runs[c.attn_impl] = (last, torch.cat(out, 1))
    rel = rel_err(runs["pallas"][0], runs["naive"][0])
    same = torch.equal(runs["pallas"][1], runs["naive"][1])
    check(rel <= LM_FP32_REL_TOL and same,
          f"fp32 pallas vs naive: rel {rel}, greedy tokens equal {same}")
    print(f"agreement: fp32 prefill, full width, 2 layers, batch 4 x 512, "
          f"pallas vs naive last logits max|diff|/max|logit| {rel:.3e} "
          f"(tolerance {LM_FP32_REL_TOL}); 16 greedy decode tokens equal",
          flush=True)

    # the card against the port on the CPU: fp32, TF32 off, 2 layers
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 64)))
    p_cpu = pytree.tree_map(lambda t: t.cpu(), p32)
    teacher = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 8)))
    worst = 0.0
    with torch.no_grad():
        st_g, lg_g = lm.prefill(f32, p32, {"tokens": toks.to(dev)}, 72)
        st_c, lg_c = lm.prefill(f32, p_cpu, {"tokens": toks}, 72)
        worst = rel_err(lg_g.cpu(), lg_c)
        for i in range(8):
            tok = teacher[:, i:i + 1]
            lg_g, st_g = lm.decode_step(f32, p32, st_g, tok.to(dev), 64 + i)
            lg_c, st_c = lm.decode_step(f32, p_cpu, st_c, tok, 64 + i)
            worst = max(worst, rel_err(lg_g.cpu(), lg_c))
    check(worst <= LM_CPU_REL_TOL,
          f"card vs CPU: worst max|diff|/max|logit| {worst}")
    print(f"agreement: card vs the port on the CPU, fp32 (TF32 off), full "
          f"width, 2 layers, batch 2 x 64: prefill and 8 teacher-forced "
          f"decode steps, worst max|diff|/max|logit| {worst:.3e} "
          f"(tolerance {LM_CPU_REL_TOL}) {card}", flush=True)


# ---------------------------------------------------------------------------
# phases 8-10: the RWKV6 kernel, RWKV6-7B serving, and agreement
# ---------------------------------------------------------------------------

def rwkv6_state_late(r, k, v, logw, u, *, chunk):
    """A deliberately wrong chunked RWKV6: each chunk's output reads the
    state one chunk late (the state entering the previous chunk)."""
    import torch
    from repro_torch.kernels.ref import rwkv6_chunk_step

    b, h, s, dh = r.shape
    rf, kf, vf, lwf = (t.float() for t in (r, k, v, logw))
    late = S = torch.zeros((b, h, dh, dh), device=r.device)
    outs = []
    for i in range(0, s, chunk):
        sl = (slice(None), slice(None), slice(i, i + chunk))
        parts = (rf[sl], kf[sl], vf[sl], lwf[sl], u.float())
        outs.append(rwkv6_chunk_step(late, *parts)[0])
        late, S = S, rwkv6_chunk_step(S, *parts)[1]
    return torch.cat(outs, 2).to(r.dtype), S


def rwkv6_phase(card, dev):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import limit_ratio, rwkv6_plain, rwkv6_ref
    from repro_torch.kernels.rwkv6_cases import (RWKV6_GRID, RWKV6_REF_TOL,
                                                 RWKV6_TOL, rwkv6_inputs)

    gen = torch.Generator(dev).manual_seed(4)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    ratios = {"plain": 0.0, "state": 0.0, "ref": 0.0}
    margins = {}
    b, h, s, dh = RWKV6_SLICE
    cases = [(dt, c) for dt in ("float32", "bfloat16") for c in RWKV6_GRID]
    cases.append(("float32", (b, h, s, dh, 64)))
    n_cases = 0
    for name, (b, h, s, dh, chunk) in cases:
        dtype = getattr(torch, name)
        a = rwkv6_inputs(b, h, s, dh, gen, dtype=dtype)
        out, sfin = ops.rwkv6_chunked_bhsd(*a, chunk=chunk)
        torch.cuda.synchronize()
        po, ps = rwkv6_plain(*a, chunk=chunk)
        ro, rs = rwkv6_ref(*a)
        r_out = limit_ratio(out, po, *RWKV6_TOL[name])
        r_st = limit_ratio(sfin, ps, *RWKV6_TOL["float32"])
        tol = RWKV6_REF_TOL[name]
        r_ref = max(limit_ratio(out, ro, tol["rtol"], atol=tol["atol"]),
                    limit_ratio(sfin, rs, tol["rtol"], atol=tol["atol"]))
        check(out.dtype == dtype and sfin.dtype == torch.float32
              and r_out <= 1 and r_st <= 1 and r_ref <= 1,
              f"rwkv6_chunked_bhsd beyond its limits: {name} "
              f"{(b, h, s, dh, chunk)}: vs plain {r_out:.3f} (state "
              f"{r_st:.3f}) of {RWKV6_TOL[name]}, vs rwkv6_ref {r_ref:.3f} "
              f"of {tol}")
        worst[name] = max(worst[name], max_abs(out, po))
        for key, r in (("plain", r_out), ("state", r_st), ("ref", r_ref)):
            ratios[key] = max(ratios[key], r)
        n_cases += 1
        if s > 1024:
            continue
        # each limit rejects a wrong answer: the bonus term dropped, and
        # the state read one chunk late
        for wrong, fn in (("no u-bonus", lambda: rwkv6_plain(
                              *a[:4], torch.zeros_like(a[4]), chunk=chunk)),
                          ("state one chunk late", lambda: rwkv6_state_late(
                              *a, chunk=chunk))):
            wo, _ = fn()
            m = limit_ratio(wo, po, *RWKV6_TOL[name])
            key = f"{wrong}, {name}"
            margins[key] = min(margins.get(key, math.inf), m)
    for key, m in margins.items():
        check(m >= WRONG_MARGIN, f"a wrong RWKV6 ({key}) exceeds the limit "
              f"only {m:.2f}x (needs {WRONG_MARGIN}x)")

    # ragged S through the model-layout wrapper, and chunk 16 vs 64
    fp32_ref = RWKV6_REF_TOL["float32"]
    for s, chunk, dh in itertools.product((32, 96, 160), (16, 32), (16, 32)):
        r, k, v, logw, u = rwkv6_inputs(1, 2, s, dh, gen)
        bs = [t.transpose(1, 2) for t in (r, k, v, logw)]  # (B,S,H,dh)
        out, sfin = ops.rwkv6_chunked(*bs, u, chunk=chunk)
        po, ps = rwkv6_plain(*(ops.bhsd_padded(t, chunk) for t in bs), u,
                             chunk=chunk)
        ro, rs = rwkv6_ref(r, k, v, logw, u)
        check(out.shape == bs[0].shape
              and limit_ratio(out, po.transpose(1, 2)[:, :s],
                              *RWKV6_TOL["float32"]) <= 1
              and limit_ratio(sfin, ps, *RWKV6_TOL["float32"]) <= 1
              and torch.allclose(out, ro.transpose(1, 2), **fp32_ref)
              and torch.allclose(sfin, rs, **fp32_ref),
              f"rwkv6_chunked (padded) beyond its limits at S={s}, chunk "
              f"{chunk}, dh {dh}")
        n_cases += 1
    a = rwkv6_inputs(1, 2, 128, 32, gen)
    (o16, s16), (o64, s64) = (ops.rwkv6_chunked_bhsd(*a, chunk=c)
                              for c in (16, 64))
    check(torch.allclose(o16, o64, **fp32_ref)
          and torch.allclose(s16, s64, **fp32_ref),
          "rwkv6 chunk 16 and chunk 64 disagree")
    print(f"rwkv6 phase: rwkv6_chunked_bhsd within its limits on {n_cases} "
          f"cases (test_kernels grid x fp32/bf16, the slice's "
          f"{RWKV6_SLICE} chunk 64, ragged S 32-160 through rwkv6_chunked) "
          f"and chunk 16 == chunk 64: worst ratio to the limit vs "
          f"rwkv6_plain {ratios['plain']:.4f} (state {ratios['state']:.4f}; "
          f"limits {RWKV6_TOL}), vs rwkv6_ref {ratios['ref']:.4f} (limits "
          f"{RWKV6_REF_TOL}); max|diff| vs plain fp32 "
          f"{worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e} {card}",
          flush=True)
    print("  wrong answers over the limits (worst case, must be >= "
          f"{WRONG_MARGIN}x): " + ", ".join(f"{k} {m:.1f}x"
                                           for k, m in margins.items()),
          flush=True)

    # the model path's in-place read (rwkv6_chunked_fp32), at the slice's
    # shape and a ragged S, bf16 and fp32 inputs: within RWKV6_TOL["float32"]
    # of rwkv6_plain on the upcast, padded copies (padding stripped), and
    # bitwise equal to the route it replaces, the kernel on those copies
    b, h, s, dh = RWKV6_SLICE
    inplace_err, inplace_ratio = 0.0, 0.0
    for name, seq in itertools.product(("bfloat16", "float32"), (s, s - 1)):
        a = rwkv6_bshd(b, seq, h, dh, getattr(torch, name), gen)
        out, sfin = ops.rwkv6_chunked_fp32(*a, chunk=64)
        torch.cuda.synchronize()
        po, ps = rwkv6_plain(*(ops.bhsd_padded(t.float(), 64) for t in a[:4]),
                             a[4], chunk=64)
        po = po.transpose(1, 2)[:, :seq]
        r_out = limit_ratio(out, po, *RWKV6_TOL["float32"])
        r_st = limit_ratio(sfin, ps, *RWKV6_TOL["float32"])
        err = max(max_abs(out, po), max_abs(sfin, ps))
        check(out.dtype == torch.float32 and r_out <= 1 and r_st <= 1,
              f"rwkv6_chunked_fp32 beyond its limit against rwkv6_plain at "
              f"{name} {(b, seq, h, dh)}: ratio out {r_out:.3f}, state "
              f"{r_st:.3f} of {RWKV6_TOL['float32']}, max|diff| {err:.3e}")
        inplace_err = max(inplace_err, err)
        inplace_ratio = max(inplace_ratio, r_out, r_st)
        del po, ps
        ro, rs = ops.rwkv6_chunked(*(t.float() for t in a[:4]), a[4],
                                   chunk=64)
        check(out.is_contiguous()
              and torch.equal(bits(out), bits(ro))
              and torch.equal(bits(sfin), bits(rs)),
              f"rwkv6_chunked_fp32 differs from the padded fp32 route at "
              f"{name} {(b, seq, h, dh)}: max|diff| out {max_abs(out, ro)}, "
              f"state {max_abs(sfin, rs)}")
        n_cases += 1
        del a, out, sfin, ro, rs
    print(f"  rwkv6_chunked_fp32 (model layout read in place), bf16 and fp32 "
          f"inputs, (B, S, H, dh) = {(b, s, h, dh)} and S = {s - 1}: vs "
          f"rwkv6_plain on the upcast, padded copies worst ratio to the limit "
          f"{inplace_ratio:.4f} (limit {RWKV6_TOL['float32']}), max|diff| "
          f"{inplace_err:.3e}; == the padded fp32 route (rwkv6_chunked on "
          f".float() copies), out and state bitwise {card}", flush=True)

    # times at the slice's shape, fp32 on (B,H,S,dh) (the JAX-parity entry),
    # chunk 64:
    # device time (profiler kernel records) and call time (CUDA events)
    b, h, s, dh = RWKV6_SLICE
    c = 64
    a = rwkv6_inputs(b, h, s, dh, gen)
    chunks = b * h * (s // c)
    # per chunk: q_in.S and the state update k_out^T.v (C x dh x dh MACs
    # each); the scores and their product with v over the strictly lower
    # triangle's C(C-1)/2 pairs only (dh MACs a pair each); the u-bonus
    # diagonal (a length-dh dot and a scaled v row per position)
    flops = chunks * (4 * c * dh * dh + 2 * c * (c - 1) * dh + 4 * c * dh)
    nbytes = 5 * a[0].numel() * 4 + b * h * dh * dh * 4 + a[4].numel() * 4
    ops_ms, bytes_ms = flops / FP32_FLOP_PER_S * 1e3, \
        nbytes / HBM_BYTES_PER_S * 1e3
    kern = lambda: ops.rwkv6_chunked_bhsd(*a, chunk=c)  # noqa: E731
    plain = lambda: rwkv6_plain(*a, chunk=c)  # noqa: E731
    row = dict(shape=[b, h, s, dh], chunk=c, dtype="float32", flops=flops,
               bytes=nbytes, bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               ops_ms_fp32=ops_ms, bytes_ms=bytes_ms,
               ops_ms_bf16_tensor_cores=flops / BF16_FLOP_PER_S * 1e3,
               call_ms=time_ms(kern, 20, 3),
               plain_call_ms=time_ms(plain, 5, 1))
    row["ms"] = device_ms(kern, iters=10)
    row["plain_ms"] = device_ms(plain, iters=3)
    print(f"  rwkv6 float32 {RWKV6_SLICE} chunk {c}: kernel {row['ms']:.4f} "
          f"ms (call {row['call_ms']:.4f})  plain {row['plain_ms']:.4f} ms "
          f"(call {row['plain_call_ms']:.4f})  bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {flops:.4e} FLOP at "
          f"{FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s = {ops_ms:.4f} ms; "
          f"{nbytes} B at 3.35 TB/s = {bytes_ms:.4f} ms; at the bf16 tensor "
          f"cores' rate {row['ops_ms_bf16_tensor_cores']:.4f} ms)  library: "
          f"none {card}", flush=True)
    del a

    # the in-place path as the model calls it: bf16 r/k/v, fp32 logw, u and
    # out, (B,S,H,dh); its plain version is rwkv6_plain on the upcast,
    # padded copies, and the route it replaced (upcast, pad, kernel, the
    # output copied into (B,S,H*dh)) is timed beside it
    a = rwkv6_bshd(b, s, h, dh, torch.bfloat16, gen)
    ibytes = a[0].numel() * (3 * 2 + 4 + 4) + b * h * dh * dh * 4 \
        + a[4].numel() * 4
    ibytes_ms = ibytes / HBM_BYTES_PER_S * 1e3
    kern = lambda: ops.rwkv6_chunked_fp32(*a, chunk=c)  # noqa: E731
    plain = lambda: rwkv6_plain(*(ops.bhsd_padded(t.float(), c)  # noqa: E731
                                  for t in a[:4]), a[4], chunk=c)
    route = lambda: ops.rwkv6_chunked(  # noqa: E731
        *(t.float() for t in a[:4]), a[4], chunk=c)[0].reshape(b, s, h * dh)
    inplace = dict(shape=[b, s, h, dh], chunk=c, dtype="bfloat16 r/k/v, "
                   "float32 logw/u/out", flops=flops, bytes=ibytes,
                   bound_ms=max(ops_ms, ibytes_ms),
                   bound_by="operations" if ops_ms >= ibytes_ms else "bytes",
                   ops_ms_fp32=ops_ms, bytes_ms=ibytes_ms,
                   call_ms=time_ms(kern, 20, 3),
                   route_call_ms=time_ms(route, 20, 3),
                   plain_call_ms=time_ms(plain, 5, 1),
                   max_abs_err=inplace_err, limit_ratio=inplace_ratio)
    inplace["ms"] = device_ms(kern, iters=10)
    inplace["route_ms"] = device_ms(route, iters=10)
    inplace["plain_ms"] = device_ms(plain, iters=3)
    print(f"  rwkv6_chunked_fp32 {(b, s, h, dh)} chunk {c}, bf16 r/k/v: "
          f"kernel {inplace['ms']:.4f} ms (call {inplace['call_ms']:.4f})  "
          f"the upcast/pad route it replaced {inplace['route_ms']:.4f} ms "
          f"(call {inplace['route_call_ms']:.4f})  plain "
          f"{inplace['plain_ms']:.4f} ms  bound {inplace['bound_ms']:.4f} ms "
          f"({inplace['bound_by']}: {ops_ms:.4f} ms; {ibytes} B at 3.35 "
          f"TB/s = {ibytes_ms:.4f} ms)  library: none {card}", flush=True)
    del a
    torch.cuda.empty_cache()
    return dict(worst=worst, ratios=ratios, margins=margins, row=row,
                inplace=inplace, cases=n_cases)


def rwkv6_bshd(b, s, h, dh, dtype, gen):
    """The model path's operands: r/k/v (B,S,H,dh) in ``dtype``, logw and u
    fp32, drawn as ``rwkv6_inputs`` draws them."""
    from repro_torch.kernels.rwkv6_cases import rwkv6_inputs
    r, k, v, logw, u = rwkv6_inputs(b, h, s, dh, gen, layout="bshd")
    return [t.to(dtype) for t in (r, k, v)] + [logw, u]


def rwkv_agreement_phase(card, dev):
    import dataclasses
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.rwkv6_cases import RWKV6_REF_TOL
    from repro_torch.models import lm
    from repro_torch.nn import ssm

    cfg = get_arch(RWKV["arch"])
    rs = np.random.RandomState(7)
    # (a) layer level, full width: chunked (the kernel) against the scan
    # (plain torch), the JAX package's own contract, at the limit of the
    # CPU test that holds it (tests/test_torch_ssm.py)
    tol = RWKV6_REF_TOL["float32"]
    p = ssm.init_rwkv6(torch.Generator(dev).manual_seed(2), cfg.d_model,
                       cfg.n_heads, torch.float32, device=dev)
    x = torch.from_numpy(rs.randn(2, 512, cfg.d_model).astype(np.float32)
                         ).to(dev)
    with torch.no_grad():
        yc, sc = ssm.rwkv6_mix_chunked(p, x, cfg.n_heads)
        ys, ss = ssm.rwkv6_mix_scan(p, x, cfg.n_heads)
    ok = torch.allclose(yc, ys, **tol) and torch.allclose(sc, ss, **tol)
    check(ok, f"rwkv6_mix_chunked vs rwkv6_mix_scan at full width beyond "
          f"{tol}: y {max_abs(yc, ys)}, state {max_abs(sc, ss)}")
    print(f"agreement: rwkv6_mix_chunked (kernel) vs rwkv6_mix_scan, fp32, "
          f"d {cfg.d_model}, {cfg.n_heads} heads, batch 2 x 512: max|diff| "
          f"y {max_abs(yc, ys):.3e} (max|y| {float(ys.abs().max()):.3e}), "
          f"state {max_abs(sc, ss):.3e} (tolerance {tol}) {card}",
          flush=True)
    del p, x, yc, sc, ys, ss

    # (b) model level: the card against the port on the CPU, fp32, TF32
    # off, full width, 2 layers, prompt 300 (ragged: the padding runs)
    f32 = dataclasses.replace(cfg, n_layers=2, layer_kinds=cfg.kinds[:2],
                              param_dtype="float32", compute_dtype="float32")
    p32 = lm.init_params(f32, torch.Generator(dev).manual_seed(1),
                         device=dev)
    p_cpu = pytree.tree_map(lambda t: t.cpu(), p32)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 300)))
    teacher = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 8)))
    with torch.no_grad():
        st_g, lg_g = lm.prefill(f32, p32, {"tokens": toks.to(dev)}, 308)
        st_c, lg_c = lm.prefill(f32, p_cpu, {"tokens": toks}, 308)
        errs = {"prefill logits": rel_err(lg_g.cpu(), lg_c)}
        for (path, a), b in zip(pytree.tree_flatten_with_path(st_g)[0],
                                pytree.tree_leaves(st_c)):
            errs[pytree.keystr(path)] = rel_err(a.cpu(), b)
        for i in range(8):
            tok = teacher[:, i:i + 1]
            lg_g, st_g = lm.decode_step(f32, p32, st_g, tok.to(dev), 300 + i)
            lg_c, st_c = lm.decode_step(f32, p_cpu, st_c, tok, 300 + i)
            errs[f"decode {i}"] = rel_err(lg_g.cpu(), lg_c)
    worst = max(errs.values())
    check(worst <= LM_CPU_REL_TOL,
          f"RWKV6 card vs CPU beyond {LM_CPU_REL_TOL}: {errs}")
    print(f"agreement: {cfg.name} card vs the port on the CPU, fp32 (TF32 "
          f"off), full width, 2 layers, batch 2 x 300: prefill logits, every "
          f"layer's S / tm_prev / cm_prev and 8 teacher-forced decode steps, "
          f"worst max|diff|/max|ref| {worst:.3e} (tolerance "
          f"{LM_CPU_REL_TOL}) {card}", flush=True)


# ---------------------------------------------------------------------------
# phase 12: the adaptive CNF request at POWER width
# ---------------------------------------------------------------------------

# the JAX package's adaptive ODEEngine settings (rtol = atol = 1e-6, 512
# steps, t in [0, 1]); the engine serves one point a solve
ADAPTIVE = dict(t0=0.0, t1=1.0, rtol=1e-6, atol=1e-6, max_steps=512)
ADAPTIVE_STREAM = 16       # one-point requests served by the captured solver
ADAPTIVE_CPU_POINTS = 1    # of them, held against the port on the CPU
ADAPTIVE_REPLAYS = 3       # captured batched requests timed (median)
ADAPTIVE_TERMS = 5         # dopri5's widest stage update and its combine
# the leaves fused_lincomb takes on phase 12: a point (6,) and its
# log-density (), and the batched state (10000, 6) and (10000,)
ADAPTIVE_SHAPES = [(6,), (), (10000, 6), (10000,)]


def adaptive_request(cnf, theta, x):
    """(density, score, AdaptiveInfo): a forward-only log-density and the
    score d log p / dx through the reverse sweep, as the JAX engine's two
    adaptive request kinds."""
    import torch
    with torch.no_grad():
        density, info = cnf.log_prob(x, theta)
    xg = x.detach().clone().requires_grad_(True)
    lp, info_g = cnf.log_prob(xg, theta)
    (score,) = torch.autograd.grad(lp.sum(), xg)
    check(info == info_g, f"density and score took other steps: {info} vs "
          f"{info_g}")
    return density, score, info


def timed_request(cnf, theta, x):
    """``adaptive_request`` and its wall ms, the card synchronized."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = adaptive_request(cnf, theta, x)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def same_request(a, b):
    """Same steps and the same bits of density and score."""
    import torch
    return a[2] == b[2] and all(torch.equal(bits(u), bits(v))
                                for u, v in zip(a[:2], b[:2]))


def lincomb_scaled_rows(card, dev):
    """``fused_lincomb``'s scaled form (h a 0-d fp32 tensor on the card)
    at the adaptive path's leaves, timed beside its bytes bound and its
    plain version."""
    import torch
    from repro_torch.kernels.ops import fused_lincomb
    from repro_torch.kernels.ref import lincomb_plain

    gen = torch.Generator().manual_seed(12)
    rows = []
    for shape in ADAPTIVE_SHAPES:
        base, terms = operands(shape, torch.float32, ADAPTIVE_TERMS, gen, dev)
        h = torch.tensor(0.0123, dtype=torch.float32).to(dev)
        ws = WEIGHTS[:ADAPTIVE_TERMS]
        out = fused_lincomb(base, terms, ws, h)
        check(torch.equal(bits(out), bits(lincomb_plain(base, terms, ws, h))),
              f"scaled fused_lincomb != lincomb_plain at {shape}")
        fused = lambda: fused_lincomb(base, terms, ws, h)  # noqa: E731
        plain = lambda: lincomb_plain(base, terms, ws, h)  # noqa: E731
        nbytes = (ADAPTIVE_TERMS + 2) * base.numel() * base.element_size()
        row = dict(shape=list(shape), n_terms=ADAPTIVE_TERMS, form="scaled",
                   dtype="float32", bytes=nbytes,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   call_ms=time_ms(fused), plain_call_ms=time_ms(plain))
        row["ms"], row["plain_ms"] = device_ms(fused), device_ms(plain)
        rows.append(row)
        print(f"  lincomb scaled {str(shape):12s} terms={ADAPTIVE_TERMS} "
              f"kernel {row['ms']:.6f} ms (call {row['call_ms']:.6f})  plain "
              f"{row['plain_ms']:.6f} ms (call {row['plain_call_ms']:.6f})  "
              f"bound {row['bound_ms']:.6f} ms (bytes) {card}", flush=True)
    return rows


def adaptive_point_phase(card, dev, theta, x):
    """The JAX ``ODEEngine``'s adaptive request: one point (6,) a solve,
    each with its own steps, phase 3's weights.  An eager fused request on
    the first point (counted: its ``fused_lincomb`` launches must equal
    ``expected_adaptive_lincomb_calls``); then one captured solver (the
    engine's one compiled single-lane program) serves a stream of
    ``ADAPTIVE_STREAM`` points, its first call and its replay of the first
    point bitwise equal to eager; ``ADAPTIVE_CPU_POINTS`` of the stream
    against the port on the CPU; the per-request and aggregate times and
    one traced captured request."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.core.adaptive import expected_adaptive_lincomb_calls
    from repro_torch.core.cnf import AdaptiveCNF
    from repro_torch.kernels import ops
    from repro_torch.models.ode_nets import cnf_vf

    dim = CNF["dim"]
    points = x[:ADAPTIVE_STREAM]
    torch.use_deterministic_algorithms(True)

    # -- the main path, counted ------------------------------------------------
    eager_cnf = AdaptiveCNF(cnf_vf, dim, fused_stages=True, **ADAPTIVE)
    ops.reset_counts()
    eager, eager_ms = timed_request(eager_cnf, theta, points[0])
    launches, plain = ops.launches, ops.plain_calls
    info = eager[2]
    expected = expected_adaptive_lincomb_calls(
        info.n_accepted, info.n_rejected, 2, backward=False) \
        + expected_adaptive_lincomb_calls(info.n_accepted, info.n_rejected, 2)
    print(f"adaptive CNF request (the engine's: one point a solve), point 0: "
          f"n_accepted {info.n_accepted}, n_rejected {info.n_rejected}; "
          f"fused_lincomb launches {launches} (expected {expected}), plain "
          f"calls {plain}; eager density + score {eager_ms:.1f} ms; ring "
          f"{eager_cnf.solver.ring_bytes} B {card}", flush=True)
    check(plain == 0, f"{plain} plain lincomb calls on the adaptive request")
    check(launches > 0 and launches == expected,
          f"adaptive request launches {launches} != expected {expected}")
    check(eager[0].shape == () and eager[1].shape == (dim,),
          "adaptive request output shapes")
    check(bool(torch.isfinite(eager[0]) and torch.isfinite(eager[1]).all()),
          "adaptive request density/score not finite")

    # -- captured: one solver for the stream ---------------------------------
    cap = AdaptiveCNF(cnf_vf, dim, fused_stages=True, capture=True,
                      **ADAPTIVE)
    first, first_ms = timed_request(cap, theta, points[0])
    check(same_request(first, eager),
          "adaptive request: captured first call differs from eager")
    stream, stream_ms = [], []
    t0 = time.perf_counter()
    for p in points:
        out, ms = timed_request(cap, theta, p)
        stream.append(out)
        stream_ms.append(ms)
    total_ms = (time.perf_counter() - t0) * 1e3
    check(same_request(stream[0], eager),
          "adaptive request: captured replay differs from eager")
    check(all(bool(torch.isfinite(d) and torch.isfinite(s).all())
              for d, s, _ in stream), "adaptive stream not finite")
    stats = cap.solver.graph_stats()
    check(set(stats) == {"attempt", "attempt_record", "adjoint"}
          and all(v[2] is not None for v in stats.values()),
          f"adaptive request graphs not all captured: {stats}")
    steps = [(i.n_accepted, i.n_rejected) for _, _, i in stream]
    ms = float(np.median(stream_ms))
    print(f"adaptive CNF request captured == eager bitwise (point 0, first "
          f"call and replay); first call {first_ms:.1f} ms ("
          + ", ".join(f"{k}: warm-up {w:.1f} ms, capture {c:.1f} ms, pool "
                      f"{b} B" for k, (w, c, b) in stats.items())
          + f"); {ADAPTIVE_STREAM} points served by one captured solver in "
          f"{total_ms:.1f} ms ({ADAPTIVE_STREAM / total_ms * 1e3:.3f} points "
          f"a second, each a density and a score request), per point median "
          f"{ms:.1f} ms, min {min(stream_ms):.1f}, max {max(stream_ms):.1f}; "
          f"(accepted, rejected) steps {steps} {card}", flush=True)
    print(f"eager vs captured adaptive CNF request (point 0): {eager_ms:.1f} "
          f"vs {stream_ms[0]:.1f} ms ({eager_ms / stream_ms[0]:.2f}x) "
          f"{card}", flush=True)
    trace = traced("adaptive CNF request (one point), captured",
                   lambda: adaptive_request(cap, theta, points[0]),
                   "lincomb_kernel", card, replayed=True)
    untraced_idle(trace, stream_ms[0], "adaptive CNF request", card)

    # -- the card against the port on the CPU ----------------------------------
    cpu_theta = pytree.tree_map(lambda t: t.cpu(), theta)
    cpu_cnf = AdaptiveCNF(cnf_vf, dim, fused_stages=True, **ADAPTIVE)
    errs = []
    for i in range(1, 1 + ADAPTIVE_CPU_POINTS):
        d_c, s_c, i_c = adaptive_request(cpu_cnf, cpu_theta, points[i].cpu())
        d_g, s_g, i_g = stream[i]
        errs.append((max_abs(d_g.cpu(), d_c), max_abs(s_g.cpu(), s_c)))
        check(i_g == i_c, f"adaptive request point {i}: card steps {i_g} != "
              f"CPU {i_c}")
        check(torch.allclose(d_g.cpu(), d_c, **CNF_TOL)
              and torch.allclose(s_g.cpu(), s_c, **CNF_TOL),
              f"adaptive request point {i}: card vs CPU beyond {CNF_TOL}: "
              f"{errs[-1]}")
    print(f"adaptive CNF request, card (captured) vs the port on the CPU on "
          f"{ADAPTIVE_CPU_POINTS} point(s) of the stream after point 0: same "
          f"steps, max|diff| density "
          f"{max(e[0] for e in errs):.3e}, score {max(e[1] for e in errs):.3e} "
          f"(tolerance {CNF_TOL}, fp32, TF32 off)", flush=True)
    torch.use_deterministic_algorithms(False)
    res = dict(n_accepted=info.n_accepted, n_rejected=info.n_rejected,
               launches=launches, expected=expected,
               ring_bytes=eager_cnf.solver.ring_bytes, eager_ms=eager_ms,
               first_ms=first_ms, ms=ms, stream_ms=stream_ms,
               stream_total_ms=total_ms,
               points_per_s=ADAPTIVE_STREAM / total_ms * 1e3, steps=steps,
               graphs={k: dict(warmup_ms=w, capture_ms=c, pool_bytes=b)
                       for k, (w, c, b) in stats.items()},
               trace=trace,
               cpu_max_abs=dict(density=max(e[0] for e in errs),
                                score=max(e[1] for e in errs)))
    del eager_cnf, cap
    gc_collect()
    return res


def adaptive_batched_phase(card, dev, theta, x):
    """The 10,000 points of phase 3 solved as ONE state through
    ``AdaptiveCNF``: one step sequence and one error norm for the batch, a
    configuration the JAX engine does not serve (it solves each point
    alone), kept for the ring's size and the batched state's times.  Eager
    fused (counted: its ``fused_lincomb`` launches must equal
    ``expected_adaptive_lincomb_calls``), eager unfused, and captured
    (``capture=True``: one CUDA graph of an attempt with and one without
    the ring write, one of an adjoint step), all four with the same steps
    and the density and score bitwise equal.  Then the card against the
    port on the CPU on 256 points, the ring's bytes against the peak and
    the times (the trace is the one-point request's)."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.core.adaptive import (CHECK_EVERY,
                                           expected_adaptive_lincomb_calls)
    from repro_torch.core.cnf import AdaptiveCNF
    from repro_torch.kernels import ops
    from repro_torch.models.ode_nets import cnf_vf

    dim = CNF["dim"]
    # the ring: max_steps slots of the state and its 7 stages, fp32
    state_bytes = x.numel() * 4 + x.shape[0] * 4
    ring_pred = ADAPTIVE["max_steps"] * (1 + 7) * state_bytes
    torch.use_deterministic_algorithms(True)
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()

    # -- the main path, counted ------------------------------------------------
    fused = AdaptiveCNF(cnf_vf, dim, fused_stages=True, **ADAPTIVE)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_f, s_f, info = adaptive_request(fused, theta, x)
    torch.cuda.synchronize()
    first_eager_ms = (time.perf_counter() - t0) * 1e3
    launches, plain = ops.launches, ops.plain_calls
    peak = torch.cuda.max_memory_allocated() - before
    expected = expected_adaptive_lincomb_calls(
        info.n_accepted, info.n_rejected, 2, backward=False) \
        + expected_adaptive_lincomb_calls(info.n_accepted, info.n_rejected, 2)
    print(f"adaptive CNF batched state (not the engine's request): batch "
          f"{x.shape[0]}, dopri5 rtol = atol "
          f"= {ADAPTIVE['rtol']}, t in [{ADAPTIVE['t0']}, {ADAPTIVE['t1']}], "
          f"fused: n_accepted {info.n_accepted}, n_rejected "
          f"{info.n_rejected}; fused_lincomb launches {launches} (expected "
          f"{expected}), plain calls {plain}", flush=True)
    check(plain == 0, f"{plain} plain lincomb calls on the adaptive path")
    check(launches > 0 and launches == expected,
          f"adaptive launches {launches} != expected {expected}")
    check(d_f.shape == (x.shape[0],) and s_f.shape == x.shape,
          "adaptive CNF output shapes")
    check(bool(torch.isfinite(d_f).all() and torch.isfinite(s_f).all()),
          "adaptive CNF density/score not finite")
    ring = fused.solver.ring_bytes
    # phase 16 holds the spill ring's request against these bits
    KEPT["adaptive_batched"] = (d_f, s_f, info, ring)
    print(f"adaptive ring: {ring} B on the card (predicted max_steps x (1 + 7 "
          f"stages) x {state_bytes} B = {ring_pred} B, + h and t); peak "
          f"allocated above the phase's start {peak} B = "
          f"{peak / ring_pred:.4f} of the prediction {card}", flush=True)
    check(ring_pred <= ring <= ring_pred + 2 * 8 * ADAPTIVE["max_steps"],
          f"ring bytes {ring} against the predicted {ring_pred}")
    check(ring <= peak, f"peak {peak} B below the ring's {ring} B")

    unfused = AdaptiveCNF(cnf_vf, dim, **ADAPTIVE)
    d_u, s_u, info_u = adaptive_request(unfused, theta, x)
    del unfused
    check(info_u == info, f"unfused steps {info_u} != fused {info}")
    check(torch.equal(bits(d_u), bits(d_f)) and torch.equal(bits(s_u),
                                                           bits(s_f)),
          "adaptive CNF fused and unfused differ on the card: max|diff| "
          f"{max_abs(d_u, d_f)}, {max_abs(s_u, s_f)}")
    print("adaptive CNF fused == unfused bitwise on the card (density and "
          "score), same steps", flush=True)

    # -- captured ----------------------------------------------------------------
    cap = AdaptiveCNF(cnf_vf, dim, fused_stages=True, capture=True,
                      **ADAPTIVE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_c, s_c, info_c = adaptive_request(cap, theta, x)
    torch.cuda.synchronize()
    cap_first_ms = (time.perf_counter() - t0) * 1e3
    replay_ms = []
    for _ in range(ADAPTIVE_REPLAYS):
        t0 = time.perf_counter()
        d_r, s_r, info_r = adaptive_request(cap, theta, x)
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - t0) * 1e3)
        check(info_r == info and torch.equal(bits(d_r), bits(d_f))
              and torch.equal(bits(s_r), bits(s_f)),
              "adaptive captured replay differs from eager: max|diff| "
              f"{max_abs(d_r, d_f)}, {max_abs(s_r, s_f)}")
    check(info_c == info and torch.equal(bits(d_c), bits(d_f))
          and torch.equal(bits(s_c), bits(s_f)),
          "adaptive captured first call differs from eager")
    stats = cap.solver.graph_stats()
    check(set(stats) == {"attempt", "attempt_record", "adjoint"}
          and all(v[2] is not None for v in stats.values()),
          f"adaptive graphs not all captured: {stats}")
    replays = cap.solver.replays
    ms = float(np.median(replay_ms))
    print(f"adaptive CNF captured == eager bitwise (density and score, first "
          f"call and {ADAPTIVE_REPLAYS} replayed requests), same steps; "
          f"first call {cap_first_ms:.1f} ms ("
          + ", ".join(f"{k}: warm-up {w:.1f} ms, capture {c:.1f} ms, pool "
                      f"{b} B" for k, (w, c, b) in stats.items())
          + f"); request {ms:.1f} ms (median of {ADAPTIVE_REPLAYS}: "
          + ", ".join(f"{v:.1f}" for v in replay_ms)
          + f"), live read every {CHECK_EVERY} attempts, {replays} attempt "
          f"replays for the score's {info.n_accepted + info.n_rejected} "
          f"attempts {card}", flush=True)
    print(f"eager (first call) vs captured adaptive CNF batched state: "
          f"{first_eager_ms:.1f} vs {ms:.1f} ms ({first_eager_ms / ms:.2f}x) "
          f"{card}", flush=True)

    # -- the card against the port on the CPU, 256 points ----------------------
    xs = x[:256]
    d_g, s_g, i_g = adaptive_request(
        AdaptiveCNF(cnf_vf, dim, fused_stages=True, **ADAPTIVE), theta, xs)
    cpu_theta = pytree.tree_map(lambda t: t.cpu(), theta)
    d_c, s_c, i_c = adaptive_request(
        AdaptiveCNF(cnf_vf, dim, fused_stages=True, **ADAPTIVE), cpu_theta,
        xs.cpu())
    d_err, s_err = max_abs(d_g.cpu(), d_c), max_abs(s_g.cpu(), s_c)
    check(i_g == i_c, f"adaptive card vs CPU steps {i_g} != {i_c}")
    check(torch.allclose(d_g.cpu(), d_c, **CNF_TOL)
          and torch.allclose(s_g.cpu(), s_c, **CNF_TOL),
          f"adaptive card vs CPU beyond {CNF_TOL}: density {d_err}, score "
          f"{s_err}")
    print(f"adaptive CNF batched state, card vs CPU port on 256 points: "
          f"same steps "
          f"({i_g.n_accepted} accepted, {i_g.n_rejected} rejected), "
          f"max|diff| density {d_err:.3e}, score {s_err:.3e} (tolerance "
          f"{CNF_TOL}, fp32, TF32 off)", flush=True)
    torch.use_deterministic_algorithms(False)
    res = dict(n_accepted=info.n_accepted, n_rejected=info.n_rejected,
               launches=launches, expected=expected, ring_bytes=ring,
               ring_bytes_predicted=ring_pred, peak_bytes=peak,
               eager_ms=first_eager_ms,
               first_ms=cap_first_ms, ms=ms, replay_ms=replay_ms,
               check_every=CHECK_EVERY, replays=replays,
               graphs={k: dict(warmup_ms=w, capture_ms=c, pool_bytes=b)
                       for k, (w, c, b) in stats.items()},
               cpu_max_abs=dict(density=d_err, score=s_err))
    del fused, cap
    gc_collect()
    return res


# ---------------------------------------------------------------------------
# phase 13: the stiff Robertson example (paper §5.3), fp64
# ---------------------------------------------------------------------------

ROBERTSON_EPOCHS = 3
ROB_LOSS_RTOL = 1e-8     # card vs CPU, fp64 states (summation order)
ROB_GRAD_TOL = 1e-5      # max|card - cpu| / max|cpu| per fp32 weight leaf


def solver_counts(solvers):
    """Units replayed, ``live`` reads and stats reads summed over the
    ``ImplicitSolver``s of a loss (over their lives), and the captured
    units' first-call costs."""
    graphs = [g for s in solvers for g in s.graph_stats().values()]
    return dict(replays=sum(s.replays for s in solvers),
                live_reads=sum(s.live_reads for s in solvers),
                stats_reads=sum(s.stats_reads for s in solvers),
                graphs=len(graphs),
                warmup_ms=sum(g[0] or 0.0 for g in graphs),
                capture_ms=sum(g[1] or 0.0 for g in graphs),
                pool_bytes=sum(g[2] or 0 for g in graphs))


def robertson_phase(card, dev):
    """The port's example entry (``repro_torch.examples.stiff_robertson.
    run``) on the card, eager (``capture=False``) and captured: the beuler
    truth, 3 CN epochs and 3 Dopri5 epochs of ``mlp_vf`` (hidden 32, 3
    hidden layers) from seed 0.  Every CN solve converged; captured ==
    eager bitwise (every epoch's loss, epoch 0's gradient); no host read
    inside a captured solve but the ``live`` flag every ``CHECK_EVERY``
    units and one stats read; the pnode, revolve and revolve2 CN gradients
    at the initial weights bitwise equal under capture; one traced
    captured epoch of each; epoch 0's loss and gradient against the
    port's CPU run of the same seed."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.core.adaptive import CHECK_EVERY
    from repro_torch.examples import stiff_robertson as trob

    runs = {}
    for capture in (False, True):
        mode = "captured" if capture else "eager"
        t0 = time.perf_counter()
        out = trob.run(ROBERTSON_EPOCHS, device=dev, capture=capture,
                       log=lambda *_: None)
        total_ms = (time.perf_counter() - t0) * 1e3
        stats = out["cn_stats"]
        check(len(stats) > 0 and not any(s.diverged for s in stats),
              f"a CN solve diverged on the card ({mode}): "
              f"{[s for s in stats if s.diverged][:3]}")
        for key in ("cn", "dopri5"):
            r = out[key]
            check(all(math.isfinite(v) for v in r["losses"] + r["gnorms"]),
                  f"Robertson {key} ({mode}): non-finite loss or gradient "
                  "norm")
            print(f"Robertson {key} {mode}: losses "
                  + ", ".join(f"{v:.10f}" for v in r["losses"]) + "; |g| "
                  + ", ".join(f"{v:.6e}" for v in r["gnorms"])
                  + "; epoch ms "
                  + ", ".join(f"{v:.1f}" for v in r["ms"]) + f" {card}",
                  flush=True)
        cn = solver_counts(out["losses"].cn_solvers)
        dopri_graphs = [g for s in out["losses"].dopri_solvers
                        for g in s.graph_stats().values()]
        solves = len(stats)
        newton = sum(s.newton_iters for s in stats)
        dopri_replays = sum(s.replays for s in out["losses"].dopri_solvers)
        print(f"Robertson {mode}: {solves} CN solves over "
              f"{ROBERTSON_EPOCHS} epochs, none diverged (max Newton "
              f"residual {max(s.max_residual for s in stats):.3e}, Newton "
              f"iterations {newton}); truth + training {total_ms:.1f} ms "
              f"{card}", flush=True)
        if capture:
            check(cn["live_reads"] * CHECK_EVERY == cn["replays"]
                  and cn["stats_reads"] == solves,
                  f"captured CN host reads: {cn}, {solves} solves")
            print(f"Robertson captured CN: {cn['replays']} unit replays, "
                  f"{cn['live_reads']} live reads (one every {CHECK_EVERY} "
                  f"replays) + {cn['stats_reads']} stats reads over "
                  f"{solves} solves (forward and reverse): "
                  f"{cn['replays'] / solves:.2f} replays and "
                  f"{(cn['live_reads'] + cn['stats_reads']) / solves:.2f} "
                  f"host reads a solve, no other; {cn['graphs']} graphs "
                  f"captured in epoch 0: warm-up {cn['warmup_ms']:.1f} ms, "
                  f"capture {cn['capture_ms']:.1f} ms, pools "
                  f"{cn['pool_bytes']} B; Dopri5: {len(dopri_graphs)} "
                  f"graphs: warm-up "
                  f"{sum(g[0] for g in dopri_graphs):.1f} ms, capture "
                  f"{sum(g[1] for g in dopri_graphs):.1f} ms, pools "
                  f"{sum(g[2] for g in dopri_graphs)} B; "
                  f"{dopri_replays} attempt replays in the last epoch's loss "
                  f"{card}", flush=True)
        runs[mode] = dict(out=out, total_ms=total_ms, counts=cn,
                          newton_iters=newton, solves=solves,
                          dopri_replays=dopri_replays)

    # captured == eager, bitwise
    eager, cap = runs["eager"]["out"], runs["captured"]["out"]
    check(np.array_equal(eager["truth"], cap["truth"]),
          "Robertson: the captured beuler truth != eager bitwise")
    for key in ("cn", "dopri5"):
        same = eager[key]["losses"] == cap[key]["losses"] and all(
            torch.equal(bits(a), bits(b)) for a, b in zip(
                pytree.tree_leaves(eager[key]["grads0"]),
                pytree.tree_leaves(cap[key]["grads0"])))
        check(same, f"Robertson {key}: captured != eager bitwise")
    check([s.newton_iters for s in eager["cn_stats"]]
          == [s.newton_iters for s in cap["cn_stats"]],
          "Robertson CN: captured Newton iterations != eager")
    print(f"Robertson captured == eager bitwise: the beuler truth, every "
          f"epoch's CN and Dopri5 loss, epoch 0's gradients, every solve's "
          f"Newton iterations; epoch ms CN eager "
          + ", ".join(f"{v:.1f}" for v in eager["cn"]["ms"]) + " vs captured "
          + ", ".join(f"{v:.1f}" for v in cap["cn"]["ms"]) + "; Dopri5 eager "
          + ", ".join(f"{v:.1f}" for v in eager["dopri5"]["ms"])
          + " vs captured "
          + ", ".join(f"{v:.1f}" for v in cap["dopri5"]["ms"]) + f" {card}",
          flush=True)

    # the three CN checkpoint policies at the initial weights, captured
    y0, target = trob.scaled_data(cap["truth"], dev)
    theta = trob.mlp_vf_init(torch.Generator().manual_seed(0), 3, hidden=32,
                             n_hidden=3, device=dev)
    for policy in ("revolve", "revolve2"):
        losses = trob.make_losses(y0, target, adjoint=policy, ncheck=1)
        loss, g = trob.value_and_grad(losses.cn, theta)
        anchor = pytree.tree_leaves(cap["cn"]["grads0"])
        check(float(loss) == cap["cn"]["losses"][0] and all(
            torch.equal(bits(a), bits(b))
            for a, b in zip(pytree.tree_leaves(g), anchor)),
              f"Robertson CN {policy} gradient != pnode bitwise under "
              "capture")
    print("Robertson CN gradients: pnode == revolve == revolve2 bitwise on "
          "the card, captured (ncheck 1 of 2 steps a solve)", flush=True)

    # one traced captured epoch's losses (value and gradient)
    traces = {}
    for key, loss_fn in (("cn", cap["losses"].cn),
                         ("dopri5", cap["losses"].dopri)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trob.value_and_grad(loss_fn, theta)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        traces[key] = traced(f"Robertson {key} loss + gradient, captured",
                             lambda: trob.value_and_grad(loss_fn, theta),
                             "lincomb", card, replayed=True)
        traces[key]["untraced_wall_ms"] = wall
        untraced_idle(traces[key], wall, f"Robertson {key}", card)

    # epoch 0 against the port on the CPU, same seed
    cpu = trob.run(1, device="cpu", capture=False, log=lambda *_: None)
    errs = {}
    for key in ("cn", "dopri5"):
        lc, lg = cpu[key]["losses"][0], cap[key]["losses"][0]
        rel = max(max_abs(a.cpu(), b) / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(pytree.tree_leaves(cap[key]["grads0"]),
                                  pytree.tree_leaves(cpu[key]["grads0"])))
        errs[key] = dict(loss_rel=abs(lg - lc) / abs(lc), grad_rel=rel)
        check(abs(lg - lc) <= ROB_LOSS_RTOL * abs(lc) and rel <= ROB_GRAD_TOL,
              f"Robertson {key} card vs CPU: loss {lg} vs {lc}, worst grad "
              f"max|diff|/max|g| {rel}")
    print("Robertson epoch 0, card vs the port on the CPU: "
          + "; ".join(f"{k} loss rel {v['loss_rel']:.3e}, grad "
                      f"max|diff|/max|g| {v['grad_rel']:.3e}"
                      for k, v in errs.items())
          + f" (tolerance loss rtol {ROB_LOSS_RTOL}, grads {ROB_GRAD_TOL}, "
          f"fp64 states)", flush=True)
    return dict(
        epochs=ROBERTSON_EPOCHS, check_every=CHECK_EVERY,
        **{mode: dict(cn=dict(losses=r["out"]["cn"]["losses"],
                              gnorms=r["out"]["cn"]["gnorms"],
                              epoch_ms=r["out"]["cn"]["ms"]),
                      dopri5=dict(losses=r["out"]["dopri5"]["losses"],
                                  gnorms=r["out"]["dopri5"]["gnorms"],
                                  epoch_ms=r["out"]["dopri5"]["ms"]),
                      cn_solves=r["solves"], newton_iters=r["newton_iters"],
                      cn_units=r["counts"],
                      dopri5_replays=r["dopri_replays"],
                      total_ms=r["total_ms"])
           for mode, r in runs.items()},
        traces=traces, cpu_agreement=errs)


# ---------------------------------------------------------------------------
# phase 14: the stiff ensemble, in-device (benchmarks/stiff_ensemble.py:73-137)
# ---------------------------------------------------------------------------

# the reference's kinetics, copied (benchmarks/ is not ported): Robertson
# with per-system log-multipliers c on the three rates
K_BASE = (0.04, 3.0e7, 1.0e4)
LOSS_W = (1.0, 1.0e4, 1.0)   # undoes the ~1e-5 scale of u2
ENSEMBLE = dict(batch=1024, n_steps=30, dt=0.01, train_steps=5, lr=0.05,
                seed=0)
ENS_SOLVER = dict(newton_iters=16, newton_tol=1e-10, gmres_iters=5,
                  gmres_tol=1e-12)
ENS_SOLO = 64              # lanes solved alone (B = 1) and against the CPU
# the lanes of this sample whose Newton loop exhausts its 16 iterations at
# c_true: the JAX reference flags the same lane (137 iterations, residual
# 3.57e-5; tests/test_torch_implicit_lanes.py holds it against JAX)
ENS_AUDIT_DIVERGED = [164]
ENS_SOLO_RTOL = 1e-12      # a lane alone vs in the batch (reduction shapes)
ENS_CPU_TOL = dict(rtol=1e-8, atol=1e-10)
ENS_REPLAYS = 3            # captured gradients timed (median)


def robertson_lanes(u, c, t):
    """The ensemble's vector field on a lane axis: row i of u (B, 3) with
    row i of the log-multipliers c (B, 3)."""
    import torch
    k1, k2, k3 = (b * torch.exp(c[:, i]) for i, b in enumerate(K_BASE))
    du1 = -k1 * u[:, 0] + k3 * u[:, 1] * u[:, 2]
    du3 = k2 * u[:, 1] ** 2
    return torch.stack([du1, -du1 - du3, du3], dim=-1)


def ensemble_vgrad(solver, u0, truth, w, scale):
    """``value_and_grad`` of the ensemble's loss, sum over lanes of
    ``sum((w * (u_final - truth))**2)`` over ``scale`` (the batch: the
    reference's mean), w.r.t. the log-multipliers c."""
    import torch

    def vgrad(c):
        c = c.detach().requires_grad_(True)
        uf, stats = solver(u0, c)
        loss = torch.sum((w * (uf - truth)) ** 2) / scale
        g, = torch.autograd.grad(loss, [c])
        return loss.detach(), g, uf.detach(), stats
    return vgrad


def ensemble_phase(card, dev):
    """1,024 Robertson systems (fp64, per-lane log-multipliers c_true =
    0.2 N(0, 1) from numpy's seed 0, u0 = [1, 0, 0]) through
    ``ImplicitSolver(lanes=True)``: the beuler truth, then CN with pnode
    on the device (Newton 16 at 1e-10, GMRES 5 cycles at 1e-12, 30 steps
    of 0.01), as the reference's ``vgrad_dev``: the gradient eager and
    captured (bitwise equal), the convergence audit at c_true (the lanes
    that diverge are the reference's), 5 AdamW steps from c = 0 (no lane
    diverges, the loss falls), a lane permutation (bitwise), 64 lanes
    solved alone, and 64 lanes against the port on the CPU."""
    import numpy as np
    import torch
    from repro_torch.core.adaptive import CHECK_EVERY
    from repro_torch.core.implicit import ImplicitSolver
    from repro_torch.optim.adamw import AdamW

    e = ENSEMBLE
    B, n_steps, dt = e["batch"], e["n_steps"], e["dt"]
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    c_true_np = 0.2 * np.random.RandomState(e["seed"]).randn(B, 3)
    c_true = torch.from_numpy(c_true_np).to(dev)
    u0 = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64,
                      device=dev).repeat(B, 1)
    w = torch.tensor(LOSS_W, dtype=torch.float64, device=dev)

    def solver(method="cn", capture=True, **kw):
        return ImplicitSolver(robertson_lanes, dt=dt, n_steps=n_steps,
                              method=method, lanes=True, capture=capture,
                              **ENS_SOLVER, **kw)

    # -- the truth: beuler, captured, no gradient -------------------------------
    with torch.no_grad():
        truth, tstats = solver("beuler")(u0, c_true)
    check(not bool(tstats.diverged.any()),
          f"ensemble truth: {int(tstats.diverged.sum())} lanes diverged")

    # -- the gradient, eager and captured ---------------------------------------
    eager, cap = solver(capture=False), solver()
    c0 = torch.zeros(B, 3, dtype=torch.float64, device=dev)
    vg_eager = ensemble_vgrad(eager, u0, truth, w, B)
    vg_cap = ensemble_vgrad(cap, u0, truth, w, B)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_e = vg_eager(c0)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    eager_units, eager_reads = eager.replays, eager.live_reads
    t0 = time.perf_counter()
    res_c = vg_cap(c0)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    grad_ms = []
    for _ in range(ENS_REPLAYS):
        r0, l0 = cap.replays, cap.live_reads
        t0 = time.perf_counter()
        vg_cap(c0)
        torch.cuda.synchronize()
        grad_ms.append((time.perf_counter() - t0) * 1e3)
    units, reads = cap.replays - r0, cap.live_reads - l0
    check(reads * CHECK_EVERY == units and cap.stats_reads == 0,
          f"ensemble captured host reads: {reads} live reads for {units} "
          f"replays, {cap.stats_reads} stats reads")
    same = all(torch.equal(bits(a), bits(b)) for a, b in
               zip(res_e[:3], res_c[:3])) and all(
        torch.equal(a, b) for a, b in zip(res_e[3], res_c[3]))
    check(same, "ensemble: captured gradient != eager bitwise")
    loss0, g0, uf0, st0 = res_c
    check(not bool(st0.diverged.any()),
          f"ensemble CN at c = 0: {int(st0.diverged.sum())} lanes diverged")
    check(g0.shape == (B, 3) and bool(torch.isfinite(g0).all()),
          "ensemble gradient shape or finiteness")
    iters = st0.newton_iters
    print(f"stiff ensemble: {B} Robertson systems, fp64, CN pnode on the "
          f"device, {n_steps} steps of {dt}: loss at c = 0 "
          f"{float(loss0):.10e}; Newton iterations a solve sum "
          f"{int(iters.sum())}, lane max {int(iters.max())}, lane min "
          f"{int(iters.min())}; none diverged; captured == eager bitwise "
          f"(loss, gradient, states, stats) {card}", flush=True)

    # forward ms, eager and captured
    fwd_ms = {}
    for name, s in (("eager", eager), ("captured", cap)):
        with torch.no_grad():
            s(u0, c0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s(u0, c0)
            torch.cuda.synchronize()
        fwd_ms[name] = (time.perf_counter() - t0) * 1e3
    gstats = cap.graph_stats()
    med = float(np.median(grad_ms))
    print(f"stiff ensemble times: forward eager {fwd_ms['eager']:.1f} ms, "
          f"captured {fwd_ms['captured']:.1f} ms; gradient eager "
          f"{eager_ms:.1f} ms, captured first call {first_ms:.1f} ms, then "
          f"{med:.1f} ms (median of {ENS_REPLAYS}: "
          + ", ".join(f"{v:.1f}" for v in grad_ms)
          + f"); a gradient: {units} unit replays, {reads} live reads (one "
          f"every {CHECK_EVERY}), 0 stats reads (eager: {eager_units} units, "
          f"{eager_reads} reads, the first call); graphs "
          + ", ".join(f"{k}: warm-up {wm:.1f} ms, capture {cm:.1f} ms, pool "
                      f"{pb} B" for k, (wm, cm, pb) in gstats.items())
          + f" {card}", flush=True)
    trace = traced("stiff ensemble gradient, captured",
                   lambda: vg_cap(c0), "lincomb", card, replayed=True)
    untraced_idle(trace, med, "stiff ensemble gradient", card)

    # -- the convergence audit at c_true ---------------------------------------
    with torch.no_grad():
        _, audit = cap(u0, c_true)
    bad = torch.nonzero(audit.diverged).flatten().tolist()
    ok = ~audit.diverged
    a_iters = audit.newton_iters
    print(f"stiff ensemble audit at c_true: {len(bad)} of {B} lanes "
          f"diverged, lanes {bad} (Newton residual "
          f"{audit.max_residual[bad].tolist()}, iterations "
          f"{a_iters[bad].tolist()}); the others' max Newton residual "
          f"{float(audit.max_residual[ok].max()):.3e}; Newton iterations a "
          f"solve sum {int(a_iters.sum())}, lane max {int(a_iters.max())}, "
          f"lane min {int(a_iters.min())}", flush=True)
    check(bad == ENS_AUDIT_DIVERGED,
          f"ensemble audit at c_true: lanes {bad} diverged, the reference's "
          f"are {ENS_AUDIT_DIVERGED}")

    # -- training: 5 AdamW steps from c = 0 -------------------------------------
    opt = AdamW(lr=e["lr"], weight_decay=0.0, warmup_steps=1,
                total_steps=max(e["train_steps"], 2))
    state, c, losses = opt.init(c0), c0, []
    for _ in range(e["train_steps"]):
        val, g, _, st = vg_cap(c)
        check(not bool(st.diverged.any()), "ensemble training: a lane "
              "diverged")
        losses.append(float(val))
        with torch.no_grad():
            c, state, _ = opt.update(g, state, c)
    losses.append(float(vg_cap(c)[0]))
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"ensemble training: the loss did not fall: {losses}")
    print("stiff ensemble training, AdamW lr 0.05, 5 steps: losses "
          + ", ".join(f"{v:.10e}" for v in losses), flush=True)

    # -- lane independence: a permutation, bitwise -------------------------------
    perm = torch.randperm(B, generator=torch.Generator().manual_seed(1))
    perm = perm.to(dev)
    vg_perm = ensemble_vgrad(cap, u0, truth[perm], w, B)
    _, gp, ufp, stp = vg_perm(c_true[perm])
    _, gq, ufq, stq = vg_cap(c_true)
    check(torch.equal(bits(gp), bits(gq[perm]))
          and torch.equal(bits(ufp), bits(ufq[perm]))
          and torch.equal(stp.newton_iters, stq.newton_iters[perm]),
          "ensemble: a lane permutation does not permute the results "
          "bitwise")
    print("stiff ensemble lane permutation (at c_true): states, gradient "
          "rows and Newton iterations permuted bitwise", flush=True)

    # -- 64 lanes alone (B = 1) ---------------------------------------------------
    solo = solver()
    worst, same_iters = 0.0, True
    with torch.no_grad():
        for i in range(ENS_SOLO):
            uf1, st1 = solo(u0[i:i + 1], c_true[i:i + 1])
            worst = max(worst, float(((uf1[0] - ufq[i]).abs()
                                      / ufq[i].abs().clamp_min(1e-300))
                                     .max()))
            same_iters &= int(st1.newton_iters[0]) == int(
                stq.newton_iters[i])
    check(same_iters and worst <= ENS_SOLO_RTOL,
          f"ensemble: lanes alone differ from the batch (Newton iterations "
          f"equal: {same_iters}, worst relative state difference {worst})")
    print(f"stiff ensemble: {ENS_SOLO} lanes solved alone (B = 1) take the "
          f"batch's Newton iterations, states within {worst:.3e} relative "
          f"(limit {ENS_SOLO_RTOL})", flush=True)

    # -- 64 lanes and the audit's diverged ones against the port on the CPU -----
    sl = torch.tensor(list(range(ENS_SOLO)) + bad, device=dev)
    cpu_solver = ImplicitSolver(robertson_lanes, dt=dt, n_steps=n_steps,
                                method="cn", lanes=True, **ENS_SOLVER)
    vg_cpu = ensemble_vgrad(cpu_solver, u0[sl].cpu(), truth[sl].cpu(),
                            w.cpu(), B)
    _, g_c, uf_c, st_c = vg_cpu(c_true[sl].cpu())
    err_u = max_abs(ufq[sl].cpu(), uf_c)
    err_g = max_abs(gq[sl].cpu(), g_c)
    check(torch.allclose(ufq[sl].cpu(), uf_c, **ENS_CPU_TOL)
          and torch.allclose(gq[sl].cpu(), g_c, **ENS_CPU_TOL)
          and torch.equal(st_c.newton_iters, stq.newton_iters[sl].cpu())
          and torch.equal(st_c.diverged, stq.diverged[sl].cpu()),
          f"ensemble card vs CPU on {len(sl)} lanes: states {err_u}, "
          f"gradient {err_g}")
    peak = torch.cuda.max_memory_allocated() - before
    print(f"stiff ensemble, card vs the port on the CPU on lanes 0-"
          f"{ENS_SOLO - 1} and {bad} at c_true: same Newton iterations and "
          f"diverged flags, max|diff| states "
          f"{err_u:.3e}, gradient {err_g:.3e} (tolerance {ENS_CPU_TOL}); "
          f"peak allocated above the phase's start {peak} B {card}",
          flush=True)
    return dict(batch=B, n_steps=n_steps, dt=dt, loss0=float(loss0),
                newton_iters=dict(sum=int(iters.sum()),
                                  lane_max=int(iters.max()),
                                  lane_min=int(iters.min())),
                forward_ms=fwd_ms, grad_eager_ms=eager_ms,
                grad_first_ms=first_ms, grad_ms=grad_ms,
                units=units, live_reads=reads, check_every=CHECK_EVERY,
                eager_units=eager_units, eager_reads=eager_reads,
                graphs={k: dict(warmup_ms=wm, capture_ms=cm, pool_bytes=pb)
                        for k, (wm, cm, pb) in gstats.items()},
                audit_diverged_lanes=bad,
                audit_newton_iters=dict(sum=int(a_iters.sum()),
                                        lane_max=int(a_iters.max()),
                                        lane_min=int(a_iters.min())),
                trace=trace, losses=losses, solo_worst_rel=worst,
                cpu_max_abs=dict(states=err_u, gradient=err_g),
                peak_bytes=peak)


# ---------------------------------------------------------------------------
# phase 15: the memory planner at the classifier's width
# ---------------------------------------------------------------------------

PLAN_NT = (4, 8)           # N_t of the measured table (Fig. 3's axis)
PLAN_POLICIES = [("naive", None), ("pnode", None), ("pnode2", None),
                 ("revolve", 2)]
PLAN_SLOPE = (0.2, 5.0)    # model / measured pnode slope (tests/test_mem.py)
ROB_PLAN_BUDGET = 400000   # the Robertson example's in-device budget


def cls_odeint_grads(params, images, labels, **odeint_kw):
    """The classifier's loss and gradient with its ODE block solved by
    ``odeint(conv_vf, ...)`` over [0, 1] in ``CLS["n_steps"]`` rk4 steps,
    with ``odeint_kw`` (the policy, or ``adjoint="auto"`` and a budget)."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.core.adjoint import odeint
    from repro_torch.models.ode_nets import classifier_apply, softmax_xent

    def odeint_fn(vf, u, th):
        return odeint(vf, u, th, dt=1.0 / CLS["n_steps"],
                      n_steps=CLS["n_steps"], method=CLS["method"],
                      **odeint_kw)

    leaves = [p.detach().requires_grad_(True)
              for p in pytree.tree_leaves(params)]
    p = pytree.tree_unflatten(leaves, pytree.tree_structure(params))
    loss = softmax_xent(classifier_apply(p, images, odeint_fn=odeint_fn),
                        labels)
    return loss.detach(), list(torch.autograd.grad(loss, leaves))


def planner_phase(card, dev, params, images, labels):
    """The memory planner (``repro_torch.mem``) on the card at the §5.1
    classifier's width: its ODE block's state (batch 128 x 32 x 32 x 32
    fp32, from phase 4's seeded weights and first batch), rk4.  Measured
    peaks (the CUDA allocator) beside the Table-2 model and the live
    tensor tracker; the Fig. 3 order and slope contracts; auto plans at
    anchor budgets that fit, measured again in windows of their own, with
    gradients bitwise the chosen policy's; the Robertson example's
    ``--mem-budget`` (phase 16 runs the spill fallback)."""
    import contextlib
    import io
    import torch
    from repro_torch.core.adjoint import (_FUSED_POLICIES,
                                          expected_lincomb_calls)
    from repro_torch.examples import stiff_robertson as trob
    from repro_torch.kernels import ops
    from repro_torch.mem import model
    from repro_torch.mem.planner import plan_odeint
    from repro_torch.models.ode_nets import (classifier_apply, conv_vf,
                                             mlp_vf_init)

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    gc_collect()
    box = []
    with torch.no_grad():  # the ODE block's input, as the classifier makes it
        classifier_apply(params, images,
                         odeint_fn=lambda vf, u, th: box.append(u) or u)
    u0, theta = box[0], params["ode"]
    sb, tb = model.tree_bytes(u0), model.tree_bytes(theta)
    fa = model.f_activation_bytes(conv_vf, u0, theta)
    print(f"planner: ODE state {tuple(u0.shape)} {u0.dtype} = {sb} B, "
          f"theta {tb} B, f_activation_bytes {fa} B ({fa / sb:.2f} states; "
          f"aten outputs of one conv_vf on meta tensors)", flush=True)

    def kw(n_t):
        return dict(dt=1.0 / n_t, n_steps=n_t, method=CLS["method"])

    def fused(policy):
        return policy in _FUSED_POLICIES

    def measure(policy, ncheck, n_t):
        return model.measure_reverse_cost(
            conv_vf, u0, theta, policy=policy, ncheck=ncheck,
            fused_stages=fused(policy), **kw(n_t))

    table = []
    for n_t in PLAN_NT:
        for policy, ncheck in PLAN_POLICIES:
            m = measure(policy, ncheck, n_t)
            check(m["source"] == "cuda_allocator",
                  f"measure_reverse_cost read {m['source']} on the card")
            pred = model.policy_cost(policy, method=CLS["method"],
                                     n_steps=n_t, state_bytes=sb,
                                     theta_bytes=tb, f_act_bytes=fa,
                                     ncheck=ncheck).peak_bytes
            live = model.live_tensor_peak(model.reverse_pass(
                conv_vf, u0, theta, policy=policy, ncheck=ncheck,
                fused_stages=fused(policy), **kw(n_t)))
            row = dict(policy=policy, ncheck=ncheck, n_steps=n_t,
                       model_bytes=pred, allocator_bytes=m["peak_bytes"],
                       tracker_bytes=live, fused=fused(policy))
            table.append(row)
            print(f"planner N_t={n_t} {policy}"
                  f"{'' if ncheck is None else f'({ncheck})'}"
                  f"{' fused' if fused(policy) else ''}: model {pred} B, "
                  f"allocator {m['peak_bytes']} B "
                  f"({m['peak_bytes'] / max(pred, 1):.3f}x the model), "
                  f"tracker {live} B (allocator/tracker "
                  f"{m['peak_bytes'] / max(live, 1):.4f}) {card}",
                  flush=True)

    def at(key, policy, n_t):
        return next(r[key] for r in table
                    if r["policy"] == policy and r["n_steps"] == n_t)

    order = ["naive", "pnode", "pnode2"]
    for n_t in PLAN_NT:
        for key in ("allocator_bytes", "model_bytes"):
            vals = [at(key, p, n_t) for p in order]
            check(vals[0] > vals[1] > vals[2],
                  f"Fig. 3 order naive > pnode > pnode2 fails for {key} at "
                  f"N_t={n_t}: {vals}")
    lo, hi = PLAN_NT
    meas_slope = (at("allocator_bytes", "pnode", hi)
                  - at("allocator_bytes", "pnode", lo)) / (hi - lo)
    pred_slope = (at("model_bytes", "pnode", hi)
                  - at("model_bytes", "pnode", lo)) / (hi - lo)
    ratio = pred_slope / meas_slope
    check(PLAN_SLOPE[0] < ratio < PLAN_SLOPE[1],
          f"pnode slope: model {pred_slope} B a step over measured "
          f"{meas_slope} = {ratio}, outside {PLAN_SLOPE}")
    print(f"planner Fig. 3 contracts on the card: allocator and model order "
          f"naive > pnode > pnode2 at N_t={PLAN_NT}; pnode slope model "
          f"{pred_slope:.0f} B a step / measured {meas_slope:.0f} = "
          f"{ratio:.4f} (in {PLAN_SLOPE})", flush=True)

    # -- auto plans at the anchor budgets (N_t of the classifier) -----------
    n_t = CLS["n_steps"]
    anchors = {f"{p}{'' if k is None else f'({k})'}":
               at("allocator_bytes", p, n_t) for p, k in PLAN_POLICIES}
    anchors["2x naive"] = 2 * anchors["naive"]
    anchors["naive's model"] = at("model_bytes", "naive", n_t)
    plans = {}
    for name, budget in anchors.items():
        plan = plan_odeint(conv_vf, u0, theta, mem_budget=budget,
                           fused_stages=True, explain=True, **kw(n_t))
        check(plan.offload is None and plan.fits
              and plan.measured_bytes is not None
              and plan.measured_bytes <= budget,
              f"auto plan at {name} = {budget} B: {plan.policy} "
              f"{plan.ncheck} {plan.offload}, measured {plan.measured_bytes}")
        window = model.allocator_peak(model.reverse_pass(
            conv_vf, u0, theta, policy="auto", mem_budget=budget,
            fused_stages=True, **kw(n_t)), dev)
        check(window <= budget, f"auto plan at {name}: its gradient peaked "
              f"at {window} B in a window of its own, over {budget} B")
        plans[name] = (budget, plan, window)
        print(f"planner budget {name} = {budget} B: {plan.policy}"
              f"{'' if plan.ncheck is None else f'({plan.ncheck})'}, "
              f"measured {plan.measured_bytes} B, again in its own window "
              f"{window} B, predicted {plan.predicted.peak_bytes} B, NFE-B "
              f"{plan.extra_fevals} {card}", flush=True)
    shown = plans["pnode"][1]
    print(f"planner explain=True at the pnode anchor ({plans['pnode'][0]} "
          "B):", flush=True)
    for r in shown.report:
        print(f"  {r.policy}{'' if r.ncheck is None else f'({r.ncheck})'}: "
              f"predicted {r.predicted_peak_bytes} B, measured "
              f"{r.measured_bytes}, NFE-B {r.extra_fevals}: {r.reason}")

    # -- the auto-planned classifier gradient, counted ------------------------
    # every plan was measured above, so these gradients measure nothing
    meas0 = model.measurements
    ops.reset_counts()
    auto = {}
    for name, (budget, plan, _) in plans.items():
        auto[name] = cls_odeint_grads(params, images, labels,
                                      adjoint="auto", mem_budget=budget,
                                      fused_stages=True)
    torch.cuda.synchronize()
    launches, plain = ops.launches, ops.plain_calls
    expected = sum(expected_lincomb_calls(CLS["method"], n_t, 1, p.policy,
                                          p.ncheck)
                   for _, p, _ in plans.values() if fused(p.policy))
    check(plain == 0 and launches == expected,
          f"planner phase: {launches} fused_lincomb launches (expected "
          f"{expected}), {plain} plain calls")
    check(model.measurements == meas0,
          f"the auto gradients measured {model.measurements - meas0} "
          "candidates again: the measurement cache missed")
    print(f"planner: {len(plans)} auto-planned classifier gradients, "
          f"{launches} fused_lincomb launches (expected {expected}), no "
          "measurement (cache hits)", flush=True)
    naive = cls_odeint_grads(params, images, labels, adjoint="naive")
    worst = 0.0
    for name, (budget, plan, _) in plans.items():
        loss_a, g_a = auto[name]
        loss_e, g_e = cls_odeint_grads(
            params, images, labels, adjoint=plan.policy, ncheck=plan.ncheck,
            fused_stages=fused(plan.policy))
        check(torch.equal(bits(loss_a), bits(loss_e))
              and all(torch.equal(bits(a), bits(b))
                      for a, b in zip(g_a, g_e)),
              f"auto gradient at {name} differs from {plan.policy}'s")
        rel = max(max_abs(a, b) / max(float(b.abs().max()), 1e-12)
                  for a, b in zip(g_a, naive[1]))
        check(rel <= CLS_GRAD_TOL, f"auto gradient at {name} vs naive: "
              f"worst per-leaf max|diff|/max|g| {rel}")
        worst = max(worst, rel)
    print(f"planner: every auto gradient BITWISE equal to its explicit "
          f"policy's; against naive's worst per-leaf max|diff|/max|g| "
          f"{worst:.3e} (tolerance {CLS_GRAD_TOL})", flush=True)

    gc_collect()

    # -- the Robertson example's --mem-budget, fp64 --------------------------
    torch.use_deterministic_algorithms(False)  # the adaptive ring write
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = trob.main(["--epochs", "1", "--mem-budget",
                         str(ROB_PLAN_BUDGET)])
    line = next(ln for ln in text.getvalue().splitlines()
                if ln.startswith("planner @"))
    cpu_lines = []
    trob.plan_cn(torch.zeros(3, dtype=torch.float64),
                 mlp_vf_init(torch.Generator().manual_seed(0), 3, hidden=32,
                             n_hidden=3, device="cpu"),
                 ROB_PLAN_BUDGET, log=cpu_lines.append)
    rob_plan = out["plan"]
    explicit = trob.run(1, adjoint=rob_plan.policy, ncheck=rob_plan.ncheck,
                        log=lambda *_: None)
    check(line == cpu_lines[0], f"Robertson plan line on the card {line!r} "
          f"!= the CPU's {cpu_lines[0]!r}")
    check(all(s.policy == rob_plan.policy and s.ncheck == rob_plan.ncheck
              for s in out["losses"].cn_solvers),
          "the Robertson CN solvers do not run the plan's policy")
    for key in ("cn", "dopri5"):
        check(out[key]["losses"] == explicit[key]["losses"]
              and out[key]["gnorms"] == explicit[key]["gnorms"],
              f"Robertson {key} epoch 0 under --mem-budget "
              f"{out[key]['losses']} != explicit {explicit[key]['losses']}")
    print(f"Robertson --mem-budget {ROB_PLAN_BUDGET} on the card: {line}; "
          f"epoch-0 CN loss {out['cn']['losses'][0]:.12f}, |g| "
          f"{out['cn']['gnorms'][0]:.6e}, equal to adjoint="
          f"{rob_plan.policy!r}, ncheck={rob_plan.ncheck} passed "
          f"explicitly {card}", flush=True)
    return dict(state_bytes=sb, theta_bytes=tb, f_activation_bytes=fa,
                table=table, slope_ratio=ratio,
                plans={name: dict(budget=b, policy=p.policy, ncheck=p.ncheck,
                                  measured_bytes=p.measured_bytes,
                                  window_bytes=w,
                                  predicted_bytes=p.predicted.peak_bytes)
                       for name, (b, p, w) in plans.items()},
                launches=launches, expected=expected,
                grad_vs_naive=worst, robertson_plan=line,
                robertson_cn={k: out["cn"][k] for k in ("losses", "gnorms")})


# ---------------------------------------------------------------------------
# phase 16: the offload tiers at the classifier's width
# ---------------------------------------------------------------------------

OFFLOAD_NT = 16            # N_t of the offloaded gradients
OFFLOAD_SNAPS = 8          # snaps_in_ram of the split spill store
#: (label, policy, ncheck, odeint keywords): each gradient is held against
#: the device tier's of its policy, bitwise
OFFLOAD_CASES = [
    ("pnode device", "pnode", None, {}),
    ("pnode spill", "pnode", None, dict(offload="spill")),
    ("pnode disk", "pnode", None, dict(offload="disk")),
    (f"pnode spill snaps_in_ram={OFFLOAD_SNAPS}", "pnode", None,
     dict(offload="spill", snaps_in_ram=OFFLOAD_SNAPS)),
    ("revolve(2) device", "revolve", 2, {}),
    ("revolve(2) host", "revolve", 2, dict(offload="host")),
]
ROB_SPILL_BUDGET = 2000    # the Robertson example's spill budget


def ode_gradient(f, u0, theta, **odeint_kw):
    """A call that runs one gradient of sum(u_final ** 2) w.r.t. u0 and
    theta, ``odeint`` over [0, 1] in ``OFFLOAD_NT`` fused rk4 steps with
    ``odeint_kw`` (the policy and the tier), and returns it."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.core.adjoint import odeint

    def run():
        leaves, spec = pytree.tree_flatten((u0, theta))
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        u, th = pytree.tree_unflatten(leaves, spec)
        uf = odeint(f, u, th, dt=1.0 / OFFLOAD_NT, n_steps=OFFLOAD_NT,
                    method="rk4", fused_stages=True, **odeint_kw)
        return torch.autograd.grad(torch.sum(uf * uf), leaves)

    return run


def offload_phase(card, dev, params, images, labels, cnf_theta, x,
                  robertson_cn):
    """The offload tiers (``repro_torch.mem.offload``) on the card at the
    §5.1 classifier's width: phase 4's ODE block (state 128 x 32 x 32 x 32
    fp32, phase 4's seeded weights and first batch), rk4, N_t = 16, fused.
    Each gradient's allocator peak (a window of its own), wall ms, copies
    and spill counters, BITWISE equal to its policy's device tier, and
    counted (``fused_lincomb`` launches = ``expected_lincomb_calls``); the
    adaptive CNF at POWER width with its ring on the spill tier, captured,
    BITWISE phase 12's device ring; the planner one byte under its
    cheapest in-device candidate (pnode + spill, measured against the
    budget, the auto gradient counted and bitwise pnode's); and the
    Robertson example's ``--mem-budget 2000`` (its CN epoch 0 bitwise the
    in-device plan's of phase 15)."""
    import contextlib
    import io
    import torch
    from repro_torch.core.adjoint import expected_lincomb_calls
    from repro_torch.core.cnf import AdaptiveCNF
    from repro_torch.examples import stiff_robertson as trob
    from repro_torch.kernels import ops
    from repro_torch.mem import model, offload
    from repro_torch.mem.planner import candidate_costs, plan_odeint
    from repro_torch.models.ode_nets import (classifier_apply, cnf_vf,
                                             conv_vf)

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    gc_collect()
    box = []
    with torch.no_grad():  # the ODE block's input, as the classifier makes it
        classifier_apply(params, images,
                         odeint_fn=lambda vf, u, th: box.append(u) or u)
    u0, theta = box[0], params["ode"]
    sb = model.tree_bytes(u0)
    disk_dir = ROOT / "build" / "offload"
    seg = model.default_segment(OFFLOAD_NT)
    slot = 5 * sb  # rk4: the state and its 4 stages
    print(f"offload: ODE state {tuple(u0.shape)} {u0.dtype} = {sb} B, rk4 "
          f"slot {slot} B, N_t = {OFFLOAD_NT}, segment {seg}: "
          f"{OFFLOAD_NT * slot} B of checkpoints each way", flush=True)

    stores = []
    make_store = offload.make_store

    def keep(*a, **k):  # every store a gradient makes, for its copies
        stores.append(make_store(*a, **k))
        return stores[-1]

    offload.make_store = keep
    rows, grads, launches, expected = {}, {}, 0, 0
    try:
        for label, policy, ncheck, kw in OFFLOAD_CASES:
            if kw.get("offload") == "disk":
                kw = dict(kw, offload_dir=str(disk_dir))
            fn = ode_gradient(conv_vf, u0, theta, adjoint=policy,
                              ncheck=ncheck, **kw)
            peak = model.allocator_peak(fn, dev)
            del stores[:]
            offload.reset_spill_stats()
            ops.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            n, plain = ops.launches, ops.plain_calls
            want = expected_lincomb_calls("rk4", OFFLOAD_NT, 1, policy,
                                          ncheck)
            check(plain == 0 and n == want,
                  f"offload {label}: {n} fused_lincomb launches (expected "
                  f"{want}), {plain} plain calls")
            launches, expected = launches + n, expected + want
            stats = offload.spill_stats()
            copies = {k: sum(st.copies[k] for st in stores)
                      for k in ("d2h", "h2d")}
            tiers = sorted({st.effective_tier for st in stores})
            check(not kw or tiers == [kw["offload"]],
                  f"offload {label}: the stores ran on {tiers}")
            if not kw:
                grads[policy] = g
            else:
                check(all(torch.equal(bits(a), bits(b))
                          for a, b in zip(g, grads[policy])),
                      f"offload {label}: gradient differs from the device "
                      "tier's")
            rows[label] = dict(peak_bytes=peak, ms=ms, launches=n,
                               copies=copies, stores=len(stores),
                               spill_stats={k: v for k, v in stats.items()
                                            if v})
            print(f"offload {label}: peak {peak} B ({peak / 2**30:.4f} GiB), "
                  f"{ms:.1f} ms, {n} fused_lincomb launches (expected "
                  f"{want}), copies {copies}, spill_stats "
                  f"{rows[label]['spill_stats']}"
                  + (", gradient BITWISE the device tier's" if kw else "")
                  + f" {card}", flush=True)
            del g
            gc_collect()
    finally:
        offload.make_store = make_store
    dev_peak = rows["pnode device"]["peak_bytes"]
    for label in ("pnode spill", "pnode disk"):
        check(rows[label]["peak_bytes"] < dev_peak,
              f"offload {label}: peak {rows[label]['peak_bytes']} B not "
              f"below the device tier's {dev_peak} B")
    sp = rows["pnode spill"]["spill_stats"]
    check((sp["write_cb"], sp["read_cb"]) == (OFFLOAD_NT // seg,) * 2
          and sp["write_bytes"] == sp["read_bytes"] == OFFLOAD_NT * slot,
          f"offload pnode spill transfers {sp}")
    sp_peak = rows["pnode spill"]["peak_bytes"]
    print(f"offload: pnode's allocator peak, spill {sp_peak} B / device "
          f"{dev_peak} B = {sp_peak / dev_peak:.4f}; "
          f"{sp['write_cb']} + {sp['read_cb']} transfers of "
          f"{sp['write_bytes']} B each way {card}", flush=True)
    gc_collect()

    # -- the planner one byte under its cheapest in-device candidate ---------
    n_t = CLS["n_steps"]
    kw = dict(dt=1.0 / n_t, n_steps=n_t, method=CLS["method"])
    cands = candidate_costs(method=CLS["method"], n_steps=n_t,
                            state_bytes=sb,
                            theta_bytes=model.tree_bytes(theta),
                            f_act_bytes=model.f_activation_bytes(
                                conv_vf, u0, theta))
    cheapest = min(min(c.peak_bytes, model.measure_reverse_cost(
        conv_vf, u0, theta, policy=c.policy, ncheck=c.ncheck,
        fused_stages=c.policy in ("pnode", "pnode2", "revolve", "revolve2"),
        **kw)["peak_bytes"]) for c in cands)
    budget = int(cheapest) - 1
    plan = plan_odeint(conv_vf, u0, theta, mem_budget=budget,
                       fused_stages=True, **kw)
    check((plan.policy, plan.offload) == ("pnode", "spill")
          and plan.measured_bytes is not None,
          f"one byte under the cheapest candidate: {plan}")
    meas0 = model.measurements
    ops.reset_counts()
    loss_a, g_a = cls_odeint_grads(params, images, labels, adjoint="auto",
                                   mem_budget=budget, fused_stages=True)
    torch.cuda.synchronize()
    n, plain = ops.launches, ops.plain_calls
    want = expected_lincomb_calls(CLS["method"], n_t, 1, "pnode")
    check(plain == 0 and n == want and model.measurements == meas0,
          f"planner spill gradient: {n} launches (expected {want}), "
          f"{plain} plain, {model.measurements - meas0} measurements")
    launches, expected = launches + n, expected + want
    loss_p, g_p = cls_odeint_grads(params, images, labels, adjoint="pnode",
                                   fused_stages=True)
    check(torch.equal(bits(loss_a), bits(loss_p))
          and all(torch.equal(bits(a), bits(b)) for a, b in zip(g_a, g_p)),
          "the planner's spill gradient differs from pnode's on the device")
    print(f"planner at {budget} B (one under the cheapest in-device "
          f"candidate, {cheapest} B): pnode + {plan.offload}, measured "
          f"{plan.measured_bytes} B against the budget {budget} B "
          f"({'fits' if plan.fits else 'over'}; predicted "
          f"{plan.predicted.peak_bytes} B); the auto classifier gradient "
          f"BITWISE pnode's on the device, {n} launches (expected {want}) "
          f"{card}", flush=True)
    gc_collect()

    # -- the adaptive CNF at POWER width, the ring on the spill tier ---------
    d_ref, s_ref, info_ref, ring_ref = KEPT.pop("adaptive_batched")
    cnf = AdaptiveCNF(cnf_vf, CNF["dim"], fused_stages=True, capture=True,
                      offload="spill", **ADAPTIVE)
    offload.reset_spill_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_s, s_s, info_s = adaptive_request(cnf, cnf_theta, x)
    torch.cuda.synchronize()
    a_ms = (time.perf_counter() - t0) * 1e3
    a_stats = {k: v for k, v in offload.spill_stats().items() if v}
    ring, slots = cnf.solver.ring_bytes, cnf.solver.ring_slots
    check(info_s == info_ref and torch.equal(bits(d_s), bits(d_ref))
          and torch.equal(bits(s_s), bits(s_ref)),
          "adaptive CNF on the spill ring differs from phase 12's device "
          f"ring: {info_s} vs {info_ref}, max|diff| {max_abs(d_s, d_ref)}, "
          f"{max_abs(s_s, s_ref)}")
    print(f"adaptive CNF batched state, POWER width, captured, ring on the "
          f"spill tier: BITWISE phase 12's device ring (density and score, "
          f"{info_s.n_accepted} accepted steps); ring {ring} B "
          f"({slots} slots) against {ring_ref} B "
          f"({ADAPTIVE['max_steps']} slots); first call {a_ms:.1f} ms; "
          f"spill_stats {a_stats} {card}", flush=True)
    del cnf
    gc_collect()

    # -- the Robertson example's --mem-budget 2000, fp64 ---------------------
    torch.use_deterministic_algorithms(False)  # the adaptive ring write
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = trob.main(["--epochs", "1", "--mem-budget",
                         str(ROB_SPILL_BUDGET)])
    lines = text.getvalue().splitlines()
    line = next(ln for ln in lines if ln.startswith("planner @"))
    check((out["plan"].policy, out["plan"].offload) == ("pnode", "spill")
          and any("item 10a" in ln for ln in lines),
          f"Robertson --mem-budget {ROB_SPILL_BUDGET}: {line}")
    check(all(s.offload == "spill" and not s.masked
              for s in out["losses"].cn_solvers),
          "the Robertson CN solvers do not run the spill plan eagerly")
    check(out["cn"]["losses"] == robertson_cn["losses"]
          and out["cn"]["gnorms"] == robertson_cn["gnorms"],
          f"Robertson CN epoch 0 under --mem-budget {ROB_SPILL_BUDGET} "
          f"{out['cn']['losses']}, |g| {out['cn']['gnorms']} != the "
          f"in-device plan's {robertson_cn}")
    print(f"Robertson --mem-budget {ROB_SPILL_BUDGET} on the card: {line}; "
          f"CN solvers eager (item 10a); epoch-0 CN loss "
          f"{out['cn']['losses'][0]:.12f}, |g| {out['cn']['gnorms'][0]:.6e}, "
          f"equal to --mem-budget {ROB_PLAN_BUDGET}'s {card}", flush=True)
    gc_collect()
    return dict(n_steps=OFFLOAD_NT, segment=seg, state_bytes=sb,
                slot_bytes=slot, gradients=rows, launches=launches,
                expected=expected,
                planner=dict(budget=budget, cheapest=int(cheapest),
                             measured_bytes=plan.measured_bytes,
                             predicted_bytes=plan.predicted.peak_bytes,
                             fits=plan.fits),
                adaptive=dict(ring_bytes=ring, ring_slots=slots,
                              device_ring_bytes=ring_ref, ms=a_ms,
                              spill_stats=a_stats),
                robertson_plan=line)


# ---------------------------------------------------------------------------
# phase 17: the flight recorder, fault injection and checkpoints
# ---------------------------------------------------------------------------

OBS_STREAM = 8             # captured observed one-point requests timed
ADAPTIVE_FAULT = ("adaptive", 2, "nan", 2)   # attempts 2 and 3 poisoned
FAULT_RTOL = 1e-5          # the faulted adaptive request vs the clean one
#: the Robertson fault cases: CN, pnode on the spill tier, fp64, rates
#: K_BASE as the differentiated parameter
ROB_FAULT = dict(n_steps=16, dt=0.025, segment=4, newton_iters=10,
                 newton_tol=1e-10, gmres_iters=10)
#: (label, fault specs, solve keywords, the spill counter that must move)
IMPLICIT_FAULTS = [
    ("spill.write corrupt at 1", [("spill.write", 1, "corrupt")],
     dict(resilient=True), "integrity_fail"),
    ("spill.write drop at 2", [("spill.write", 2, "drop")],
     dict(resilient=True), "integrity_fail"),
    ("spill.read flake at 0", [("spill.read", 0, "flake")],
     dict(resilient=True), "retry_cb"),
    ("newton diverge at 5", [("newton", 5, "diverge")], dict(rescue=True),
     "rescued"),
    ("newton nan at 3", [("newton", 3, "nan")], dict(rescue=True),
     "rescued"),
]
CKPT_SAVE_AT = 2           # the classifier's checkpoint, after this step
SERVE_FAULT_GEN = 8        # greedy tokens of the faulted TinyLlama serve


def robertson_rates(u, k, t):
    """Robertson's kinetics with the rates ``k`` as the parameter."""
    import torch
    u1, u2, u3 = u
    return torch.stack([-k[0] * u1 + k[2] * u2 * u3,
                        k[0] * u1 - k[1] * u2 ** 2 - k[2] * u2 * u3,
                        k[1] * u2 ** 2])


def recorder_phase(card, dev, params, images, labels, cnf_theta, x,
                   adaptive_res):
    """Phase 17a-c: the flight recorder (``repro_torch.obs``) and fault
    injection (``repro_torch.ft``) on the card.  (a) phase 16's pnode +
    spill gradient at the classifier's width with a ``FlightRecorder``:
    BITWISE the unobserved gradient, its ``spill_traffic()`` equal to the
    store's counters, timed without and with (A B B A), counted.  (b)
    phase 12's one-point adaptive CNF request with ``obs=``, eager
    (counted) and captured (the attempt log written inside the captured
    attempt): BITWISE each other and the unobserved request, the captured
    log the eager one, ``accepted_rejected()`` the solve's counts, timed
    against the unobserved captured request on the same points (A B B A);
    the request with attempts 2-3 poisoned, captured: finite, rejected >= 2,
    within ``FAULT_RTOL`` of the clean one; a ``FevalCounter`` counting
    the f evaluations the captured attempts execute, dead ones included.
    (c) Robertson, fp64, CN, pnode + spill, segment 4: every
    ``IMPLICIT_FAULTS`` case BITWISE the fault-free gradient, each with
    the counter that shows its fault was met (the store's ``integrity_fail``
    or ``retry_cb``, or the recorder's one rescued Newton step); a
    persistent read flake without ``resilient`` raises."""
    import torch
    from repro_torch.core.adaptive import (DOPRI5,
                                           expected_adaptive_lincomb_calls)
    from repro_torch.core.adjoint import expected_lincomb_calls
    from repro_torch.core.cnf import AdaptiveCNF
    from repro_torch.core.implicit import odeint_implicit
    from repro_torch.ft import FaultPlan, FaultSpec
    from repro_torch.kernels import ops
    from repro_torch.mem import model, offload
    from repro_torch.models.ode_nets import (classifier_apply, cnf_vf,
                                             conv_vf)
    from repro_torch.obs import FevalCounter, FlightRecorder

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    gc_collect()
    out = {}

    # -- (a) the recorder on the spill gradient at the classifier's width ----
    box = []
    with torch.no_grad():
        classifier_apply(params, images,
                         odeint_fn=lambda vf, u, th: box.append(u) or u)
    u0, theta = box[0], params["ode"]
    seg = model.default_segment(OFFLOAD_NT)
    slot = 5 * model.tree_bytes(u0)
    want = expected_lincomb_calls("rk4", OFFLOAD_NT, 1, "pnode")
    grads, ms, events = {}, {"plain": [], "recorder": []}, 0
    out["launches"], out["expected"] = 0, 0
    # an untimed gradient first: the first one of a process pays the
    # pinned buffers and the copy stream (2,381 ms against 1,261)
    ode_gradient(conv_vf, u0, theta, adjoint="pnode", offload="spill")()
    for label in ("plain", "recorder", "recorder", "plain"):
        rec = FlightRecorder() if label == "recorder" else None
        fn = ode_gradient(conv_vf, u0, theta, adjoint="pnode",
                          offload="spill", obs=rec)
        offload.reset_spill_stats()
        ops.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = fn()
        torch.cuda.synchronize()
        ms[label].append((time.perf_counter() - t0) * 1e3)
        n, plain = ops.launches, ops.plain_calls
        check(plain == 0 and n == want,
              f"recorder, {label} spill gradient: {n} fused_lincomb "
              f"launches (expected {want}), {plain} plain calls")
        out["launches"] += n
        out["expected"] += want
        if rec is not None:
            stats = offload.spill_stats()
            (traffic,) = rec.spill_traffic().values()
            keys = ("write_cb", "read_cb", "write_slots", "read_slots",
                    "write_bytes", "read_bytes", "dispatch_cb")
            check(all(traffic[k] == stats[k] for k in keys)
                  and (traffic["write_cb"], traffic["read_cb"])
                  == (OFFLOAD_NT // seg,) * 2
                  and traffic["write_bytes"] == traffic["read_bytes"]
                  == OFFLOAD_NT * slot,
                  f"spill_traffic {traffic} != the store's {stats}")
            events = len(rec)
        if label in grads:
            check(all(torch.equal(bits(a), bits(b))
                      for a, b in zip(g, grads[label])),
                  f"recorder: two {label} spill gradients differ")
        else:
            grads[label] = g
        del g
    check(all(torch.equal(bits(a), bits(b))
              for a, b in zip(grads["plain"], grads["recorder"])),
          "the spill gradient with a recorder differs from the one without")
    med = {k: (v[0] + v[1]) / 2 for k, v in ms.items()}
    print(f"phase 17 recorder, pnode + spill gradient at the classifier's "
          f"width (N_t {OFFLOAD_NT}, segment {seg}, fused): BITWISE the "
          f"unobserved gradient; spill_traffic() equals the store's "
          f"counters: {OFFLOAD_NT // seg} + {OFFLOAD_NT // seg} transfers "
          f"of {OFFLOAD_NT * slot} B each way; {events} events; "
          f"{want} fused_lincomb launches a gradient; ms without "
          f"{ms['plain']} / with {ms['recorder']} (A B B A), mean "
          f"{med['plain']:.1f} vs {med['recorder']:.1f} "
          f"({med['recorder'] / med['plain']:.4f}x) {card}", flush=True)
    out["spill_gradient"] = dict(ms=ms, mean_ms=med, events=events,
                                 transfers=OFFLOAD_NT // seg,
                                 bytes_each_way=OFFLOAD_NT * slot,
                                 launches=want)
    del grads
    gc_collect()

    # -- (b) the adaptive CNF request with a recorder, eager and captured ----
    dim = CNF["dim"]
    points = x[:OBS_STREAM]
    ref = adaptive_request(AdaptiveCNF(cnf_vf, dim, fused_stages=True,
                                       **ADAPTIVE), cnf_theta, points[0])
    rec_e = FlightRecorder()
    eager_cnf = AdaptiveCNF(cnf_vf, dim, fused_stages=True, obs=rec_e,
                            **ADAPTIVE)
    ops.reset_counts()
    eager, eager_ms = timed_request(eager_cnf, cnf_theta, points[0])
    n, plain, info = ops.launches, ops.plain_calls, eager[2]
    want = expected_adaptive_lincomb_calls(
        info.n_accepted, info.n_rejected, 2, backward=False) \
        + expected_adaptive_lincomb_calls(info.n_accepted, info.n_rejected, 2)
    check(plain == 0 and n == want,
          f"observed adaptive request: {n} launches (expected {want}), "
          f"{plain} plain calls")
    check(same_request(eager, ref),
          "the eager adaptive request with a recorder differs from without")
    rec_c = FlightRecorder()
    cap = AdaptiveCNF(cnf_vf, dim, fused_stages=True, capture=True,
                      obs=rec_c, **ADAPTIVE)
    check(same_request(adaptive_request(cap, cnf_theta, points[0]), eager),
          "observed adaptive request: captured differs from eager")
    cap0 = AdaptiveCNF(cnf_vf, dim, fused_stages=True, capture=True,
                       **ADAPTIVE)
    check(same_request(adaptive_request(cap0, cnf_theta, points[0]), ref),
          "unobserved adaptive request: captured differs from eager")
    # the same points without and with the recorder, A B B A on each
    stream = {"plain": [], "recorder": []}
    for p in points:
        for label in ("plain", "recorder", "recorder", "plain"):
            stream[label].append(timed_request(
                cap if label == "recorder" else cap0, cnf_theta, p)[1])
    check(same_request(adaptive_request(cap, cnf_theta, points[0]), eager),
          "observed adaptive request: captured replay differs from eager")
    stats = cap.solver.graph_stats()
    check(set(stats) == {"attempt_obs", "attempt_record_obs", "adjoint"},
          f"observed adaptive graphs {sorted(stats)}")
    rec_c.clear()
    with torch.no_grad():
        _, info_d = cap.log_prob(points[0], cnf_theta)
    n_att = info_d.n_accepted + info_d.n_rejected
    check(info_d == info and rec_c.accepted_rejected()
          == (info.n_accepted, info.n_rejected),
          f"accepted_rejected() {rec_c.accepted_rejected()} != {info}")
    e_rows = sorted(rec_e.events("adaptive.step"), key=lambda e: e.seq)
    c_rows = rec_c.adaptive_steps()
    check([e.data for e in e_rows[:n_att]] == c_rows,
          "the captured attempt log differs from the eager one")
    med = {k: float(sorted(v)[len(v) // 2]) for k, v in stream.items()}
    obs_ms = med["recorder"]
    print(f"phase 17 recorder, adaptive CNF request (one point, phase 12's "
          f"settings): eager (counted: {n} launches) and captured BITWISE "
          f"each other and the unobserved request; captured log == eager "
          f"log ({n_att} rows); accepted_rejected() {rec_c.accepted_rejected()}"
          f" = AdaptiveInfo; eager {eager_ms:.1f} ms; captured on the same "
          f"{OBS_STREAM} points, A B B A each, median without "
          f"{med['plain']:.3f} / with the recorder {obs_ms:.3f} ms "
          f"({obs_ms / med['plain']:.4f}x); across phases, phase 12's "
          f"unobserved {adaptive_res['ms']:.2f} ms; graphs "
          + ", ".join(f"{k}: pool {v[2]} B" for k, v in stats.items())
          + f" {card}", flush=True)
    out["launches"] += n
    out["expected"] += want
    out["adaptive"] = dict(n_accepted=info.n_accepted,
                           n_rejected=info.n_rejected, eager_ms=eager_ms,
                           captured_ms=obs_ms,
                           captured_plain_ms=med["plain"], stream_ms=stream,
                           phase12_ms=adaptive_res["ms"], launches=n,
                           events_per_solve=n_att)

    plan = FaultPlan([FaultSpec(*ADAPTIVE_FAULT)])
    rec_f = FlightRecorder()
    fcnf = AdaptiveCNF(cnf_vf, dim, fused_stages=True, capture=True,
                       obs=rec_f, fault_plan=plan, **ADAPTIVE)
    d_f, s_f, info_f = adaptive_request(fcnf, cnf_theta, points[0])
    d_c, s_c = eager[0], eager[1]
    scale = float(s_c.abs().max())
    # the density and the score solves took the same attempts
    poisoned = sorted({d["attempt"] for d in rec_f.adaptive_steps()
                       if not math.isfinite(d["err_norm"])})
    check(bool(torch.isfinite(d_f) and torch.isfinite(s_f).all())
          and info_f.n_rejected >= 2
          and torch.allclose(d_f, d_c, rtol=FAULT_RTOL, atol=0)
          and torch.allclose(s_f, s_c, rtol=FAULT_RTOL,
                             atol=FAULT_RTOL * scale)
          and poisoned[:2] == [2, 3],
          f"faulted adaptive request: {info_f}, density {d_f.item()} vs "
          f"{d_c.item()}, score max|diff| {max_abs(s_f, s_c)}, poisoned "
          f"attempts {poisoned}")
    print(f"phase 17 fault, adaptive CNF request captured with attempts 2-3 "
          f"poisoned (FaultSpec{ADAPTIVE_FAULT}): finite, {info_f} against "
          f"the clean {info}; density rel diff "
          f"{abs(d_f.item() - d_c.item()) / abs(d_c.item()):.3e}, score "
          f"max|diff| {max_abs(s_f, s_c):.3e} (tolerance rtol "
          f"{FAULT_RTOL}); NaN error norms at attempts {poisoned} {card}",
          flush=True)
    out["adaptive_fault"] = dict(info=list(info_f), poisoned=poisoned,
                                 density_rel=abs(d_f.item() - d_c.item())
                                 / abs(d_c.item()),
                                 score_max_abs=max_abs(s_f, s_c))

    fc = AdaptiveCNF(cnf_vf, dim, fused_stages=True, capture=True,
                     **ADAPTIVE)
    counter = FevalCounter(fc.solver.f)
    fc.solver.f = counter
    adaptive_request(fc, cnf_theta, points[0])   # captures the graphs
    counter.reset()
    with torch.no_grad():
        _, info_n = fc.log_prob(points[0], cnf_theta)
    executed, s = counter.count, DOPRI5.num_stages
    check(executed == fc.solver.replays * s
          and executed >= info_n.nfe_forward,
          f"FevalCounter {executed} != {fc.solver.replays} replays x {s}")
    print(f"phase 17 FevalCounter on the captured forward pass: {executed} f "
          f"evaluations executed ({fc.solver.replays} attempt replays x {s} "
          f"stages) against AdaptiveInfo.nfe_forward {info_n.nfe_forward}: "
          f"{executed - info_n.nfe_forward} in masked, dead attempts {card}",
          flush=True)
    out["feval"] = dict(executed=executed, replays=fc.solver.replays,
                        nfe_forward=info_n.nfe_forward)
    del eager_cnf, cap, cap0, fcnf, fc
    gc_collect()

    # -- (c) the implicit route's spill and Newton faults ---------------------
    torch.use_deterministic_algorithms(False)
    weights = torch.tensor(LOSS_W, dtype=torch.float64, device=dev)

    def rob_grad(plan=None, **kw):
        u0 = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64, device=dev,
                          requires_grad=True)
        k = torch.tensor(K_BASE, dtype=torch.float64, device=dev,
                         requires_grad=True)
        uf = odeint_implicit(
            robertson_rates, u0, k, dt=ROB_FAULT["dt"],
            n_steps=ROB_FAULT["n_steps"], method="cn", adjoint="pnode",
            offload="spill", offload_segment=ROB_FAULT["segment"],
            newton_iters=ROB_FAULT["newton_iters"],
            newton_tol=ROB_FAULT["newton_tol"],
            gmres_iters=ROB_FAULT["gmres_iters"], fault_plan=plan, **kw)
        return torch.autograd.grad(torch.sum(uf * weights), [u0, k])

    g0 = rob_grad()
    check(all(bool(torch.isfinite(g).all()) for g in g0),
          f"Robertson fault-free gradient not finite: {g0}")
    rows = {}
    for label, specs, kw, counter_key in IMPLICIT_FAULTS:
        plan, rec = FaultPlan([FaultSpec(*s) for s in specs]), FlightRecorder()
        offload.reset_spill_stats()
        t0 = time.perf_counter()
        g = rob_grad(plan, obs=rec, **kw)
        torch.cuda.synchronize()
        t_ms = (time.perf_counter() - t0) * 1e3
        if counter_key == "rescued":
            # the forward sweep's one event: the solve's rescued steps
            moved = [e.data["rescued"] for e in rec.events("implicit.rescue")]
            met = moved == [1]
        else:
            moved = offload.spill_stats()[counter_key]
            met = moved >= 1
        check(all(torch.equal(bits(a), bits(b)) for a, b in zip(g, g0))
              and met,
              f"implicit fault {label}: gradient BITWISE the fault-free "
              f"one: {all(torch.equal(a, b) for a, b in zip(g, g0))}; "
              f"{counter_key} {moved}")
        rows[label] = dict(ms=t_ms, counter=counter_key, moved=moved,
                           fired=plan.fired_count())
        print(f"phase 17 fault, Robertson CN pnode + spill: {label} "
              f"({', '.join(f'{k}={v}' for k, v in kw.items())}): gradient "
              f"BITWISE the fault-free one, {counter_key} {moved}, "
              f"{t_ms:.1f} ms {card}", flush=True)
    try:
        rob_grad(FaultPlan([FaultSpec("spill.read", 0, "flake",
                                      count=10_000)]))
    except RuntimeError as e:
        check("retries" in str(e), f"persistent flake raised {e!r}")
        print(f"phase 17 fault: a persistent spill.read flake without "
              f"resilient raises: {e}", flush=True)
    else:
        fail("a persistent spill.read flake without resilient did not raise")
    out["implicit_faults"] = rows
    gc_collect()
    return out


def checkpoint_phase(card, dev, params, batches):
    """Phase 17d: checkpoints (``repro_torch.ckpt``) of the classifier on
    the card (phase 4's seeded weights, AdamW, its 5 batches): saved after
    step ``CKPT_SAVE_AT`` through the async ``CheckpointManager`` (pinned
    snapshot on a copy stream, the commit on its own thread), restored into
    fresh tensors, steps 3-5 BITWISE the uninterrupted run's losses and
    parameters (counted); a ``ckpt.write`` preemption leaves a
    ``.tmp_step_*`` that restore ignores and the next manager removes."""
    import shutil
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.ckpt import (CheckpointManager, CheckpointWriteError,
                                  available_steps, load_checkpoint)
    from repro_torch.core.adjoint import expected_lincomb_calls
    from repro_torch.ft import FaultPlan, FaultSpec, SimulatedPreemption
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import AdamW

    torch.use_deterministic_algorithms(True)
    opt = AdamW(lr=2e-3, warmup_steps=2, total_steps=CLS["steps"])

    def train_step(p, s, xb, lb):
        loss, grads = classifier_grads(p, xb, lb, fused=True)
        with torch.no_grad():
            p, s, _ = opt.update(pytree.tree_unflatten(
                grads, pytree.tree_structure(p)), s, p)
        return p, s, loss

    ck = ROOT / "build" / "ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    mgr = CheckpointManager(ck)
    p, s, losses = params, opt.init(params), []
    ops.reset_counts()
    for k, (xb, lb) in enumerate(batches):
        p, s, loss = train_step(p, s, xb, lb)
        losses.append(loss)
        if k + 1 == CKPT_SAVE_AT:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(CKPT_SAVE_AT, {"params": p, "opt": s})
            save_ms = (time.perf_counter() - t0) * 1e3
    n, plain = ops.launches, ops.plain_calls
    want = len(batches) * expected_lincomb_calls(CLS["method"],
                                                 CLS["n_steps"], 1,
                                                 CLS["adjoint"])
    check(plain == 0 and n == want,
          f"checkpointed training: {n} launches (expected {want}), {plain} "
          "plain calls")
    t0 = time.perf_counter()
    mgr.wait()
    wait_ms = (time.perf_counter() - t0) * 1e3
    fresh = pytree.tree_map(torch.zeros_like, params)
    restored, at = mgr.restore_latest({"params": fresh,
                                       "opt": opt.init(fresh)})
    p2, s2 = restored["params"], restored["opt"]
    check(at == CKPT_SAVE_AT and s2.step == CKPT_SAVE_AT,
          f"restored step {at}, AdamW step {s2.step}")
    for k in range(CKPT_SAVE_AT, len(batches)):
        p2, s2, loss = train_step(p2, s2, *batches[k])
        check(torch.equal(bits(loss), bits(losses[k])),
              f"restored run: step {k + 1} loss {loss.item()} != "
              f"{losses[k].item()}")
    check(all(torch.equal(bits(a), bits(b)) for a, b in
              zip(pytree.tree_leaves(p2), pytree.tree_leaves(p))),
          "restored run: parameters after the last step differ")
    nbytes = sum(t.numel() * t.element_size()
                 for t in pytree.tree_leaves((p, s)) if torch.is_tensor(t))

    pre = CheckpointManager(ck, fault_plan=FaultPlan(
        [FaultSpec("ckpt.write", 0, "preempt")]))
    pre.save(len(batches), {"params": p2, "opt": s2})
    try:
        pre.wait()
    except CheckpointWriteError as e:
        check(isinstance(e.__cause__, SimulatedPreemption),
              f"preempted commit raised {e!r}")
    else:
        fail("a ckpt.write preemption did not surface at wait()")
    stale = sorted(q.name for q in ck.glob(".tmp_step_*"))
    template = {"params": fresh, "opt": opt.init(fresh)}
    check(len(stale) == 1 and available_steps(ck) == [CKPT_SAVE_AT]
          and load_checkpoint(ck, template)[1] == CKPT_SAVE_AT,
          f"after the preemption: stale {stale}, steps "
          f"{available_steps(ck)}")
    CheckpointManager(ck)
    check(not list(ck.glob(".tmp_step_*")),
          "the next manager did not remove the stale staging directory")
    print(f"phase 17 checkpoints, classifier on the card (AdamW, "
          f"{len(batches)} steps, {nbytes} B of parameters and moments): "
          f"saved after step {CKPT_SAVE_AT} by the async manager, "
          f"save() {save_ms:.3f} ms on the caller's thread, commit joined "
          f"in {wait_ms:.1f} ms at wait(); restored into fresh tensors, "
          f"steps {CKPT_SAVE_AT + 1}-{len(batches)} BITWISE the "
          f"uninterrupted run's losses and parameters ({n} launches "
          f"counted, expected {want}); a ckpt.write preemption left "
          f"{stale[0]}, ignored by restore and removed by the next manager "
          f"{card}", flush=True)
    shutil.rmtree(ck, ignore_errors=True)
    return dict(save_ms=save_ms, wait_ms=wait_ms, bytes=nbytes, launches=n,
                expected=want)


def serve_fault_phase(cfg, params, card, dev):
    """Phase 17e: serving faults at TinyLlama-1.1B's full width (phase 6's
    weights, batch 8, prompt 1920, ``SERVE_FAULT_GEN`` greedy tokens), the
    prefill counted (flash launches = ``expected_flash_calls``): a clean
    engine and one whose plan poisons lane 0's logits at decode step 0
    (``serve.decode``): lane 0's ticket errors, the other 7 lanes' tokens
    BITWISE the clean run's; then ``serve.request`` malformed and
    oversize raise ``AdmissionError``; the registry counts them."""
    import numpy as np
    import torch
    from repro_torch.ft import FaultPlan, FaultSpec
    from repro_torch.kernels import ops
    from repro_torch.models.lm import expected_flash_calls
    from repro_torch.obs import FlightRecorder, MetricsRegistry
    from repro_torch.serve import AdmissionError, LMEngine

    torch.use_deterministic_algorithms(False)  # the decode graph's writes
    lanes = LM["batch"]
    prompts = np.random.default_rng(17).integers(
        0, cfg.vocab_size, size=(lanes, LM["prompt_len"]))
    want = expected_flash_calls(cfg, 1)

    counted = [0, 0]   # flash launches measured and expected, both runs

    def run(plan):
        reg, rec = MetricsRegistry(), FlightRecorder()
        eng = LMEngine(cfg, lanes=lanes, prompt_len=LM["prompt_len"],
                       max_gen=SERVE_FAULT_GEN,
                       decode_slice=LM["decode_slice"], params=params,
                       device=dev, fault_plan=plan, registry=reg, obs=rec)
        ops.reset_counts()
        tickets = [eng.submit(p) for p in prompts]
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n, plain = ops.flash_launches, ops.flash_plain_calls
        check(plain == 0 and n == want,
              f"serve faults: {n} flash launches (expected {want}), {plain} "
              "plain calls")
        counted[0] += n
        counted[1] += want
        return eng, tickets, reg, rec, ms

    _, clean, _, _, clean_ms = run(None)
    plan = FaultPlan([FaultSpec("serve.decode", 0, "nan"),
                      FaultSpec("serve.request", lanes, "malformed"),
                      FaultSpec("serve.request", lanes + 1, "oversize")])
    eng, tickets, reg, rec, ms = run(plan)
    try:
        tickets[0].result(1.0)
    except RuntimeError as e:
        check("poisoned decode" in str(e), f"lane 0 raised {e!r}")
    else:
        fail("the poisoned lane 0 did not error")
    same = [np.array_equal(t.result(1.0), c.result(1.0))
            for t, c in zip(tickets[1:], clean[1:])]
    check(all(same), f"unpoisoned lanes differ from the clean run: {same}")
    rejected = []
    for kind in ("malformed", "oversize"):
        try:
            eng.submit(prompts[0])
        except AdmissionError as e:
            check(kind in str(e), f"serve.request {kind} raised {e!r}")
            rejected.append(kind)
        else:
            fail(f"an injected {kind} request was admitted")
    counts = {k: reg.counter(k) for k in ("serve.submitted", "serve.rejected",
                                          "serve.errors", "serve.completed")}
    check(counts == {"serve.submitted": lanes, "serve.rejected": 2,
                     "serve.errors": 1, "serve.completed": lanes - 1},
          f"serve registry {counts}")
    kinds = sorted({e.kind for e in rec.events()})
    print(f"phase 17 serve faults, {cfg.name} full width (batch {lanes}, "
          f"prompt {LM['prompt_len']}, {SERVE_FAULT_GEN} tokens; {want} "
          f"flash launches a run, counted): serve.decode nan at step 0 "
          f"errored lane 0 only, lanes 1-{lanes - 1} BITWISE the clean run; "
          f"serve.request {' and '.join(rejected)} raised AdmissionError; "
          f"registry {counts}; events {kinds}; clean {clean_ms:.1f} ms, "
          f"faulted {ms:.1f} ms (a finite-flag read each step) {card}",
          flush=True)
    return dict(clean_ms=clean_ms, faulted_ms=ms, counts=counts,
                launches=counted[0], expected=counted[1])


# ---------------------------------------------------------------------------
# phase 18: ODE serving at POWER width
# ---------------------------------------------------------------------------

# the stream: 3 of 4 density and 1 of 4 score over ``pairs`` points, then
# ``classify`` classifier requests; ``fresh`` new requests lead the second
# pass; ``solo`` requests a kind go alone through an eager bucket-1
# program (v); the split store keeps ``split_snaps`` slots in RAM
SERVE_ODE = dict(buckets=(8, 64), segment=4, pairs=64, classify=8,
                 fresh=12, solo=1, classes=10, split_snaps=80,
                 adaptive_points=16, adaptive_eager=1, max_steps=512)
SERVE_SPOOL = ROOT / "build" / "serve_spool"


def ulps(a, b):
    """Largest |a - b| in float32 units in the last place of b's largest
    magnitude (a row's, for a 2-d b)."""
    import numpy as np
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if not a.size:
        return 0.0
    top = np.abs(b).max(axis=-1, keepdims=True) if b.ndim > 1 \
        else np.abs(b).max()
    return float(np.max(np.abs(a.astype(np.float64) - b)
                        / np.spacing(top)))


def ode_serving_phase(card, dev, theta, x):
    """Phase 18: ``repro_torch.serve.ODEEngine`` at the width of phase 3
    (its weights and points: ``cnf_vf``, dim 6, hidden (64, 64, 64),
    dopri5, dt 0.1, 10 steps, unfused as the JAX engine runs it), buckets
    (8, 64), segment 4.  One stream of 72 requests (48 density, 16 score,
    8 classify) through the device tier captured (6 graphs, warmed up
    first) and eager, the spill tier and the disk tier: every result
    BITWISE the same on all four ((ii), (iii)); the stream again, 12 new
    requests first and the rest reversed, through the captured engine and
    (its scores) the spill engine: every request BITWISE its first result
    (i); the scores on the RAM/disk split with ``serve.decode`` poisoning
    the first lane: it fails alone, its batch-mates BITWISE ((ii), (iv));
    a request a kind alone through an eager bucket-1 program against its
    batched bits, and one evaluation of f and of the trace at M = 1
    against inside M = 64 ((v), printed in ulps); the adaptive engine on
    16 points, captured, BITWISE its eager run on the first.  Every
    engine's census is empty after each run; the spill engine's
    transfers a solve do not depend on its lanes; the engine's unfused
    path launches no ``fused_lincomb`` and calls no plain version
    (counted).  The eager batches are host-bound (tens of thousands of
    small kernels a batch, whatever its lanes), so the phase's time goes
    by batches, not requests."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.core.cnf import exact_trace_vf
    from repro_torch.ft import FaultPlan, FaultSpec
    from repro_torch.kernels import ops
    from repro_torch.models.ode_nets import cnf_vf
    from repro_torch.obs import FlightRecorder, MetricsRegistry
    from repro_torch.serve import BucketSpec, ODEEngine

    cfg = SERVE_ODE
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    shutil.rmtree(SERVE_SPOOL, ignore_errors=True)
    n_a = cfg["pairs"] + cfg["classify"]
    pts = x[:n_a + cfg["fresh"]].cpu().numpy()
    reqs = [("score" if i % 4 == 0 else "density", pts[i])
            for i in range(cfg["pairs"])]
    reqs += [("classify", pts[cfg["pairs"] + i])
             for i in range(cfg["classify"])]
    fresh = [("score" if i % 3 == 0 else "density", pts[n_a + i])
             for i in range(cfg["fresh"])]
    w = torch.randn(CNF["dim"], cfg["classes"],
                    generator=torch.Generator().manual_seed(18)).to(dev)
    common = dict(dim=CNF["dim"], dt=1.0 / CNF["n_steps"],
                  n_steps=CNF["n_steps"], method=CNF["method"],
                  offload_segment=cfg["segment"], head=lambda u: u @ w,
                  device=dev)
    engines = {}

    def make(name, buckets=cfg["buckets"], **kw):
        rec, reg = FlightRecorder(), MetricsRegistry()
        eng = ODEEngine(cnf_vf, theta, buckets=BucketSpec(buckets), obs=rec,
                        registry=reg, **common, **kw)
        engines[name] = (eng, rec, reg)
        return eng

    def serve(name, stream, failing=()):
        """The results of ``stream`` in order (None for a lane in
        ``failing``, which must fail), the run's batches and its wall."""
        eng, rec, _ = engines[name]
        n0 = len(rec.events("serve.batch"))
        tickets = [eng.submit(k, p) for k, p in stream]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        wall = time.perf_counter() - t0
        out = []
        for i, t in enumerate(tickets):
            if i in failing:
                try:
                    t.result(0)
                except RuntimeError as e:
                    check("non-finite" in str(e), f"{name}: lane {i}: {e}")
                    out.append(None)
                    continue
                fail(f"{name}: the poisoned request {i} did not fail")
            out.append(np.asarray(t.result(0)))
        census = eng.slot_census()
        check(not any(census.values()),
              f"{name}: slots left after the run: {census}")
        return out, [e.data for e in rec.events("serve.batch")[n0:]], wall

    def same(a, b, what):
        bad = [i for i, (p, q) in enumerate(zip(a, b))
               if p is not None and q is not None
               and not np.array_equal(p, q)]
        check(len(a) == len(b) and not bad,
              f"{what}: {len(bad)} requests differ, first {bad[:3]}, "
              f"largest {max((ulps(a[i], b[i]) for i in bad), default=0)} "
              "ulps")

    def rates(batches):
        return {f"{b['req_kind']}/{b['bucket']}": dict(
            lanes=b["lanes"], ms=b["wall_s"] * 1e3,
            per_s=b["lanes"] / b["wall_s"]) for b in batches}

    ops.reset_counts()
    # -- the device tier, captured: 6 graphs warmed up and captured --------
    t0 = time.perf_counter()
    cap = make("device captured", offload=None)
    check(cap.warmup() == len(ODEEngine.KINDS) * len(cfg["buckets"]),
          "warmup built another number of programs")
    warm_s = time.perf_counter() - t0
    graphs = cap.graph_stats()
    check(len(graphs) == 6, f"{len(graphs)} captured graphs, not 6")
    for key, (wm, cm, pool) in sorted(graphs.items()):
        print(f"phase 18 graph {key}: warm-up {wm:.1f} ms, capture "
              f"{cm:.1f} ms, pool {pool} B {card}", flush=True)
    # -- pass A through the four engines -------------------------------------
    res = {}
    tiers = {"device captured": None,
             "device eager": dict(offload=None, capture=False),
             "spill": dict(offload="spill",
                           spool_dir=str(SERVE_SPOOL / "spill")),
             "disk": dict(offload="disk",
                          spool_dir=str(SERVE_SPOOL / "disk"))}
    for name, kw in tiers.items():
        if kw is not None:
            make(name, **kw)
        res[name] = serve(name, reqs)
    ref = res["device eager"][0]
    same(res["device captured"][0], ref, "(iii) captured vs eager")
    same(res["spill"][0], ref, "(ii) spill vs the device tier")
    same(res["disk"][0], ref, "(ii) disk vs the device tier")
    for r, (k, _) in zip(ref, reqs):
        check(np.all(np.isfinite(r)), f"a non-finite {k} result")
    # -- pass B: new requests first, the rest reversed: other mates, lanes;
    # on the spill tier the scores alone (the one kind whose checkpoints
    # go through the lane-keyed store) --------------------------------------
    stream_b = fresh + reqs[::-1]
    is_score = [k == "score" for k, _ in stream_b]
    res_b = {"device captured": serve("device captured", stream_b),
             "spill": serve("spill", [r for r, sc in zip(stream_b, is_score)
                                      if sc])}
    same(res_b["device captured"][0][cfg["fresh"]:][::-1], ref,
         "(i) captured: other batch-mates and lanes")
    scores = [(k, p) for k, p in reqs if k == "score"]
    ref_scores = [r for r, (k, _) in zip(ref, reqs) if k == "score"]
    n_fresh = sum(is_score[:cfg["fresh"]])
    same(res_b["spill"][0][n_fresh:][::-1], ref_scores,
         "(i) spill: other batch-mates and lanes")
    same(res_b["spill"][0], [r for r, sc in zip(res_b["device captured"][0],
                                                is_score) if sc],
         "(ii) pass B, spill vs captured")
    # -- the RAM/disk split, serve.decode poisoning its first lane (iv) ------
    make("split, poisoned", offload="spill", snaps_in_ram=cfg["split_snaps"],
         spool_dir=str(SERVE_SPOOL / "split"),
         fault_plan=FaultPlan([FaultSpec("serve.decode", 0, "nan")]))
    res["split, poisoned"] = serve("split, poisoned", scores, failing=(0,))
    same(res["split, poisoned"][0], ref_scores,
         "(ii) split vs the device tier, (iv) the poisoned lane's mates")
    split_disk = sum(st.stats["disk_write_bytes"] for st
                     in engines["split, poisoned"][0]._stores.values())
    check(split_disk > 0, "the split store wrote nothing to disk")
    counts = {k: engines["split, poisoned"][2].counter(k)
              for k in ("serve.errors", "serve.completed")}
    check(counts == {"serve.errors": 1,
                     "serve.completed": len(scores) - 1},
          f"poisoned run's registry {counts}")
    # -- (v): a request a kind alone, eager, and f's rows at M = 1 -----------
    make("device eager, bucket 1", buckets=(1,), offload=None, capture=False)
    solo_idx = {k: [i for i, (kk, _) in enumerate(reqs) if kk == k]
                [:cfg["solo"]] for k in ODEEngine.KINDS}
    v_ulps, v_bits = {}, True
    for kind, idx in solo_idx.items():
        out, _, _ = serve("device eager, bucket 1", [reqs[i] for i in idx])
        v_ulps[kind] = max(ulps(o, ref[i]) for o, i in zip(out, idx))
        v_bits &= all(np.array_equal(o, ref[i]) for o, i in zip(out, idx))
    xb = torch.from_numpy(pts[:cfg["buckets"][-1]]).to(dev)
    aug = exact_trace_vf(cnf_vf, CNF["dim"])
    with torch.no_grad():
        fb = cnf_vf(xb, theta, 0.0)
        f1 = torch.cat([cnf_vf(xb[i:i + 1].clone(), theta, 0.0)
                        for i in range(len(xb))])
        z0 = torch.zeros(len(xb), device=dev)
        tb = aug((xb, z0), theta, 0.0)[1]
        t1 = torch.cat([aug((xb[i:i + 1].clone(), z0[i:i + 1]), theta,
                            0.0)[1] for i in range(len(xb))])
    f_rows = int((fb != f1).any(-1).sum())
    tr_rows = int((tb != t1).sum())
    f_ulps, tr_ulps = ulps(f1.cpu(), fb.cpu()), ulps(t1.cpu(), tb.cpu())
    print(f"phase 18 (v): one evaluation of f at M = 1 against inside M = "
          f"{len(xb)}: {f_rows} of {len(xb)} rows differ, largest "
          f"{f_ulps:.1f} ulps of the row's largest value; of the exact "
          f"trace: {tr_rows} rows, {tr_ulps:.1f} ulps of the largest.  "
          f"{cfg['solo']} request(s) a kind alone (eager, bucket 1) against "
          f"their batched bits: {'BITWISE' if v_bits else 'not bitwise'}, "
          f"largest difference in ulps {v_ulps} {card}", flush=True)
    # -- the spill engine's transfers a solve against its lanes -------------
    spill_scores = [b for b in res["spill"][1] + res_b["spill"][1]
                    if b["req_kind"] == "score"]
    check(len({b["callbacks"] for b in spill_scores}) == 1
          and len({b["lanes"] for b in spill_scores}) == 2,
          f"spill score batches {spill_scores}")
    per_req = sorted((b["lanes"], b["callbacks"] / b["lanes"])
                     for b in spill_scores)
    check(per_req[0][1] > per_req[1][1],
          f"transfers a request did not fall with occupancy: {per_req}")
    print(f"phase 18 spill transfers a score solve: "
          f"{spill_scores[0]['callbacks']} at {per_req[0][0]} and at "
          f"{per_req[1][0]} lanes; a request {per_req[0][1]:.4f} -> "
          f"{per_req[1][1]:.4f}", flush=True)
    # -- the adaptive path, captured against its own eager run --------------
    ada_kw = dict(offload="spill", adaptive=True, max_steps=cfg["max_steps"])
    ada_pts = [pts[i] for i in range(cfg["adaptive_points"])]
    ada_reqs = [(k, p) for k in ("density", "score") for p in ada_pts]
    t0 = time.perf_counter()
    make("adaptive captured", **ada_kw).warmup(kinds=("density", "score"))
    ada_warm_s = time.perf_counter() - t0
    res["adaptive captured"] = serve("adaptive captured", ada_reqs)
    n_e = cfg["adaptive_eager"]
    ada_eager = [(k, p) for k in ("density", "score") for p in ada_pts[:n_e]]
    make("adaptive eager", capture=False, **ada_kw)
    res["adaptive eager"] = serve("adaptive eager", ada_eager)
    n_p = cfg["adaptive_points"]
    same(res["adaptive captured"][0][:n_e]
         + res["adaptive captured"][0][n_p:n_p + n_e],
         res["adaptive eager"][0], "adaptive captured vs eager")
    ada_graphs = {k: v for k, v in engines["adaptive captured"][0]
                  .graph_stats().items()}
    # every engine of the phase, the adaptive ones included, has now run
    launches, plain = ops.launches, ops.plain_calls
    check(launches == 0 and plain == 0,
          f"the engine's unfused path: {launches} fused_lincomb launches "
          f"and {plain} plain calls, expected 0 and 0")
    # -- rates ---------------------------------------------------------------
    table = {name: rates(b) for name, (_, b, _) in res.items()}
    table_b = {f"{name}, pass B": rates(b) for name, (_, b, _)
               in res_b.items()}
    for name, rows in {**table, **table_b}.items():
        for key, r in sorted(rows.items()):
            print(f"phase 18 {name} {key}: {r['lanes']} requests in "
                  f"{r['ms']:.1f} ms, {r['per_s']:.1f} requests/s {card}")
    vs = {}
    for tier in ("spill", "disk"):
        for key, r in table[tier].items():
            vs[f"{tier} {key}"] = dict(
                vs_eager=r["ms"] / table["device eager"][key]["ms"],
                vs_captured=r["ms"] / table["device captured"][key]["ms"])
    print("phase 18 spill and disk wall / device tier (eager, captured): "
          + ", ".join(f"{k} {v['vs_eager']:.3f}, {v['vs_captured']:.3f}"
                      for k, v in sorted(vs.items())), flush=True)
    print(f"phase 18 ODE serving: {len(reqs)} requests on every tier "
          f"BITWISE the "
          f"device tier's and captured == eager; reversed with new mates "
          f"BITWISE; the poisoned lane failed alone ({counts}); split "
          f"{split_disk} B to disk; adaptive {n_p} points captured "
          f"(warm-up {ada_warm_s:.1f} s), BITWISE eager on {n_e}; device "
          f"warm-up and capture {warm_s:.1f} s; fused_lincomb launches "
          f"{launches} (expected 0) {card}", flush=True)
    torch.use_deterministic_algorithms(det)
    for eng, _, _ in engines.values():
        eng.close()
    shutil.rmtree(SERVE_SPOOL, ignore_errors=True)
    return dict(launches=launches, expected=0, plain_calls=plain,
                graphs={k: dict(zip(("warmup_ms", "capture_ms",
                                     "pool_bytes"), v))
                        for k, v in graphs.items()},
                adaptive_graphs={k: dict(zip(("warmup_ms", "capture_ms",
                                              "pool_bytes"), v))
                                 for k, v in ada_graphs.items()},
                warmup_s=warm_s, adaptive_warmup_s=ada_warm_s,
                rates=table, rates_pass_b=table_b, tier_vs_device=vs,
                v_bitwise=v_bits, v_ulps=v_ulps, f_rows_differing=f_rows,
                f_row_ulps=f_ulps, trace_rows_differing=tr_rows,
                trace_row_ulps=tr_ulps, split_disk_bytes=split_disk,
                spill_transfers_per_request=per_req)


# ---------------------------------------------------------------------------
# phase 19: LM training
# ---------------------------------------------------------------------------

# (B, H, S, dh) of RWKV6-7B's training step below: batch 4 x 2048 tokens
TRAIN_BWD_SHAPE = (4, 64, 2048, 64)
# the backward kernel's smaller cases: (B, H, S, dh, chunk, dtype); dh 16 is
# the reduced configs' head, the S not a multiple of the chunk
TRAIN_BWD_CASES = [(2, 4, 300, 16, 64, "float32"),
                   (2, 4, 300, 16, 64, "bfloat16"),
                   (1, 3, 100, 32, 32, "float32"),
                   (2, 2, 2047, 64, 64, "float32")]
# card against the CPU port: reduced configs (2 layers), fp32, TF32 off:
# (arch, attention impl, batch, sequence); TinyLlama's 600 positions are two
# 512-row blocks of the chunked custom backward, the second ragged; RWKV6's
# 300 take the chunked form (the kernels) with a ragged last chunk
TRAIN_CASES = [("tinyllama-1.1b", "chunked", 2, 600),
               ("rwkv6-7b", "naive", 2, 300)]
# AdamW of the card-vs-CPU steps: eps 1e-3 keeps the update a smooth
# function of the gradient (with 1e-8 an element whose gradient is within
# rounding of zero steps by +lr on one device and -lr on the other)
TRAIN_OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)
# card vs CPU after one step, normwise (max|diff| / max|cpu|): the loss and
# the grad norm at LM_CPU_REL_TOL; the moments m at 1e-3 and v (squares) at
# 2e-3, 4x the RWKV6 backward kernel's fp32 limit (2**-12 of max|g|); the
# params within lr * 1e-3 max|g| / eps of the update (d u / d g <= 1 / eps)
TRAIN_M_TOL, TRAIN_V_TOL = 1e-3, 2e-3
# the full-width runs through repro_torch.launch.train.train
TRAIN_LM = dict(arch="tinyllama-1.1b", batch=2, seq=4096, steps=4,
                nan_step=2)
TRAIN_RWKV = dict(arch="rwkv6-7b", n_layers=4, batch=4, seq=2048, steps=3)


@contextlib.contextmanager
def nondeterministic():
    """Deterministic algorithms off inside: the plain RWKV6 versions take a
    cumsum, which PyTorch refuses on the card under them (the comparisons
    within tolerances run there; no bitwise check does)."""
    import torch
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(det)


def rwkv6_bwd_phase(card, dev):
    """(a) The RWKV6 backward kernel against ``rwkv6_plain_vjp``, its wrong
    answers, its bits run to run, and its times at the training shape."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rwkv6_plain_vjp
    from repro_torch.kernels.rwkv6_cases import (RWKV6_BWD_TOL,
                                                 RWKV6_BWD_WRONG,
                                                 rwkv6_bwd_ratio,
                                                 rwkv6_vjp_chunked)
    gen = torch.Generator(dev).manual_seed(19)
    b, h, s, dh = TRAIN_BWD_SHAPE
    cases = [(*c[:5], getattr(torch, c[5])) for c in TRAIN_BWD_CASES]
    cases.append((b, h, s, dh, 64, torch.bfloat16))
    ratio, worst, margins = 0.0, 0.0, {w: math.inf for w in RWKV6_BWD_WRONG}
    for cb, ch, cs, cdh, c, dtype in cases:
        a = rwkv6_bshd(cb, cs, ch, cdh, dtype, gen)
        dy = torch.randn(a[0].shape, generator=gen, device=dev)
        got = ops.rwkv6_chunked_bwd_fp32(*a, dy, chunk=c)
        again = ops.rwkv6_chunked_bwd_fp32(*a, dy, chunk=c)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"the RWKV6 backward kernel gave other bits on a second call "
              f"at {(cb, ch, cs, cdh, c)}")
        check(all(g.dtype == t.dtype and g.shape == t.shape
                  for g, t in zip(got, a)), "backward dtypes or shapes")
        with nondeterministic():
            plain = rwkv6_plain_vjp(*a, dy, chunk=c)
            r = rwkv6_bwd_ratio(got, plain)
            for w in RWKV6_BWD_WRONG:
                margins[w] = min(margins[w], rwkv6_bwd_ratio(
                    rwkv6_vjp_chunked(*a, dy, chunk=c, wrong=w), plain))
        ratio = max(ratio, r)
        worst = max(worst, max(max_abs(x, y) for x, y in zip(got, plain)))
        check(r <= 1.0, f"the RWKV6 backward kernel exceeds its limits "
              f"{RWKV6_BWD_TOL} at {(cb, ch, cs, cdh, c, str(dtype))}: "
              f"ratio {r}")
        del a, dy, got, again, plain
    check(all(m > WRONG_MARGIN for m in margins.values()),
          f"a wrong RWKV6 gradient within {WRONG_MARGIN}x of the limits: "
          f"{margins}")
    print(f"phase 19a rwkv6_chunked_bwd_fp32 vs rwkv6_plain_vjp over "
          f"{len(cases)} cases (dh 16/32/64, chunk 32/64, ragged S, fp32 and "
          f"bf16 r/k/v, the training shape {TRAIN_BWD_SHAPE} last): worst "
          f"ratio to the limit {ratio:.4f} (limits {RWKV6_BWD_TOL}), "
          f"max|diff| {worst:.3e}; BITWISE on a second call; wrong answers' "
          f"margins {margins} {card}", flush=True)

    c = 64
    a = rwkv6_bshd(b, s, h, dh, torch.bfloat16, gen)
    dy = torch.randn(a[0].shape, generator=gen, device=dev)
    n = a[0].numel()
    chunks = b * h * (-(-s // c))
    # per chunk: the state recomputation k_out^T v, dq_in, dk_out, the two
    # products of dv and q_in^T dy (C dh^2 MACs each); A, dA, dq_mid,
    # dk_mid and A^T dy over the strictly lower triangle (C(C-1)/2 dh MACs
    # each)
    flops = chunks * (10 * c * dh * dh + 5 * c * (c - 1) * dh)
    # read bf16 r, k, v and fp32 logw, dy; write bf16 dr, dk, dv and fp32
    # dlogw; u read and du written once
    nbytes = n * (3 * 2 + 2 * 4) + n * (3 * 2 + 4) + 2 * h * dh * 4
    ops_ms = flops / FP32_FLOP_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    kern = lambda: ops.rwkv6_chunked_bwd_fp32(*a, dy, chunk=c)  # noqa: E731

    def plain():
        with nondeterministic():
            return rwkv6_plain_vjp(*a, dy, chunk=c)

    row = dict(shape=[b, s, h, dh], chunk=c,
               dtype="bfloat16 r/k/v and dr/dk/dv, float32 logw/u/dy/dlogw/du",
               flops=flops, bytes=nbytes, bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               ops_ms_fp32=ops_ms, bytes_ms=bytes_ms,
               call_ms=time_ms(kern, 10, 2), plain_call_ms=time_ms(plain, 2, 1))
    row["ms"] = device_ms(kern, iters=5)
    row["plain_ms"] = device_ms(plain, iters=2)
    row["x_bound"] = row["ms"] / row["bound_ms"]
    print(f"  rwkv6_chunked_bwd_fp32 {(b, s, h, dh)} chunk {c}, bf16 r/k/v: "
          f"kernel {row['ms']:.4f} ms (call {row['call_ms']:.4f})  plain "
          f"{row['plain_ms']:.4f} ms (call {row['plain_call_ms']:.4f})  bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {flops:.4e} FLOP at "
          f"{FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s = {ops_ms:.4f} ms; {nbytes} "
          f"B at 3.35 TB/s = {bytes_ms:.4f} ms), {row['x_bound']:.2f}x the "
          f"bound; library: none {card}", flush=True)
    del a, dy
    gc_collect()
    return dict(worst=worst, ratio=ratio, margins=margins, row=row,
                cases=len(cases))


def train_agreement_phase(card, dev):
    """(b) One ``make_train_step`` step of reduced TinyLlama (the chunked
    custom backward) and RWKV6-7B (the RWKV6 kernels) on the card against
    the port on the CPU, from the same parameters and tokens, and the
    four depth remat policies' gradients BITWISE equal on the card."""
    import dataclasses

    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamW

    out = {}
    for arch, impl, b, s in TRAIN_CASES:
        cfg = reduced(get_arch(arch), n_layers=2, attn_impl=impl)
        cpu_p = lm.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        card_p = pytree.tree_map(lambda t: t.to(dev), cpu_p)
        toks = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (b, s)).astype(np.int32))
        cpu_b = {"tokens": toks, "targets": toks}
        card_b = {k: v.to(dev) for k, v in cpu_b.items()}
        opt = AdamW(**TRAIN_OPT)
        step = make_train_step(cfg, opt)
        p_cpu, s_cpu, m_cpu = step(cpu_p, opt.init(cpu_p), cpu_b, 0)
        ops.reset_counts()
        p_card, s_card, m_card = step(card_p, opt.init(card_p), card_b, 0)
        torch.cuda.synchronize()
        counts = (ops.rwkv6_launches, ops.rwkv6_bwd_launches,
                  ops.rwkv6_plain_calls, ops.rwkv6_bwd_plain_calls)
        fwd, bwd = lm.expected_rwkv6_train_calls(cfg, s, cfg.remat)
        check(counts == (fwd, bwd, 0, 0),
              f"{arch} train step on the card: RWKV6 (forward, backward) "
              f"launches and plain calls {counts}, expected ({fwd}, {bwd}, "
              "0, 0)")
        rel = {k: abs(float(m_card[k]) - float(m_cpu[k]))
               / abs(float(m_cpu[k])) for k in ("loss", "grad_norm")}
        m_err = max(rel_err(a.cpu(), c) for a, c in
                    zip(pytree.tree_leaves(s_card.m),
                        pytree.tree_leaves(s_cpu.m)))
        v_err = max(rel_err(a.cpu(), c) for a, c in
                    zip(pytree.tree_leaves(s_card.v),
                        pytree.tree_leaves(s_cpu.v)))
        p_ratio = 0.0
        for pa, pc, mc in zip(pytree.tree_leaves(p_card),
                              pytree.tree_leaves(p_cpu),
                              pytree.tree_leaves(s_cpu.m)):
            g_max = float(mc.abs().max()) / (1 - opt.b1)
            bound = opt.lr * TRAIN_M_TOL * g_max / opt.eps + 1e-7
            p_ratio = max(p_ratio, max_abs(pa.cpu(), pc) / bound)
        check(rel["loss"] <= LM_CPU_REL_TOL
              and rel["grad_norm"] <= LM_CPU_REL_TOL
              and m_err <= TRAIN_M_TOL and v_err <= TRAIN_V_TOL
              and p_ratio <= 1.0,
              f"{arch} train step, card vs CPU: loss and grad norm rel "
              f"{rel} (tolerance {LM_CPU_REL_TOL}), moments m {m_err} "
              f"(tolerance {TRAIN_M_TOL}), v {v_err} ({TRAIN_V_TOL}), params "
              f"{p_ratio} of their bound")
        # the depth remat policies on the card: BITWISE the same gradients
        grads = {}
        for remat, ncheck in (("none", None), ("full", None),
                              ("sqrt", None), ("revolve", 1)):
            c2 = dataclasses.replace(cfg, remat=remat, ncheck=ncheck)
            loss, _, g = value_and_grad(c2, card_p, card_b)
            grads[remat] = [loss] + pytree.tree_leaves(g)
        for remat, leaves in grads.items():
            check(all(torch.equal(bits(x), bits(y)) for x, y in
                      zip(leaves, grads["none"])),
                  f"{arch}: remat={remat!r} gradients differ from 'none' on "
                  "the card")
        out[arch] = dict(loss_card=float(m_card["loss"]),
                         loss_cpu=float(m_cpu["loss"]), rel=rel, m_err=m_err,
                         v_err=v_err, param_ratio=p_ratio, launches=counts[:2],
                         expected=(fwd, bwd))
        print(f"phase 19b {arch} reduced (2 layers, fp32, {impl}, batch {b} x "
              f"{s}): card vs CPU loss {float(m_card['loss']):.7f} vs "
              f"{float(m_cpu['loss']):.7f}, rel {rel}, moments m {m_err:.3e} "
              f"v {v_err:.3e}, params {p_ratio:.3e} of their bound; RWKV6 "
              f"launches (forward, backward) {counts[:2]} (expected "
              f"{(fwd, bwd)}); none/full/sqrt/revolve(1) gradients BITWISE "
              f"equal on the card {card}", flush=True)
        del cpu_p, card_p, p_cpu, p_card, s_cpu, s_card, grads
        gc_collect()
    return out


def train_records(path):
    from repro_torch.obs import read_jsonl
    recs = read_jsonl(str(path))
    steps = [r for r in recs if r["event"] == "train.step"]
    peak = next(r["measured_peak_bytes"] for r in recs
                if r["event"] == "train.compile")
    return steps, peak


def traced_train_step(cfg, spec, kernel, card, dev):
    """Where a train step's time goes: one traced ``make_train_step`` step
    (the loop's, sentinel on) on fresh weights, after a warm-up step."""
    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamW

    cell = ShapeCell("train", spec["seq"], spec["batch"], "train")
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(1),
                            device=dev)
    opt = AdamW(total_steps=spec["steps"])
    state = opt.init(params)
    batch = {k: v.to(dev) for k, v in SyntheticLM(cfg, cell).batch(0).items()}
    step = make_train_step(cfg, opt, sentinel=True)
    step(params, state, batch, 0)
    res = traced(f"{cfg.name} train step ({spec['batch']} x {spec['seq']})",
                 lambda: step(params, state, batch, 0), kernel, card)
    del params, state
    gc_collect()
    return res


def lm_training_phase(card, dev):
    """(c) TinyLlama-1.1B at full config (22 layers, bf16) and (d)
    RWKV6-7B at full width with 4 of 32 layers, through
    ``repro_torch.launch.train.train``."""
    import dataclasses
    import tempfile

    from torch.utils import _pytree as pytree
    from repro_torch.configs.base import ShapeCell
    from repro_torch.configs.registry import get_arch
    from repro_torch.ft import FaultPlan, FaultSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.mem.model import tree_bytes
    from repro_torch.models import lm
    from repro_torch.obs import MetricsSink

    def run(cfg, spec, ckpt=False, **kw):
        cell = ShapeCell("train", spec["seq"], spec["batch"], "train")
        with tempfile.TemporaryDirectory() as tmp:
            sink = MetricsSink(f"{tmp}/metrics.jsonl")
            if ckpt:
                kw["ckpt_dir"] = f"{tmp}/ckpt"
            t0 = time.time()
            try:
                res = train(cfg, cell, steps=spec["steps"], sink=sink,
                            device=dev, log_every=1,
                            log_fn=lambda m: print("  " + m, flush=True),
                            **kw)
            finally:
                sink.close()
            wall = time.time() - t0
            steps, peak = train_records(f"{tmp}/metrics.jsonl")
        tokens = spec["batch"] * spec["seq"]
        step_ms = [r["step_ms"] for r in steps]
        n = sum(t.numel() for t in pytree.tree_leaves(res["params"]))
        row = dict(losses=res["losses"], step_ms=step_ms,
                   tok_per_s=[tokens / (ms / 1e3) for ms in step_ms],
                   peak_bytes=peak, param_bytes=tree_bytes(res["params"]),
                   moment_bytes=8 * n, params=n, wall_s=wall,
                   skipped=res["skipped_steps"])
        check(all(math.isfinite(x) for x in res["losses"])
              and len(res["losses"]) == spec["steps"],
              f"{cfg.name} training: losses {res['losses']}")
        del res
        gc_collect()
        return row

    # (c) TinyLlama-1.1B: attn_impl "auto" takes the chunked custom
    # backward at 4096 positions; remat "sqrt" (the config's)
    cfg = get_arch(TRAIN_LM["arch"])
    check(cfg.remat == "sqrt" and cfg.attn_impl == "auto",
          "TinyLlama's config: remat and attention")
    clean = run(cfg, TRAIN_LM, ckpt=True)
    faulted = run(cfg, TRAIN_LM, ckpt=True, fault_plan=FaultPlan(
        [FaultSpec("train.step", TRAIN_LM["nan_step"], "nan")]))
    check(faulted["skipped"] == 1 and faulted["losses"] == clean["losses"],
          f"TinyLlama with step {TRAIN_LM['nan_step']} poisoned: "
          f"{faulted['skipped']} skipped, committed losses "
          f"{faulted['losses']} against the clean {clean['losses']}")
    clean["trace"] = traced_train_step(cfg, TRAIN_LM, "gemm", card, dev)
    for i, (ms, tps) in enumerate(zip(clean["step_ms"], clean["tok_per_s"])):
        print(f"phase 19c TinyLlama-1.1B train step {i}: loss "
              f"{clean['losses'][i]:.6f}  {ms:.1f} ms  {tps:.1f} tokens/s "
              f"{card}")
    print(f"phase 19c TinyLlama-1.1B ({cfg.n_layers} layers, "
          f"{cfg.param_dtype}, batch {TRAIN_LM['batch']} x "
          f"{TRAIN_LM['seq']}, remat {cfg.remat}, attention "
          f"{cfg.attn_impl}): peak allocated {clean['peak_bytes']} B over "
          f"the first step (params {clean['param_bytes']} B, moments "
          f"{clean['moment_bytes']} B); wall {clean['wall_s']:.1f} s with the "
          f"checkpoint; with step {TRAIN_LM['nan_step']} poisoned: 1 step "
          f"skipped, committed losses BITWISE the clean run's "
          f"({faulted['wall_s']:.1f} s) {card}", flush=True)

    # (d) RWKV6-7B at full width, 4 of 32 layers: 32 layers' fp32 AdamW
    # moments (61 GB), bf16 params and bf16 gradients (15 GB each) exceed
    # the card's 80 GB
    base = get_arch(TRAIN_RWKV["arch"])
    cfg = dataclasses.replace(base, n_layers=TRAIN_RWKV["n_layers"],
                              layer_kinds=("w",) * TRAIN_RWKV["n_layers"])
    check(cfg.remat == "sqrt", "RWKV6-7B's remat")
    fwd, bwd = lm.expected_rwkv6_train_calls(cfg, TRAIN_RWKV["seq"],
                                             cfg.remat)
    ops.reset_counts()
    rw = run(cfg, TRAIN_RWKV)
    launches = (ops.rwkv6_launches, ops.rwkv6_bwd_launches)
    plain = (ops.rwkv6_plain_calls, ops.rwkv6_bwd_plain_calls)
    expected = (fwd * TRAIN_RWKV["steps"], bwd * TRAIN_RWKV["steps"])
    check(launches == expected and launches[1] > 0 and plain == (0, 0),
          f"RWKV6-7B training: RWKV6 (forward, backward) launches "
          f"{launches}, expected {expected}; plain calls {plain}")
    rw["trace"] = traced_train_step(cfg, TRAIN_RWKV, "rwkv6_chunked", card,
                                    dev)
    for i, (ms, tps) in enumerate(zip(rw["step_ms"], rw["tok_per_s"])):
        print(f"phase 19d RWKV6-7B (4 layers) train step {i}: loss "
              f"{rw['losses'][i]:.6f}  {ms:.1f} ms  {tps:.1f} tokens/s {card}")
    print(f"phase 19d RWKV6-7B full width, {TRAIN_RWKV['n_layers']} of 32 "
          f"layers ({rw['params']} params, bf16), batch {TRAIN_RWKV['batch']}"
          f" x {TRAIN_RWKV['seq']}, remat sqrt: RWKV6 launches (forward, "
          f"backward) {launches} (expected {expected}); peak allocated "
          f"{rw['peak_bytes']} B over the first step (params "
          f"{rw['param_bytes']} B, moments {rw['moment_bytes']} B) {card}",
          flush=True)
    return dict(tinyllama=dict(clean, faulted_losses_bitwise=True),
                rwkv6=dict(rw, launches=launches, expected=expected))


def training_phase(card, dev):
    """Phase 19: the backward kernel, card against CPU, the full-width
    runs.  Deterministic algorithms on for all of it (the bitwise remat
    and fault checks need them)."""
    import torch
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        kernel = rwkv6_bwd_phase(card, dev)
        agreement = train_agreement_phase(card, dev)
        runs = lm_training_phase(card, dev)
    finally:
        torch.use_deterministic_algorithms(False)
    return dict(kernel=kernel, agreement=agreement, runs=runs)


def gc_collect():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main():
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "the root of a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import dataclasses
    import gc
    from torch.utils import _pytree as pytree
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.adjoint import expected_lincomb_calls
    from repro_torch.examples.image_classification import synthetic_cifar
    from repro_torch.kernels import _build, ops
    from repro_torch.models.lm import (expected_flash_calls,
                                       expected_rwkv6_calls)
    from repro_torch.models.ode_nets import classifier_init, cnf_vf_init
    from repro_torch.optim.adamw import AdamW

    t_start = time.time()
    phase_s = {}
    t_lap = [t_start]

    def lap(label):
        # wall seconds since the previous lap, printed and kept
        now = time.time()
        phase_s[label] = round(now - t_lap[0], 1)
        t_lap[0] = now
        print(f"phase {label}: {phase_s[label]} s", flush=True)

    # -- phase 1 -------------------------------------------------------------
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    card = f"[{smi}]"
    print(f"device: {smi} | torch.cuda.get_device_name: {name} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"devices {torch.cuda.device_count()}", flush=True)
    t0 = time.time()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.time() - t0:.1f} s into "
          f"{_build.build_dir().relative_to(ROOT)}", flush=True)
    for stem in libs:
        log = (_build.build_dir() / f"{stem}.log")
        if log.exists():
            fn = ""
            for line in log.read_text().splitlines():
                if "Compiling entry function" in line:
                    fn = line.split("'")[1][-60:]  # the template arguments
                elif "registers" in line or "spill" in line:
                    print(f"  ptxas {stem} ...{fn}: {line.strip()}")

    # -- phase 2 -------------------------------------------------------------
    lap("1 build")
    worst, timing_rows = kernel_phase(card)
    lap("2 fused_lincomb")

    # -- set-up of phases 3-4 (weights and data from seeds) -------------------
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cnf_theta = cnf_vf_init(gen, CNF["dim"], hidden=CNF["hidden"], device=dev)
    x = torch.randn(CNF["batch"], CNF["dim"], generator=gen).to(dev)
    cls_params = classifier_init(gen, channels=CLS["channels"], device=dev)
    rs = np.random.RandomState(0)
    templates = rs.randn(10, 8, 8, 3)
    batches = [synthetic_cifar(rs, templates, CLS["batch"], CLS["image_size"])
               for _ in range(CLS["steps"])]
    batches = [(torch.from_numpy(xb).to(dev), torch.from_numpy(lb).to(dev))
               for xb, lb in batches]
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    torch.cuda.synchronize()

    # -- phases 3-4: the main path, counted ----------------------------------
    ops.reset_counts()
    cnf_ms = []
    for _ in range(2):  # the first call pays CUDA/cuBLAS/torch.func set-up
        torch.cuda.synchronize()
        t0 = time.time()
        density, score = cnf_requests(cnf_theta, x, fused=True)
        torch.cuda.synchronize()
        cnf_ms.append((time.time() - t0) * 1e3)
    cnf_launches = ops.launches

    opt = AdamW(lr=2e-3, warmup_steps=2, total_steps=CLS["steps"])
    state = opt.init(cls_params)
    params = cls_params
    losses, step_ms, grads0 = [], [], None
    torch.cuda.reset_peak_memory_stats()
    for step, (xb, lb) in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.time()
        loss, grads = classifier_grads(params, xb, lb, fused=True)
        if step == 0:
            grads0 = grads
        with torch.no_grad():
            params, state, _ = opt.update(
                pytree.tree_unflatten(grads, pytree.tree_structure(params)),
                state, params)
        torch.cuda.synchronize()
        step_ms.append((time.time() - t0) * 1e3)
        losses.append(loss.item())
    peak_bytes = torch.cuda.max_memory_allocated()
    total_launches = ops.launches
    cls_launches = total_launches - cnf_launches
    plain_on_path = ops.plain_calls

    # -- checks on the main path's results ------------------------------------
    check(plain_on_path == 0, f"{plain_on_path} plain lincomb calls on the "
          "card path: the main path must launch the kernel")
    exp_cnf = 2 * (expected_lincomb_calls(CNF["method"], CNF["n_steps"], 2,
                                          CNF["adjoint"], backward=False)
                   + expected_lincomb_calls(CNF["method"], CNF["n_steps"], 2,
                                            CNF["adjoint"]))
    exp_cls = CLS["steps"] * expected_lincomb_calls(
        CLS["method"], CLS["n_steps"], 1, CLS["adjoint"])
    print(f"fused_lincomb launches: CNF {cnf_launches} (expected {exp_cnf}), "
          f"classifier {cls_launches} (expected {exp_cls})", flush=True)
    check(cnf_launches > 0 and cnf_launches == exp_cnf,
          f"CNF launches {cnf_launches} != expected {exp_cnf}")
    check(cls_launches > 0 and cls_launches == exp_cls,
          f"classifier launches {cls_launches} != expected {exp_cls}")

    check(density.shape == (CNF["batch"],) and score.shape == x.shape,
          "CNF output shapes")
    check(bool(torch.isfinite(density).all() and torch.isfinite(score).all()),
          "CNF density/score not finite")
    print(f"CNF POWER width: batch {CNF['batch']}, dopri5 N_t=10, pnode, "
          f"fused: density+score {cnf_ms[1]:.1f} ms (host clock; first "
          f"call {cnf_ms[0]:.1f} ms), mean log p {density.mean().item():.6f}, "
          f"|score| mean {score.abs().mean().item():.6f} {card}", flush=True)

    d_unf, s_unf = cnf_requests(cnf_theta, x, fused=False)
    check(torch.equal(bits(density), bits(d_unf))
          and torch.equal(bits(score), bits(s_unf)),
          "CNF fused and unfused results differ on the card: max|diff| "
          f"{max_abs(density, d_unf)}, {max_abs(score, s_unf)}")
    print("CNF fused == unfused bitwise on the card (density and score)")

    cpu_theta = pytree.tree_map(lambda t: t.cpu(), cnf_theta)
    d_cpu, s_cpu = cnf_requests(cpu_theta, x[:256].cpu(), fused=True)
    d_err, s_err = max_abs(density[:256].cpu(), d_cpu), \
        max_abs(score[:256].cpu(), s_cpu)
    check(torch.allclose(density[:256].cpu(), d_cpu, **CNF_TOL)
          and torch.allclose(score[:256].cpu(), s_cpu, **CNF_TOL),
          f"CNF card vs CPU beyond {CNF_TOL}: density {d_err}, score {s_err}")
    print(f"CNF card vs CPU port on 256 points: max|diff| density {d_err:.3e}"
          f", score {s_err:.3e} (tolerance {CNF_TOL}, fp32, TF32 off)")

    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    for i, (v, ms) in enumerate(zip(losses, step_ms)):
        print(f"classifier step {i}: loss {v:.6f}  {ms:.1f} ms/step "
              f"{card}")
    print(f"classifier: {np.median(step_ms[1:]):.1f} ms/step median of steps "
          f"1-{CLS['steps'] - 1}, peak allocated {peak_bytes} B "
          f"({peak_bytes / 2**30:.3f} GiB) {card}", flush=True)

    xb, lb = batches[0]
    loss_u, grads_u = classifier_grads(cls_params, xb, lb, fused=False)
    loss_f, _ = classifier_grads(cls_params, xb, lb, fused=True)
    check(all(torch.equal(bits(a), bits(b)) for a, b in zip(grads0, grads_u))
          and torch.equal(bits(loss_u), bits(loss_f)),
          "classifier fused and unfused step-0 gradients differ on the card")
    print("classifier step-0 fused == unfused gradients bitwise on the card "
          "(deterministic algorithms, cuDNN deterministic)")

    xs, ls = xb[:4], lb[:4]
    loss_g, grads_g = classifier_grads(cls_params, xs, ls, fused=True)
    cpu_params = pytree.tree_map(lambda t: t.cpu(), cls_params)
    loss_c, grads_c = classifier_grads(cpu_params, xs.cpu(), ls.cpu(),
                                       fused=True)
    rel = max(max_abs(a.cpu(), b) / max(float(b.abs().max()), 1e-12)
              for a, b in zip(grads_g, grads_c))
    check(abs(loss_g.item() - loss_c.item()) <= CLS_LOSS_RTOL
          * abs(loss_c.item()) and rel <= CLS_GRAD_TOL,
          f"classifier card vs CPU on 4 images: loss {loss_g.item()} vs "
          f"{loss_c.item()}, worst grad max|diff|/max|g| {rel}")
    print(f"classifier card vs CPU port on 4 images: loss {loss_g.item():.8f} "
          f"vs {loss_c.item():.8f}, worst per-leaf max|diff|/max|g| "
          f"{rel:.3e} (tolerance loss rtol {CLS_LOSS_RTOL}, grads "
          f"{CLS_GRAD_TOL}, fp32, TF32 off)")

    # -- where the time goes: one traced request and one traced step ---------
    def step():
        loss, grads = classifier_grads(cls_params, xb, lb, fused=True)
        with torch.no_grad():
            opt.update(pytree.tree_unflatten(
                grads, pytree.tree_structure(cls_params)), state, cls_params)

    eager_traces = {
        "cnf": traced("CNF density+score requests, eager",
                      lambda: cnf_requests(cnf_theta, x, fused=True),
                      "lincomb_kernel", card),
        "classifier": traced("classifier training step, eager", step,
                             "lincomb_kernel", card)}

    # -- phases 3b-4b: the same computations captured -------------------------
    graphs = graph_ode_phase(
        card, cnf_theta, x, dict(out=(density, score), ms=cnf_ms[1]),
        cls_params, batches, dict(grads0=grads0, losses=losses,
                                  ms=float(np.median(step_ms[1:]))),
        AdamW(lr=2e-3, warmup_steps=2, total_steps=CLS["steps"]))
    gc.collect()
    torch.cuda.empty_cache()

    lap("3-4 CNF and classifier")

    # -- phase 5: the flash kernel ------------------------------------------
    torch.use_deterministic_algorithms(False)  # the LM phases hold tolerances
    fl = flash_phase(card, dev)
    lap("5 flash")

    # -- phase 6: LM serving at full width, counted ---------------------------
    lm_cfg = dataclasses.replace(get_arch(LM["arch"]), attn_impl="pallas")
    lm_params, lm_res = serve_phase(
        lm_cfg, LM, "flash_fwd_kernel",
        lambda: (ops.flash_launches, ops.flash_plain_calls),
        expected_flash_calls(lm_cfg, 1), card, dev)

    lm_res["eager_vs_captured"] = eager_decode_phase(lm_cfg, lm_params, LM,
                                                     lm_res, card, dev)

    lap("6 TinyLlama serving")

    # -- phase 7: agreement ---------------------------------------------------
    lm_agreement_phase(lm_cfg, lm_params, card, dev)
    lap("7 LM agreement")

    # -- phase 17e: serving faults, while TinyLlama's weights are here -------
    faults = {"serve": serve_fault_phase(lm_cfg, lm_params, card, dev)}
    lap("17e serve faults")

    # -- phase 8: the RWKV6 kernel -------------------------------------------
    rw = rwkv6_phase(card, dev)
    lap("8 RWKV6 kernel")

    # -- phase 9: RWKV6-7B serving at full width, counted ---------------------
    # TinyLlama's weights and states go first: RWKV6-7B holds 15 GB
    del lm_params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rw_cfg = get_arch(RWKV["arch"])
    rw_params, rw_res = serve_phase(
        rw_cfg, RWKV, "rwkv6_chunked_kernel",
        lambda: (ops.rwkv6_launches, ops.rwkv6_plain_calls),
        expected_rwkv6_calls(rw_cfg, RWKV["prompt_len"], 1), card, dev)
    check(rw_res["expected"] == rw_cfg.n_layers == 32,
          f"expected_rwkv6_calls gives {rw_res['expected']}, not one a layer")
    rw_res["eager_vs_captured"] = eager_decode_phase(rw_cfg, rw_params, RWKV,
                                                     rw_res, card, dev)
    del rw_params
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 10: RWKV6 agreement --------------------------------------------
    lap("9 RWKV6-7B serving")
    rwkv_agreement_phase(card, dev)
    lap("10 RWKV6 agreement")

    # -- phase 12: the adaptive CNF request at POWER width, counted ----------
    adaptive_point = adaptive_point_phase(card, dev, cnf_theta, x)
    lap("12a adaptive CNF request")
    adaptive = adaptive_batched_phase(card, dev, cnf_theta, x)
    lap("12b adaptive CNF batched")
    scaled_rows = lincomb_scaled_rows(card, dev)
    lap("12c scaled form")

    # -- phase 13: the stiff Robertson example, fp64 -------------------------
    robertson = robertson_phase(card, dev)
    lap("13 Robertson")

    # -- phase 14: the stiff ensemble, in-device -------------------------------
    ensemble = ensemble_phase(card, dev)
    lap("14 stiff ensemble")

    # -- phase 15: the memory planner at the classifier's width, counted ------
    planner = planner_phase(card, dev, cls_params, *batches[0])
    lap("15 memory planner")

    # -- phase 16: the offload tiers at the classifier's width, counted -------
    offloaded = offload_phase(card, dev, cls_params, *batches[0], cnf_theta,
                              x, planner.pop("robertson_cn"))
    lap("16 offload tiers")

    # -- phase 17: the flight recorder, fault injection and checkpoints -------
    faults.update(recorder_phase(card, dev, cls_params, *batches[0],
                                 cnf_theta, x, adaptive_point))
    faults["checkpoint"] = checkpoint_phase(card, dev, cls_params, batches)
    lap("17 recorder, faults, checkpoints")

    # -- phase 18: ODE serving at POWER width, counted ------------------------
    serving = ode_serving_phase(card, dev, cnf_theta, x)
    lap("18 ODE serving")

    # -- phase 19: LM training, counted ---------------------------------------
    gc_collect()
    training = training_phase(card, dev)
    lap("19 LM training")

    # -- phase 11: the kernels line, the card, the result --------------------
    main_row = timing_rows[0]
    kernels = [{
        "name": "fused_lincomb",
        "route": "cuda",
        "source": "src/repro_torch/csrc/lincomb.cu",
        "replaces": "src/repro/kernels/ops.py:71",
        "launches": total_launches + adaptive_point["launches"]
        + adaptive["launches"] + planner["launches"]
        + offloaded["launches"] + faults["launches"]
        + faults["checkpoint"]["launches"] + serving["launches"],
        "expected_launches": exp_cnf + exp_cls + adaptive_point["expected"]
        + adaptive["expected"] + planner["expected"]
        + offloaded["expected"] + faults["expected"]
        + faults["checkpoint"]["expected"] + serving["expected"],
        "launches_cnf": cnf_launches,
        "launches_classifier": cls_launches,
        "launches_adaptive_request": adaptive_point["launches"],
        "expected_launches_adaptive_request": adaptive_point["expected"],
        "launches_adaptive_batched": adaptive["launches"],
        "expected_launches_adaptive_batched": adaptive["expected"],
        "launches_planner": planner["launches"],
        "expected_launches_planner": planner["expected"],
        "launches_offload": offloaded["launches"],
        "expected_launches_offload": offloaded["expected"],
        "launches_recorder_faults": faults["launches"],
        "expected_launches_recorder_faults": faults["expected"],
        "launches_checkpoint": faults["checkpoint"]["launches"],
        "expected_launches_checkpoint": faults["checkpoint"]["expected"],
        "launches_ode_serving": serving["launches"],
        "expected_launches_ode_serving": serving["expected"],
        "max_abs_err": worst,
        "ms": main_row["ms"],
        "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "call_ms": main_row["call_ms"],
        "plain_call_ms": main_row["plain_call_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "timed_case": {k: main_row[k] for k in ("shape", "n_terms", "form",
                                                "dtype", "bytes")},
        "eager_traces": eager_traces,
        "captured": graphs,
        "scaled_form": scaled_rows,
        "adaptive_request": adaptive_point,
        "adaptive_batched": adaptive,
        "robertson": robertson,
        "stiff_ensemble": ensemble,
        "memory_planner": planner,
        "offload": offloaded,
        "recorder_faults_checkpoints": faults,
        "ode_serving": serving,
        "card": smi,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:91",
        "design": "wgmma",
        "launches": lm_res["launches"] + faults["serve"]["launches"],
        "expected_launches": lm_res["expected"]
        + faults["serve"]["expected"],
        "launches_serve_faults": faults["serve"]["launches"],
        "expected_launches_serve_faults": faults["serve"]["expected"],
        "max_abs_err": max(fl["worst"].values()),
        "max_abs_err_fp32": fl["worst"]["float32"],
        "max_abs_err_bf16": fl["worst"]["bfloat16"],
        "limit_ratios": fl["ratios"],
        "wrong_answer_margins": fl["margins"],
        "ms": fl["rows"]["bfloat16"]["ms"],
        "kernel_ms": fl["rows"]["bfloat16"]["ms"],
        "plain_ms": fl["rows"]["bfloat16"]["plain_ms"],
        "call_ms": fl["rows"]["bfloat16"]["call_ms"],
        "plain_call_ms": fl["rows"]["bfloat16"]["plain_call_ms"],
        "bound_ms": fl["rows"]["bfloat16"]["bound_ms"],
        "bound_by": fl["rows"]["bfloat16"]["bound_by"],
        "x_bound": fl["rows"]["bfloat16"]["x_bound"],
        "library_ms": fl["rows"]["bfloat16"]["library_ms"],
        "library_call_ms": fl["rows"]["bfloat16"]["library_call_ms"],
        "x_library": fl["rows"]["bfloat16"]["x_library"],
        "library": "torch.nn.functional.scaled_dot_product_attention("
                   "is_causal=True, enable_gqa=True), bf16",
        "fp32": {k: fl["rows"]["float32"][k] for k in
                 ("ms", "call_ms", "plain_ms", "plain_call_ms",
                  "bound_ms", "bound_by", "x_bound")},
        "timed_case": {k: fl["rows"]["bfloat16"][k] for k in
                       ("shape", "dtype", "causal", "flops", "bytes")},
        "serve": {"prefill_ms": lm_res["stats"]["prefill_s"] * 1e3,
                  "warmup_ms": lm_res["stats"]["warmup_s"] * 1e3,
                  "tok_per_s_steady": lm_res["stats"]["tok_per_s_steady"],
                  "tok_per_s": lm_res["stats"]["tok_per_s"],
                  "peak_bytes": lm_res["peak_bytes"],
                  "allocated_before": lm_res["allocated_before"],
                  "param_bytes": lm_res["param_bytes"],
                  "cublas_workspace_bytes": lm_res["cublas_workspace_bytes"],
                  "static_state_bytes": lm_res["stats"]["static_state_bytes"],
                  "decode_graph": lm_res["stats"]["decode_graphs"][0],
                  "eager_vs_captured": lm_res["eager_vs_captured"],
                  "traces": lm_res["traces"]},
        "card": smi,
    }, {
        "name": "rwkv6_chunked_fp32",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_scan.cuh",
        "replaces": "src/repro/kernels/rwkv6_scan.py:75",
        "launches": rw_res["launches"],
        "expected_launches": rw_res["expected"],
        "max_abs_err": rw["inplace"]["max_abs_err"],
        "limit_ratio_vs_plain": rw["inplace"]["limit_ratio"],
        "bitwise_vs_padded_fp32_route": True,
        "ms": rw["inplace"]["ms"],
        "kernel_ms": rw["inplace"]["ms"],
        "call_ms": rw["inplace"]["call_ms"],
        "plain_ms": rw["inplace"]["plain_ms"],
        "plain_call_ms": rw["inplace"]["plain_call_ms"],
        "route_ms": rw["inplace"]["route_ms"],
        "route_call_ms": rw["inplace"]["route_call_ms"],
        "bound_ms": rw["inplace"]["bound_ms"],
        "bound_by": rw["inplace"]["bound_by"],
        "bound_parts_ms": {k: rw["inplace"][k] for k in
                           ("ops_ms_fp32", "bytes_ms")},
        "library_ms": None,
        "library": "none: no single PyTorch call computes the RWKV6 "
                   "recurrence",
        "timed_case": {k: rw["inplace"][k] for k in
                       ("shape", "chunk", "dtype", "flops", "bytes")},
        "launches_train": training["runs"]["rwkv6"]["launches"][0],
        "expected_launches_train": training["runs"]["rwkv6"]["expected"][0],
        "card": smi,
    }, {
        "name": "rwkv6_chunked_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_scan_bwd.cuh",
        "replaces": "src/repro/nn/ssm.py:139",
        "replaces_note": "no TPU kernel: it takes the place of XLA's "
                         "autodiff of the JAX package's chunk_step scan "
                         "(src/repro/nn/ssm.py:139-160), the gradient of the "
                         "port's forward kernel in training",
        "launches": training["runs"]["rwkv6"]["launches"][1],
        "expected_launches": training["runs"]["rwkv6"]["expected"][1],
        "max_abs_err": training["kernel"]["worst"],
        "limit_ratio_vs_plain": training["kernel"]["ratio"],
        "wrong_answer_margins": training["kernel"]["margins"],
        "ms": training["kernel"]["row"]["ms"],
        "kernel_ms": training["kernel"]["row"]["ms"],
        "call_ms": training["kernel"]["row"]["call_ms"],
        "plain_ms": training["kernel"]["row"]["plain_ms"],
        "plain_call_ms": training["kernel"]["row"]["plain_call_ms"],
        "bound_ms": training["kernel"]["row"]["bound_ms"],
        "bound_by": training["kernel"]["row"]["bound_by"],
        "bound_parts_ms": {k: training["kernel"]["row"][k] for k in
                           ("ops_ms_fp32", "bytes_ms")},
        "x_bound": training["kernel"]["row"]["x_bound"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes the RWKV6 "
                   "recurrence's gradient",
        "timed_case": {k: training["kernel"]["row"][k] for k in
                       ("shape", "chunk", "dtype", "flops", "bytes")},
        "train": {"card_vs_cpu": training["agreement"],
                  "tinyllama_1_1b": training["runs"]["tinyllama"],
                  "rwkv6_7b_4_layers": training["runs"]["rwkv6"]},
        "card": smi,
    }, {
        "name": "rwkv6_chunked",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_scan.cuh",
        "replaces": "src/repro/kernels/rwkv6_scan.py:75",
        "launches": rw_res["launches"],
        "expected_launches": rw_res["expected"],
        "max_abs_err": max(rw["worst"].values()),
        "max_abs_err_fp32": rw["worst"]["float32"],
        "max_abs_err_bf16": rw["worst"]["bfloat16"],
        "limit_ratios": rw["ratios"],
        "wrong_answer_margins": rw["margins"],
        "ms": rw["row"]["ms"],
        "kernel_ms": rw["row"]["ms"],
        "call_ms": rw["row"]["call_ms"],
        "plain_ms": rw["row"]["plain_ms"],
        "plain_call_ms": rw["row"]["plain_call_ms"],
        "bound_ms": rw["row"]["bound_ms"],
        "bound_by": rw["row"]["bound_by"],
        "bound_parts_ms": {k: rw["row"][k] for k in
                           ("ops_ms_fp32", "bytes_ms",
                            "ops_ms_bf16_tensor_cores")},
        "library_ms": None,
        "library": "none: no single PyTorch call computes the RWKV6 "
                   "recurrence",
        "timed_case": {k: rw["row"][k] for k in
                       ("shape", "chunk", "dtype", "flops", "bytes")},
        "serve": {"prefill_ms": rw_res["stats"]["prefill_s"] * 1e3,
                  "warmup_ms": rw_res["stats"]["warmup_s"] * 1e3,
                  "tok_per_s_steady": rw_res["stats"]["tok_per_s_steady"],
                  "tok_per_s": rw_res["stats"]["tok_per_s"],
                  "peak_bytes": rw_res["peak_bytes"],
                  "allocated_before": rw_res["allocated_before"],
                  "param_bytes": rw_res["param_bytes"],
                  "cublas_workspace_bytes": rw_res["cublas_workspace_bytes"],
                  "static_state_bytes": rw_res["stats"]["static_state_bytes"],
                  "decode_graph": rw_res["stats"]["decode_graphs"][0],
                  "eager_vs_captured": rw_res["eager_vs_captured"],
                  "traces": rw_res["traces"]},
        "card": smi,
    }]
    print("phase seconds: " + json.dumps(phase_s), flush=True)
    print("profiler sessions: " + json.dumps(PROFILER_LOSS), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(f"total {time.time() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
