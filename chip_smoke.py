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
5. flash kernel phase: ``flash_attention_bhsd`` against ``attention_plain``
   on the card (fp32 rtol = atol = 2e-5, the tolerance of
   tests/test_kernels.py; bf16 rtol 1e-2, atol 1e-3, one bf16 ulp of the
   output, tighter than that file's 5e-2) over that file's grid, the
   cross-lengths case, every supported head dim and the LM slice's shape
   (8, 32, 4, 1920, 64); then timed there beside its bound, its plain
   version and
   ``scaled_dot_product_attention`` (a yardstick the port never calls);
6. LM serving at TinyLlama-1.1B's full width (22 layers, d 2048, 32/4
   heads, bf16, ``attn_impl="pallas"``, random weights drawn on the card
   from seed 0) through ``repro_torch.launch.serve.serve``: batch 8,
   prompt 1920, 128 greedy tokens (max_seq 2048), decode slices of 8; then
   one traced prefill and one traced decode slice;
7. agreement: the kernel's prefill against the naive one on the same
   weights (bf16 at full depth; fp32 at full width and 2 layers, with 16
   greedy decode steps), and the card against the port on the CPU (fp32,
   full width, 2 layers, batch 2, prompt 64, 8 teacher-forced decode
   steps);
8. one JSON line with each kernel's launches on its main path (which must
   equal ``expected_lincomb_calls`` / ``expected_flash_calls``), its error
   against the plain version and its times; then the nvidia-smi line; then
   the result line.

The kernels' launch counters are set to 0 just before each main path
(phases 3-4 for ``fused_lincomb``, phase 6 for the flash kernel) and read
just after; comparisons made outside those windows are not counted.  TF32
is off wherever the card is compared with the CPU.
"""
import os

# deterministic cuBLAS; must be set before torch initialises CUDA
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

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
# the flash kernel against attention_plain.  bf16: both round an fp32
# result to bf16 once, so they may differ by one ulp, at most 2**-7 of the
# output; an error the size of an output (about 0.05 at S = 1920) fails
FLASH_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=1e-2, atol=1e-3)}
# the LM slice: TinyLlama-1.1B at full width, the kernel's attention path
LM = dict(arch="tinyllama-1.1b", batch=8, prompt_len=1920, gen=128,
          decode_slice=8)
LM_BF16_REL_TOL = 5e-2   # pallas vs naive last logits, bf16, 22 layers:
#                          max|diff| / max|logit|, bf16 rounding of the
#                          residual stream in another order, 22 times
LM_FP32_REL_TOL = 1e-4   # pallas vs naive, fp32, 2 layers
LM_CPU_REL_TOL = 1e-4    # card vs CPU port, fp32 (TF32 off), 2 layers


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
MARKS = 64       # spin kernels that open and close every traced window


def device_kernels(fn, iters=1):
    """[(kernel name, device microseconds)] of the kernels ``fn`` runs,
    from the profiler's CUPTI records, and the host milliseconds of the
    window (ending in a synchronize).

    ``torch.profiler`` on the H100 machine can lose the records at either
    end of a session (more of them after a large trace; never in the
    middle), so the window is bracketed by ``MARKS`` spin kernels on each
    side: its records are complete when a mark survives at both ends.
    A session where one end lost every mark is traced again, calling
    ``fn`` anew, up to ``SESSIONS`` sessions; then the run fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def marks():
        for _ in range(MARKS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    for _ in range(SESSIONS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marks()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            marks()
        recs = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        is_mark = ["spin_kernel" in e.name for e in recs]
        if recs and is_mark[0] and is_mark[-1]:
            return [(e.name, e.time_range.elapsed_us()) for e, m
                    in zip(recs, is_mark) if not m], wall_ms
        print(f"  (profiler: a session lost the records at one end of its "
              f"window; {len(recs)} records)", flush=True)
    fail(f"the profiler lost records of a traced window in {SESSIONS} "
         "sessions")


def device_ms(fn, iters=20):
    """Device time per call: the durations of the kernels ``fn`` runs."""
    fn()
    kernels, _ = device_kernels(fn, iters)
    return sum(us for _, us in kernels) / iters / 1e3


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
# phase 5: the flash kernel against its plain version
# ---------------------------------------------------------------------------

FLASH_GRID = [(1, 4, 4, 128, 64), (2, 4, 2, 128, 64), (1, 8, 1, 256, 32),
              (1, 4, 4, 200, 64), (1, 2, 2, 64, 128)]
FLASH_SLICE = (8, 32, 4, 1920, 64)  # (B, H, Hkv, S, Dh) of the LM slice


def flash_operands(b, h, hkv, sq, sk, dh, dtype, gen, device):
    import torch
    return (torch.randn(b, h, sq, dh, generator=gen).to(device, dtype),
            torch.randn(b, hkv, sk, dh, generator=gen).to(device, dtype),
            torch.randn(b, hkv, sk, dh, generator=gen).to(device, dtype))


def flash_phase(card, dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ops import FLASH_HEAD_DIMS, flash_attention_bhsd
    from repro_torch.kernels.ref import attention_plain

    gen = torch.Generator().manual_seed(2)
    cases = [(b, h, hkv, s, s, dh, causal, window)
             for b, h, hkv, s, dh in FLASH_GRID
             for causal, window in ((True, 0), (True, 48), (False, 0))]
    cases.append((1, 4, 4, 64, 192, 64, False, 0))  # cross lengths
    for dh in FLASH_HEAD_DIMS:
        cases += [(2, 4, 2, 150, 150, dh, True, 0),
                  (1, 2, 1, 70, 70, dh, True, 16)]
    b, h, hkv, s, dh = FLASH_SLICE
    cases.append((b, h, hkv, s, s, dh, True, 0))
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        tol = FLASH_TOL[name]
        for (b, h, hkv, sq, sk, dh, causal, window) in cases:
            q, k, v = flash_operands(b, h, hkv, sq, sk, dh, dtype, gen, dev)
            out = flash_attention_bhsd(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            ref = attention_plain(q, k, v, causal=causal, window=window)
            err = max_abs(out, ref)
            check(out.dtype == dtype and out.shape == ref.shape
                  and torch.allclose(out.float(), ref.float(), **tol),
                  f"flash_attention_bhsd vs attention_plain beyond {tol}: "
                  f"{name} {(b, h, hkv, sq, sk, dh)} causal={causal} "
                  f"window={window} max|diff|={err}")
            worst[name] = max(worst[name], err)
    print(f"flash phase: flash_attention_bhsd within tolerance of "
          f"attention_plain on {2 * len(cases)} cases (test_kernels grid x "
          f"causal/window 48/non-causal, cross lengths 64x192, head dims "
          f"{FLASH_HEAD_DIMS}, the slice's {FLASH_SLICE}; fp32 and bf16); "
          f"max|diff| fp32 {worst['float32']:.3e} (tol {FLASH_TOL['float32']}"
          f"), bf16 {worst['bfloat16']:.3e} (tol {FLASH_TOL['bfloat16']}) "
          f"{card}", flush=True)

    # times at the slice's shape, causal: the kernel's device time (profiler
    # kernel records) and call time (CUDA events over a loop of Python
    # calls), the plain version's, and SDPA's as the library yardstick
    b, h, hkv, s, dh = FLASH_SLICE
    pairs = b * h * s * (s + 1) // 2          # unmasked (query, key) pairs
    flops = 4 * dh * pairs                    # q.k and p.v, 2 FLOP per MAC
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        q, k, v = flash_operands(b, h, hkv, s, s, dh, dtype, gen, dev)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
        kern = lambda: flash_attention_bhsd(q, k, v)  # noqa: E731
        plain = lambda: attention_plain(q, k, v)  # noqa: E731
        row = dict(shape=list(FLASH_SLICE), dtype=name, causal=True,
                   flops=flops, bytes=nbytes,
                   bound_ms=max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3,
                   call_ms=time_ms(kern, 20, 3),
                   plain_call_ms=time_ms(plain, 3, 1))
        row["ms"] = device_ms(kern, iters=10)
        row["plain_ms"] = device_ms(plain, iters=3)
        row["bound_by"] = ("operations" if flops / peak
                           >= nbytes / HBM_BYTES_PER_S else "bytes")
        if dtype == torch.bfloat16:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True, enable_gqa=True)
            row["library_ms"] = device_ms(lib, 10)
            row["library_call_ms"] = time_ms(lib, 20, 3)
            check(torch.allclose(lib().float(), kern().float(), rtol=5e-2,
                                 atol=5e-2),
                  "SDPA and the flash kernel disagree at the slice's shape")
        rows[name] = row
        print(f"  flash {name} {FLASH_SLICE} causal: kernel {row['ms']:.4f} "
              f"ms (call {row['call_ms']:.4f})  plain {row['plain_ms']:.4f} "
              f"ms (call {row['plain_call_ms']:.4f})  bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {flops:.4e} "
              f"FLOP at {peak / 1e12:.0f} TFLOP/s, {nbytes} B)"
              + (f"  SDPA {row['library_ms']:.4f} ms (call "
                 f"{row['library_call_ms']:.4f})" if "library_ms" in row
                 else "") + f" {card}", flush=True)
        del q, k, v
    torch.cuda.empty_cache()
    return worst, rows


# ---------------------------------------------------------------------------
# phases 6-7: LM serving at TinyLlama-1.1B full width, and agreement
# ---------------------------------------------------------------------------

def lm_serve_phase(card, dev):
    import dataclasses
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm
    from repro_torch.serve import LMEngine

    cfg = dataclasses.replace(get_arch(LM["arch"]), attn_impl="pallas")
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

    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.time()
    tokens, stats = serve(cfg, batch=LM["batch"], prompt_len=LM["prompt_len"],
                          gen=LM["gen"], decode_slice=LM["decode_slice"],
                          temperature=0.0, replicas=1, device=dev,
                          params=params)
    wall_s = time.time() - t0
    launches, plain = ops.flash_launches, ops.flash_plain_calls
    peak = torch.cuda.max_memory_allocated()
    waves = 1  # one engine whose lanes hold the whole batch
    expected = lm.expected_flash_calls(cfg, waves)
    print(f"flash_attention launches on the serve path: {launches} (expected "
          f"{expected}: {cfg.n_layers} attention layers x {waves} prefill "
          f"wave); plain calls {plain}", flush=True)
    check(plain == 0, f"{plain} plain attention calls on the card path")
    check(launches > 0 and launches == expected,
          f"flash launches {launches} != expected {expected}")
    check(tuple(tokens.shape) == (LM["batch"], LM["gen"]),
          f"tokens shape {tuple(tokens.shape)}")
    check(int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size,
          "tokens out of the vocabulary")
    print(f"LM serve {cfg.name}: batch {LM['batch']}, prompt "
          f"{LM['prompt_len']}, gen {LM['gen']} (max_seq "
          f"{LM['prompt_len'] + LM['gen']}), decode_slice "
          f"{LM['decode_slice']}, greedy: tokens {tuple(tokens.shape)} in "
          f"[{int(tokens.min())}, {int(tokens.max())}]; warm-up "
          f"{stats['warmup_s'] * 1e3:.1f} ms, prefill "
          f"{stats['prefill_s'] * 1e3:.1f} ms, decode "
          f"{stats['decode_s'] * 1e3:.1f} ms, steady "
          f"{stats['tok_per_s_steady']:.1f} tok/s, end-to-end "
          f"{stats['tok_per_s']:.1f} tok/s, serve() wall {wall_s:.2f} s; "
          f"max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB) {card}",
          flush=True)

    # where the time goes: one traced prefill and one traced decode slice.
    # Each engine's first step prefills its wave and later steps decode
    # slices, so a repeated profiling session takes a fresh engine for the
    # prefill and the next slice for the decode.
    prompts = np.random.RandomState(3).randint(
        0, cfg.vocab_size, (LM["batch"], LM["prompt_len"]))

    def engine():
        eng = LMEngine(cfg, lanes=LM["batch"], prompt_len=LM["prompt_len"],
                       max_gen=LM["gen"], decode_slice=LM["decode_slice"],
                       params=params, device=dev)
        for p_ in prompts:
            eng.submit(p_)
        return eng

    fresh, prefilled = [engine() for _ in range(SESSIONS)], []

    def prefill_wave():
        prefilled.append(fresh.pop())
        prefilled[-1].step()

    traces = {}
    for label, fn in (("prefill", prefill_wave),
                      ("decode slice", lambda: prefilled[-1].step())):
        kernels, wall_ms = device_kernels(fn)
        busy = sum(us for _, us in kernels) / 1e3
        fl = [us for n, us in kernels if "flash_fwd_kernel" in n]
        traces[label] = dict(wall_ms=wall_ms, busy_ms=busy,
                             idle_share=1 - busy / wall_ms,
                             kernels=len(kernels), flash_launches=len(fl),
                             flash_ms=sum(fl) / 1e3,
                             flash_share=sum(fl) / 1e3 / busy)
        print(f"traced LM {label} ({LM['batch']} x {LM['prompt_len']}"
              + (f", {LM['decode_slice']} steps" if label != "prefill"
                 else "") + f"): wall {wall_ms:.1f} ms, device busy "
              f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.4f}; "
              f"{len(kernels)} kernels; flash_attention {len(fl)} launches, "
              f"{sum(fl) / 1e3:.3f} ms = {sum(fl) / 1e3 / busy:.4f} of "
              f"device time {card}", flush=True)
        by_name = {}
        for n, us in kernels:
            cnt, tot = by_name.get(n, (0, 0.0))
            by_name[n] = (cnt + 1, tot + us)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        traces[label]["top"] = [(n[:80], c, t / 1e3) for n, (c, t) in top]
        for n, (c, t) in top:
            print(f"    {t / 1e3:9.3f} ms {t / 1e3 / busy:.4f} x{c:<5d} "
                  f"{n[:100]}")
    del fresh, prefilled
    return cfg, params, dict(launches=launches, expected=expected,
                             stats=stats, peak_bytes=peak, traces=traces)


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

    from torch.utils import _pytree as pytree
    from repro_torch.core.adjoint import expected_lincomb_calls
    from repro_torch.examples.image_classification import synthetic_cifar
    from repro_torch.kernels import _build, ops
    from repro_torch.models.ode_nets import classifier_init, cnf_vf_init
    from repro_torch.optim.adamw import AdamW

    t_start = time.time()
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
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {stem}: {line.strip()}")

    # -- phase 2 -------------------------------------------------------------
    worst, timing_rows = kernel_phase(card)

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

    for label, fn in (("CNF density+score requests",
                       lambda: cnf_requests(cnf_theta, x, fused=True)),
                      ("classifier training step", step)):
        kernels, wall_ms = device_kernels(fn)
        busy = sum(us for _, us in kernels) / 1e3
        lin = [us for n, us in kernels if "lincomb_kernel" in n]
        print(f"traced {label}: wall {wall_ms:.1f} "
              f"ms, device busy {busy:.3f} ms, idle share "
              f"{1 - busy / wall_ms:.4f}; {len(kernels)} kernels; "
              f"fused_lincomb {len(lin)} launches, {sum(lin) / 1e3:.3f} ms "
              f"= {sum(lin) / 1e3 / busy:.4f} of device time {card}")

    # -- phase 5: the flash kernel ------------------------------------------
    torch.use_deterministic_algorithms(False)  # the LM phases hold tolerances
    flash_worst, flash_rows = flash_phase(card, dev)

    # -- phase 6: LM serving at full width, counted ---------------------------
    lm_cfg, lm_params, lm_res = lm_serve_phase(card, dev)

    # -- phase 7: agreement ---------------------------------------------------
    lm_agreement_phase(lm_cfg, lm_params, card, dev)

    # -- phase 8: the kernels line, the card, the result ---------------------
    main_row = timing_rows[0]
    kernels = [{
        "name": "fused_lincomb",
        "route": "cuda",
        "source": "src/repro_torch/csrc/lincomb.cu",
        "replaces": "src/repro/kernels/ops.py:71",
        "launches": total_launches,
        "expected_launches": exp_cnf + exp_cls,
        "launches_cnf": cnf_launches,
        "launches_classifier": cls_launches,
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
        "card": smi,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:91",
        "launches": lm_res["launches"],
        "expected_launches": lm_res["expected"],
        "max_abs_err": max(flash_worst.values()),
        "max_abs_err_fp32": flash_worst["float32"],
        "max_abs_err_bf16": flash_worst["bfloat16"],
        "ms": flash_rows["bfloat16"]["ms"],
        "kernel_ms": flash_rows["bfloat16"]["ms"],
        "plain_ms": flash_rows["bfloat16"]["plain_ms"],
        "call_ms": flash_rows["bfloat16"]["call_ms"],
        "plain_call_ms": flash_rows["bfloat16"]["plain_call_ms"],
        "bound_ms": flash_rows["bfloat16"]["bound_ms"],
        "bound_by": flash_rows["bfloat16"]["bound_by"],
        "library_ms": flash_rows["bfloat16"]["library_ms"],
        "library_call_ms": flash_rows["bfloat16"]["library_call_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention("
                   "is_causal=True, enable_gqa=True), bf16",
        "fp32": {k: flash_rows["float32"][k] for k in
                 ("ms", "call_ms", "plain_ms", "plain_call_ms",
                  "bound_ms", "bound_by")},
        "timed_case": {k: flash_rows["bfloat16"][k] for k in
                       ("shape", "dtype", "causal", "flops", "bytes")},
        "serve": {"prefill_ms": lm_res["stats"]["prefill_s"] * 1e3,
                  "warmup_ms": lm_res["stats"]["warmup_s"] * 1e3,
                  "tok_per_s_steady": lm_res["stats"]["tok_per_s_steady"],
                  "tok_per_s": lm_res["stats"]["tok_per_s"],
                  "peak_bytes": lm_res["peak_bytes"],
                  "traces": lm_res["traces"]},
        "card": smi,
    }]
    print(json.dumps({"kernels": kernels}))
    print(f"total {time.time() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
