"""Times the RWKV6 kernel of two checkouts of this repo on one card, in one
run: A, B, B, A, each pass in a process of its own that imports and builds
that checkout's ``repro_torch``, and checks that the two give the same bits.

  PYTHONPATH=src python -m repro_torch.launch.rwkv6_ab OLD_ROOT NEW_ROOT

Each pass draws its inputs on the card, each call's from a seed of its
own, and times:

  ``bhsd_<dtype>``  ``rwkv6_chunked_bhsd`` on contiguous (B,H,S,dh) =
                    (8, 64, 2048, 64), chunk 64, fp32 and bf16;
  ``inplace_bfloat16``  ``rwkv6_chunked_fp32`` on (B,S,H,dh) bf16 r/k/v and
                    fp32 logw, where the checkout has it;
  ``bwd_bfloat16``  the backward ``rwkv6_chunked_bwd_fp32`` at RWKV6-7B's
                    training shape (B,S,H,dh) = (4, 2048, 64, 64), chunk
                    64: bf16 r/k/v, fp32 logw, u and dy, where the checkout
                    has it;
  ``time_mix``      one RWKV6-7B time-mix layer, ``rwkv6_mix_chunked``
                    (d 4096, 64 heads, bf16 weights from seed 0) on x
                    (8, 2048, 4096) bf16: the projections, the route to the
                    kernel, the kernel and the output;

each the mean of ``--iters`` calls between two CUDA events after two
warm-up calls.  With each output goes the SHA-256 of its bytes (out and
state), and with ``time_mix`` the peak memory above what was allocated
before it and the kernels of one traced call, with those that copy
(dtype casts, ``contiguous``, padding).  The last line of the output is
one JSON object: the card (``nvidia-smi`` name and power limit), per
checkout the passes, per output whether every pass that has it gave the
same digest (``bitwise_equal``, across the two trees) and whether the
passes of each checkout did (``bitwise_within_checkout``).  The forward
keys must agree across the trees.  ``bwd_bfloat16`` need not: a backward
redesigned to sum in another order gives other bits, within the
backward's limits; each checkout must still agree with itself.  The tool
reports the digests and fails on none of them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

SLICE = (8, 64, 2048, 64)   # B, H, S, dh
BWD_SHAPE = (4, 2048, 64, 64)   # B, S, H, dh: RWKV6-7B's training step
D_MODEL = 4096


def _pass(root: str, iters: int) -> dict:
    """One pass in this process: import ``root``'s repro_torch and time."""
    sys.path.insert(0, str(Path(root) / "src"))
    import hashlib

    import torch
    from repro_torch.kernels import ops
    from repro_torch.nn import ssm

    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, s, dh = SLICE
    ms, digest = {}, {}

    def randn(seed, *shapes):
        """Each timed call draws from a seed of its own: the same inputs in
        every checkout, whatever else a checkout times."""
        gen = torch.Generator("cuda").manual_seed(seed)
        return [torch.randn(*sh, generator=gen, device="cuda")
                for sh in shapes]

    def rwkv6_inputs(seed, shape, dtype, w_dtype):
        r, k, v, w, u = randn(seed, shape, shape, shape, shape, (h, dh))
        return [t.to(dtype) for t in (r, k, v)] + [
            (-torch.exp(0.5 * w)).to(w_dtype), (0.1 * u).to(w_dtype)]

    def timed(key, fn):
        with torch.no_grad():
            sha = hashlib.sha256()
            for t in fn():
                sha.update(t.contiguous().view(torch.uint8).cpu().numpy()
                           .tobytes())
            digest[key] = sha.hexdigest()
            fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
        ms[key] = start.elapsed_time(end) / iters

    for seed, dtype in enumerate((torch.float32, torch.bfloat16)):
        a = rwkv6_inputs(seed, (b, h, s, dh), dtype, dtype)
        timed(f"bhsd_{str(dtype)[6:]}",
              lambda: ops.rwkv6_chunked_bhsd(*a, chunk=64))
        del a
    if hasattr(ops, "rwkv6_chunked_fp32"):
        a = rwkv6_inputs(2, (b, s, h, dh), torch.bfloat16, torch.float32)
        timed("inplace_bfloat16", lambda: ops.rwkv6_chunked_fp32(*a, chunk=64))
        del a
    if hasattr(ops, "rwkv6_chunked_bwd_fp32"):
        a = rwkv6_inputs(4, BWD_SHAPE, torch.bfloat16, torch.float32)
        dy = randn(5, BWD_SHAPE)[0]
        timed("bwd_bfloat16",
              lambda: ops.rwkv6_chunked_bwd_fp32(*a, dy, chunk=64))
        del a, dy
    params = ssm.init_rwkv6(torch.Generator("cuda").manual_seed(0), D_MODEL, h,
                            torch.bfloat16, device="cuda")
    x = randn(3, (b, s, D_MODEL))[0].to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    timed("time_mix", lambda: ssm.rwkv6_mix_chunked(params, x, h))
    peak = torch.cuda.max_memory_allocated() - before
    return {"ms": ms, "digest": digest, "time_mix_peak_bytes_above": peak,
            "time_mix_kernels": _kernel_names(
                lambda: ssm.rwkv6_mix_chunked(params, x, h))}


def _kernel_names(fn):
    """{"kernels": n, "copy_kernels": n} of one traced call of ``fn``.  The
    profiler can lose records at a session's ends, so the call is
    bracketed by spin kernels; a session that lost a bracket gives None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def marks():
        for _ in range(64):
            torch.cuda._sleep(1000)

    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        marks()
        fn()
        marks()
        torch.cuda.synchronize()
    recs = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    if not recs or "spin_kernel" not in recs[0].name \
            or "spin_kernel" not in recs[-1].name:
        return None
    names = [e.name for e in recs if "spin_kernel" not in e.name]
    return {"kernels": len(names),
            "copy_kernels": sum("copy" in n.lower() for n in names)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", help="OLD_ROOT NEW_ROOT")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--pass-of", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.pass_of:
        print(json.dumps(_pass(args.pass_of, args.iters)), flush=True)
        return 0
    if len(args.roots) != 2:
        ap.error("give two checkout roots: OLD_ROOT NEW_ROOT")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    old, new = (str(Path(r).resolve()) for r in args.roots)
    runs = {old: [], new: []}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"   # deterministic cuBLAS
    for root in (old, new, new, old):
        out = subprocess.run(
            [sys.executable, __file__, "--pass-of", root, "--iters",
             str(args.iters)], capture_output=True, text=True, env=env,
            timeout=900)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        runs[root].append(res)
        print(f"{root}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                      res["ms"].items())
              + f"; time_mix peak {res['time_mix_peak_bytes_above']} B, "
              f"kernels {res['time_mix_kernels']} [{card}]", flush=True)
    keys = sorted({k for rs in runs.values() for r in rs for k in r["digest"]})
    bitwise = {k: len({r["digest"][k] for rs in runs.values() for r in rs
                       if k in r["digest"]}) == 1 for k in keys}
    within = {k: {root: len({r["digest"][k] for r in rs
                             if k in r["digest"]}) <= 1
                  for root, rs in runs.items()} for k in keys}
    print(json.dumps({"card": card, "shape": SLICE, "bwd_shape": BWD_SHAPE,
                      "runs": runs, "bitwise_equal": bitwise,
                      "bitwise_within_checkout": within}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
