"""Times the flash kernels of two checkouts of this repo on one card, in one
run: A, B, B, A, each pass in a process of its own that imports and builds
that checkout's ``repro_torch``.

  PYTHONPATH=src python -m repro_torch.launch.flash_ab OLD_ROOT NEW_ROOT

Each pass times, at the LM slice's shape (B 8, H 32, Hkv 4, S 1920, Dh 64),
causal, on inputs drawn from one seed:

  ``bhsd_<dtype>``  ``flash_attention_bhsd`` on contiguous (B,H,S,Dh)
  ``bshd_<dtype>``  ``flash_attention`` on the model's (B,S,H,Dh) layout

for fp32 and bf16, each the mean of ``--iters`` back-to-back calls between
two CUDA events, after two warm-up calls.  The last line of the output is
one JSON object: the card (``nvidia-smi`` name and power limit) and, per
checkout, the ms of each pass.  Only what both checkouts have is timed, so
an older checkout (whose ``flash_attention`` copied the layout into
(B,H,S,Dh)) is timed through the same two calls.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

SLICE = (8, 32, 4, 1920, 64)   # B, H, Hkv, S, Dh


def _pass(root: str, iters: int) -> dict:
    """One pass in this process: import ``root``'s repro_torch and time."""
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    from repro_torch.kernels import ops

    b, h, hkv, s, dh = SLICE
    gen = torch.Generator("cuda").manual_seed(0)
    ms = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        q = torch.randn(b, s, h, dh, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(b, s, hkv, dh, generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        dense = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
        calls = {f"bhsd_{name}": lambda: ops.flash_attention_bhsd(*dense),
                 f"bshd_{name}": lambda: ops.flash_attention(q, k, v)}
        for key, fn in calls.items():
            for _ in range(2):
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
        del q, k, v, dense
    return ms


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
    for root in (old, new, new, old):
        out = subprocess.run(
            [sys.executable, __file__, "--pass-of", root, "--iters",
             str(args.iters)], capture_output=True, text=True, env=env,
            timeout=900)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        ms = json.loads(out.stdout.strip().splitlines()[-1])
        runs[root].append(ms)
        print(f"{root}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                      ms.items()) + f" [{card}]", flush=True)
    print(json.dumps({"card": card, "shape": SLICE, "causal": True,
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
