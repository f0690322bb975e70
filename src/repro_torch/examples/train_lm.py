"""End-to-end driver: train an LM (by default the real smollm-135m config)
for a few hundred steps with the port's training stack: PNODE depth
checkpointing, AdamW, deterministic data, async checkpoints, watchdog and
straggler detection, the port of the JAX package's
``examples/train_lm.py``.  On the card by default:

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 \
      --seq 128 --batch 8 [--device cpu] [--reduced]
  PYTHONPATH=src python -m repro_torch.examples.train_lm --arch mixtral-8x7b \
      --compress int8 --reduced --steps 4 --seq 64 --batch 2 --device cpu

(``--reduced`` swaps in the tiny config for a fast smoke run; the full
config is the default, on the one device: the JAX example's
``--production`` mesh is ROADMAP Queue 1 item 14.)
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.configs.base import ShapeCell, reduced
from repro_torch.configs.registry import get_arch
from repro_torch.launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_lm_ckpt"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--compress", default="none",
                    choices=["none", "bf16", "int8"],
                    help="gradient compression (optim/compress.py)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    full = get_arch(args.arch)
    cfg = reduced(full) if args.reduced else full
    print(f"[train_lm] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"remat={cfg.remat}, compress={args.compress}, "
          f"device={args.device}")
    cell = ShapeCell("cli", args.seq, args.batch, "train")
    t0 = time.time()
    out = train(cfg, cell, steps=args.steps, ckpt_dir=args.ckpt_dir,
                ckpt_every=100, accum=args.accum, lr=args.lr, log_every=10,
                compress=None if args.compress == "none" else args.compress,
                device=args.device)
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    print(f"[train_lm] {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
          f"in {dt:.0f}s ({toks / dt:.0f} tok/s); "
          f"stragglers flagged: {out['stragglers']}")
    return out


if __name__ == "__main__":
    main()
