"""Paper §5.2: FFJORD continuous normalizing flow for density estimation,
trained with the PNODE adjoint (synthetic two-moons-style 2-d target; the
tabular POWER/MINIBOONE/BSDS300 shapes are for the benchmarks).  Runs on
the card with the fused stage kernel unless told otherwise.

  PYTHONPATH=src python -m repro_torch.examples.cnf_density [--iters 200] \
      [--adjoint pnode|pnode2|revolve|revolve2] [--device cuda|cpu] \
      [--no-fused]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.cnf import cnf_log_prob, cnf_sample
from repro_torch.models.ode_nets import cnf_vf, cnf_vf_init, resolve_device
from repro_torch.optim.adamw import AdamW


def two_moons(rs: np.random.RandomState, n: int) -> np.ndarray:
    theta = np.pi * rs.uniform(size=n)
    upper = rs.uniform(size=n) < 0.5
    x = np.where(upper, np.cos(theta), 1 - np.cos(theta))
    y = np.where(upper, np.sin(theta), 0.5 - np.sin(theta))
    pts = np.stack([x, y], -1)
    return (pts + 0.08 * rs.randn(*pts.shape)).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--adjoint", default="pnode")
    ap.add_argument("--ncheck", type=int, default=4)
    ap.add_argument("--n-steps", type=int, default=12)
    ap.add_argument("--method", default="bosh3")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--test-batch", type=int, default=1024)
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    help="unfused stage updates (required for naive, "
                         "continuous, anode and aca)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    gen = torch.Generator().manual_seed(args.seed)
    theta = cnf_vf_init(gen, 2, hidden=(args.hidden, args.hidden),
                        device=device)
    opt = AdamW(lr=2e-3, weight_decay=1e-5, warmup_steps=20,
                total_steps=args.iters)
    kw = {"ncheck": args.ncheck} if args.adjoint.startswith("revolve") else {}

    def nll(theta, x):
        lp = cnf_log_prob(cnf_vf, x, theta, dt=1.0 / args.n_steps,
                          n_steps=args.n_steps, method=args.method,
                          adjoint=args.adjoint, fused_stages=args.fused, **kw)
        return -lp.mean()

    state = opt.init(theta)
    rs = np.random.RandomState(args.seed + 42)
    t0 = time.time()
    for it in range(args.iters):
        x = torch.from_numpy(two_moons(rs, args.batch)).to(device)
        leaves = [p.requires_grad_(True) for p in pytree.tree_leaves(theta)]
        loss = nll(theta, x)
        grads = pytree.tree_unflatten(list(torch.autograd.grad(loss, leaves)),
                                      pytree.tree_structure(theta))
        with torch.no_grad():
            theta, state, _ = opt.update(
                grads, state, pytree.tree_map(torch.Tensor.detach, theta))
        if it % max(1, args.iters // 10) == 0:
            print(f"iter {it:4d} nll {loss.item():.4f} "
                  f"({(time.time()-t0)/(it+1)*1e3:.0f} ms/iter on "
                  f"{device.type})")

    # held-out NLL + samples
    x_test = torch.from_numpy(
        two_moons(np.random.RandomState(7), args.test_batch)).to(device)
    with torch.no_grad():
        final_nll = nll(theta, x_test).item()
    print(f"final held-out NLL: {final_nll:.4f} (adjoint={args.adjoint}, "
          f"fused={args.fused})")
    z = torch.from_numpy(
        np.random.RandomState(8).randn(args.samples, 2).astype(np.float32))
    with torch.no_grad():
        samples = cnf_sample(cnf_vf, z.to(device), theta,
                             dt=1.0 / args.n_steps, n_steps=args.n_steps,
                             method=args.method)
    print("samples:\n", samples.cpu().numpy())


if __name__ == "__main__":
    main()
