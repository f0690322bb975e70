"""Paper §5.1: ODE-block image classification (SqueezeNext-style block with
the conv vector field), trained with selectable adjoint policies on a
synthetic CIFAR-10 stand-in (the dataset is not available offline; shapes,
batch and class count match).  Runs on the card with the fused stage
kernel unless told otherwise.  The loss and its gradient are one
``StepGraph`` (the JAX example jits ``value_and_grad``): captured as a
CUDA graph at the first step and replayed after it; AdamW stays eager, as
in the JAX example.

  PYTHONPATH=src python -m repro_torch.examples.image_classification \
      [--steps 30] [--adjoint pnode] [--method rk4] [--n-steps 2] \
      [--device cuda|cpu] [--no-fused]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.depth_ode import ODEBlock
from repro_torch.launch.graphs import StepGraph
from repro_torch.models.ode_nets import (classifier_apply, classifier_init,
                                         conv_vf, resolve_device,
                                         softmax_xent)
from repro_torch.optim.adamw import AdamW


def synthetic_cifar(rs: np.random.RandomState, templates: np.ndarray, n: int,
                    size: int = 32):
    """Class-conditional Gaussian blobs in image space: learnable but
    non-trivial.  ``templates`` are fixed (n_classes, 8, 8, 3) class
    patterns, upsampled by nearest neighbour to ``size``."""
    labels = rs.randint(0, templates.shape[0], size=n)
    rep = size // templates.shape[1]
    t = templates[labels].repeat(rep, axis=1).repeat(rep, axis=2)
    x = t + 0.6 * rs.randn(n, size, size, 3)
    return x.astype(np.float32), labels


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--adjoint", default="pnode")
    ap.add_argument("--method", default="rk4")
    ap.add_argument("--n-steps", type=int, default=2)
    ap.add_argument("--ncheck", type=int, default=2)
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--eval-batch", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    help="unfused stage updates (required for naive, "
                         "continuous, anode and aca)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    kw = {"ncheck": args.ncheck} if args.adjoint.startswith("revolve") else {}
    block = ODEBlock(conv_vf, n_steps=args.n_steps, method=args.method,
                     adjoint=args.adjoint, fused_stages=args.fused, **kw)
    gen = torch.Generator().manual_seed(args.seed)
    params = classifier_init(gen, channels=args.channels, device=device)
    opt = AdamW(lr=2e-3, warmup_steps=10, total_steps=args.steps)
    state = opt.init(params)
    rs = np.random.RandomState(args.seed + 1)
    templates = np.random.RandomState(args.seed).randn(10, 8, 8, 3)

    def forward(params, x):
        return classifier_apply(params, x,
                                odeint_fn=lambda vf, u, th: block(u, th))

    def value_and_grad(held, copied):
        params, x, labels = copied
        leaves = [p.detach().requires_grad_(True)
                  for p in pytree.tree_leaves(params)]
        logits = forward(pytree.tree_unflatten(
            leaves, pytree.tree_structure(params)), x)
        loss = softmax_xent(logits, labels)
        return (loss.detach(), logits.detach(),
                list(torch.autograd.grad(loss, leaves)))

    # params are copied in: AdamW replaces their tensors every step
    grad_step = StepGraph(value_and_grad, clone_outputs=True)
    t0 = time.time()
    for step in range(args.steps):
        x, labels = synthetic_cifar(rs, templates, args.batch, args.image_size)
        x = torch.from_numpy(x).to(device)
        labels = torch.from_numpy(labels).to(device)
        loss, logits, grads = grad_step((), (params, x, labels))
        grads = pytree.tree_unflatten(grads, pytree.tree_structure(params))
        with torch.no_grad():
            params, state, _ = opt.update(grads, state, params)
        if step % max(1, args.steps // 10) == 0:
            acc = float((logits.argmax(-1) == labels).float().mean())
            print(f"step {step:4d} loss {loss.item():.4f} acc {acc:.3f} "
                  f"({(time.time()-t0)/(step+1)*1e3:.0f} ms/step on "
                  f"{device.type})")

    x, labels = synthetic_cifar(np.random.RandomState(99), templates,
                                args.eval_batch, args.image_size)
    with torch.no_grad():
        logits = forward(params, torch.from_numpy(x).to(device))
    acc = float((logits.argmax(-1).cpu().numpy() == labels).mean())
    print(f"eval accuracy: {acc:.3f} (adjoint={args.adjoint}, "
          f"method={args.method}, fused={args.fused})")


if __name__ == "__main__":
    main()
