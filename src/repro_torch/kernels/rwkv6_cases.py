"""The RWKV6 kernel's test cases, shared by ``chip_smoke.py`` and the tests:
the JAX package's kernel test grid, its inputs, and the limits that hold
``rwkv6_chunked_bhsd`` against its plain versions.

Limits, by output dtype name:

- ``RWKV6_TOL``, the kernel against ``rwkv6_plain`` (the same chunked
  algorithm), as (rtol, atol / max|plain|).  fp32: both take every
  exponent from the same sequential fp32 cumsum and the same ``expf``, so
  they differ only in the order of the four products' sums (at most
  dh + 2C = 192 terms an output at dh = C = 64); the reordering bound
  192 * 2**-24 per term, over terms a few times max|out|, gives 2**-14.
  bf16: both round one fp32 result to bf16 once: one ulp, at most 2**-7
  of the output, plus 1e-3 of max|out| near zero.  The final state is
  fp32 in both and is held to the fp32 limit.
- ``RWKV6_REF_TOL``, chunked against the sequential oracle ``rwkv6_ref``:
  the JAX package's own limits (tests/test_kernels.py:114), for the output
  and the state.
"""
from __future__ import annotations

import numpy as np
import torch

RWKV6_TOL = {"float32": (2.0 ** -14, 2.0 ** -14),
             "bfloat16": (2.0 ** -7, 1e-3)}
RWKV6_REF_TOL = {"float32": dict(rtol=2e-2, atol=1e-3),
                 "bfloat16": dict(rtol=0.15, atol=0.15)}
# (B, H, S, dh, chunk) of the JAX package's grid (tests/test_kernels.py:93-98)
RWKV6_GRID = [(1, 2, 128, 32, 32), (2, 4, 128, 64, 64), (1, 2, 256, 64, 64),
              (1, 1, 64, 128, 16)]


def rwkv6_inputs(b, h, s, dh, gen, *, dtype=torch.float32, layout="bhsd"):
    """randn r/k/v, logw = -exp(0.5 randn), u = 0.1 randn, as the JAX
    package's kernel tests make them, in (B,H,S,dh) or, with
    ``layout="bshd"``, (B,S,H,dh).  ``gen`` is a numpy ``RandomState``
    (CPU tensors, for comparisons with the JAX package) or a
    ``torch.Generator`` (tensors on its device)."""
    if isinstance(gen, np.random.RandomState):
        def randn(*shape):
            return torch.from_numpy(gen.randn(*shape).astype(np.float32))
    else:
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=gen.device)
    shape = (b, h, s, dh) if layout == "bhsd" else (b, s, h, dh)
    r, k, v = randn(*shape), randn(*shape), randn(*shape)
    logw = -torch.exp(0.5 * randn(*shape))
    u = 0.1 * randn(h, dh)
    return [t.to(dtype) for t in (r, k, v, logw, u)]

