"""Carries parameter trees between the JAX package and the port.

The JAX package's trees are nested dicts/lists of arrays; here they come in
and go out as numpy arrays, so this module imports neither JAX nor the JAX
package.  The only layout that differs is the conv kernel: JAX stores it
HWIO (``lax.conv_general_dilated`` with ``("NHWC", "HWIO", "NHWC")``), the
port OIHW (``torch.nn.functional.conv2d``).  Every other leaf, dense
``w`` (d_in, d_out) included, keeps its layout.  A leaf is a conv kernel
when it is a 4-D ``"w"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.ode_nets import resolve_device


def _convert(tree, leaf_fn, key=None):
    if isinstance(tree, dict):
        return {k: _convert(v, leaf_fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, leaf_fn, key) for v in tree)
    return leaf_fn(tree, key)


def params_from_jax(tree, *, device="cuda",
                    dtype: torch.dtype | None = None):
    """A JAX-layout tree of numpy arrays -> the port's tree of tensors on
    ``device`` (cast to ``dtype`` when given).  Like every entry point of
    the port it places them on the card unless the caller asks for the CPU,
    and raises when there is no card."""
    device = resolve_device(device)

    def leaf(x, key):
        a = np.asarray(x)
        if key == "w" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dtype or t.dtype)
    return _convert(tree, leaf)


def params_to_numpy(tree):
    """The port's tree of tensors -> a JAX-layout tree of numpy arrays
    (e.g. to hold gradients against the JAX package's)."""
    def leaf(x, key):
        a = x.detach().cpu().numpy()
        if key == "w" and a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        return a
    return _convert(tree, leaf)
