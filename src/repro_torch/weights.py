"""Parameters of the JAX package -> the port's tensors.

The port keeps the reference's parameter pytree (nested dicts, per-layer
leaves stacked on a leading axis, ``(d_in, d_out)`` weights), so the
conversion is a leaf-wise copy with no renames and no transposes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def _leaf(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # torch.from_numpy rejects ml_dtypes.bfloat16
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:                               # copy: a JAX buffer view is read-only
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree, device, dtype=None):
    """Convert a parameter pytree of numpy arrays (``jax.device_get`` of the
    JAX package's params) into tensors on ``device``.  ``dtype`` casts the
    floating leaves; ``None`` keeps each leaf's own dtype."""
    return tree_map(lambda a: _leaf(a, device, dtype), tree)
