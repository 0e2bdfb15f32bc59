"""Explicit device resolution for every entry point of the port.

There is no silent fallback: an entry point runs on ``cuda`` unless its
caller passes ``device="cpu"``, and asking for CUDA on a host without a
GPU raises.  ``meta`` (shapes and dtypes without storage: the abstract
structures of ``launch/steps.py``) is taken only when the caller names
it.  Resolving a CUDA device also turns TF32 off for matmuls and
cuDNN, so float32 runs keep full float32 precision (the tolerance the
parity tests hold against the JAX reference assumes it).
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` (str or ``torch.device``: cuda, cpu or meta) ->
    ``torch.device``; raises ``RuntimeError`` for a CUDA device when no
    GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA GPU is available; "
                f"pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r} (cuda, cpu or meta)")
    return dev
