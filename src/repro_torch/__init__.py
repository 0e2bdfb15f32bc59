"""PyTorch/CUDA port of the TeraPipe reproduction (reference: ``src/repro``).

The package mirrors ``repro``'s module paths; each module's docstring names
the JAX function it ports.  It imports ``torch`` and numpy only — never
``jax`` or anything under ``repro`` — and runs on ``cuda`` unless a caller
asks for ``device="cpu"`` (see :mod:`repro_torch.device`).  The hot
attention ops are hand-written CUDA C++ kernels for Hopper
(``kernels/csrc``), built with ``nvcc`` at first use.
"""
