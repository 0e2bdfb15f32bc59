"""Hand-written Hopper kernels (``csrc/*.cu``), their launch wrappers, the
plain PyTorch versions they are held against (``ref``) and the public ops
that dispatch between them by device (``ops``)."""
