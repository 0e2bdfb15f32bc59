"""Production meshes (reference: ``repro/launch/mesh.py``).

A :class:`Mesh` here is the reference's mesh without its devices: ordered
axis names and their sizes, with ``.shape`` a dict as the reference's
``Mesh.shape`` is, which is all that the sharding rules
(``distributed/sharding.py``), ``launch/steps.py``'s shardings and the
pipeline's plan read.  Making one touches no device and needs no process
group; ``distributed/transport.py`` lays the process group over it when
there is one.  The production meshes are a TPU pod's (256 or 512 chips):
their sizes say how the reference cuts a model, not what one card holds.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple


class Mesh:
    """Ordered mesh axes and their sizes: ``Mesh(data=2, pipe=4)`` or
    ``Mesh({"data": 2, "pipe": 4})``."""

    def __init__(self, shape: Optional[Mapping[str, int]] = None, /, **sizes: int):
        axes = dict(shape or {}, **sizes)
        for name, size in axes.items():
            if not isinstance(size, int) or size < 1:
                raise ValueError(f"mesh axis {name!r}: size {size!r} is not a positive int")
        self._shape: Dict[str, int] = axes

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self._shape)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self._shape)

    @property
    def size(self) -> int:
        return math.prod(self._shape.values())

    def get(self, axis: str, default: int = 1) -> int:
        """The size of ``axis``, ``default`` where the mesh lacks it."""
        return self._shape.get(axis, default)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and list(self._shape.items()) == list(other._shape.items())

    def __repr__(self) -> str:
        return f"Mesh({', '.join(f'{k}={v}' for k, v in self._shape.items())})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16), 256 chips of a TPU v5e pod.
    Multi-pod: (pod=2, data=16, model=16), 512 chips."""
    if multi_pod:
        return Mesh(pod=2, data=16, model=16)
    return Mesh(data=16, model=16)


def make_terapipe_mesh(*, n_pipe: int = 16, multi_pod: bool = False) -> Mesh:
    """The model axis re-factored into (pipe, tp) for TeraPipe mode:
    pipeline stages across, tensor parallelism within a stage (paper §3.4,
    "operation partitioning inside a node, pipeline across")."""
    assert 16 % n_pipe == 0
    tp = 16 // n_pipe
    if multi_pod:
        return Mesh(pod=2, data=16, pipe=n_pipe, tp=tp)
    return Mesh(data=16, pipe=n_pipe, tp=tp)


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)
