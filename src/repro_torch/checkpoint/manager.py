"""Atomic checkpoints with retention and restore onto any device
(reference: ``repro/checkpoint/manager.py``), in the reference's on-disk
format, so that a checkpoint written by either package restores bit for
bit in the other:

* ``step_XXXXXXXX.tmp{proc}/`` is written, then renamed to
  ``step_XXXXXXXX/``: a crash mid-save never leaves a partial checkpoint
  among the listed steps;
* ``proc{proc}.npz`` holds the leaves as members ``leaf_{i}`` in
  ``jax.tree.flatten``'s order (:func:`repro_torch.tree.jax_leaves`: dict
  keys sorted, ``None`` dropped), and ``manifest.json`` is
  ``{"step", "leaves": [{"index", "shape", "dtype"}]}``;
* bfloat16 is stored as its ``uint16`` bits, tagged ``"bfloat16"``;
* the newest ``keep`` checkpoints are kept.

The npz is written one member at a time (``zipfile`` and
``np.lib.format.write_array``, zip64, as ``np.savez`` writes it), so a save
holds one leaf on the host at a time, not the whole state; restore reads
and places one leaf at a time too.  bf16 moves as ``int16`` bits through
``Tensor.view``: the port needs no ``ml_dtypes``.

``restore`` places every leaf on the device asked for, whatever device
wrote it, which is the torch form of the reference's restore onto any
sharding.  It raises on a manifest that does not match its target (leaf
count, shape or dtype); nothing is reinitialised.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.tree import jax_leaves, jax_unflatten

BF16 = "bfloat16"


def _host_array(leaf):
    """``(numpy array, manifest dtype name)`` of one leaf; bf16 as its
    uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), BF16
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _torch_dtype(name: str) -> torch.dtype:
    if name == BF16:
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, dtype=name)).dtype


def _check_leaf(i: int, entry: dict, like) -> None:
    """Manifest entry ``i`` against the target's leaf: the same shape and
    dtype (a Python int, the reference's step count, takes any 0-d
    integer)."""
    shape, name = list(entry["shape"]), entry["dtype"]
    if isinstance(like, int):
        ok = shape == [] and name != BF16 and np.issubdtype(np.dtype(name), np.integer)
    else:
        dt = like.dtype if isinstance(like, torch.Tensor) else _torch_dtype(str(like.dtype))
        ok = shape == list(like.shape) and _torch_dtype(name) == dt
    if not ok:
        raise ValueError(f"leaf {i}: the checkpoint holds {name} {shape}, the target "
                         f"{getattr(like, 'dtype', type(like).__name__)} "
                         f"{list(getattr(like, 'shape', []))}")


def meta_target(tree):
    """A restore target for ``tree`` that holds no memory: every tensor
    leaf a ``meta`` tensor of its shape and dtype.  The leaves are detached
    first: a ``meta`` copy of a leaf that requires grad would keep the leaf
    alive through its grad_fn."""
    return jax_unflatten(tree, [t.detach().to("meta") for t in jax_leaves(tree)])


@dataclasses.dataclass
class CheckpointManager:
    """Saves and restores pytrees of tensors (nested dicts, lists, tuples,
    named tuples such as ``AdamWState``) under ``directory``.  ``log`` holds
    one record per save and restore: ``{"op", "step", "seconds", "bytes"}``."""
    directory: str
    keep: int = 3
    log: List[Dict[str, Any]] = dataclasses.field(default_factory=list, repr=False)

    def __post_init__(self):
        Path(self.directory).mkdir(parents=True, exist_ok=True)

    def _step_dir(self, step: int) -> Path:
        return Path(self.directory) / f"step_{step:08d}"

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, process_index: int = 0) -> str:
        t0 = time.perf_counter()
        final = self._step_dir(step)
        tmp = Path(f"{final}.tmp{process_index}")
        tmp.mkdir(parents=True, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        nbytes = 0
        with zipfile.ZipFile(tmp / f"proc{process_index}.npz", "w",
                             compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
            for i, leaf in enumerate(jax_leaves(tree)):
                arr, name = _host_array(leaf)
                with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                manifest["leaves"].append({"index": i, "shape": list(arr.shape),
                                           "dtype": name})
                nbytes += arr.nbytes
                del arr
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
        if final.exists():             # re-save of the same step (e.g. after a restore)
            shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)          # atomic publish
        self._gc()
        self.log.append({"op": "save", "step": step, "seconds": time.perf_counter() - t0,
                         "bytes": nbytes})
        return str(final)

    # --------------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None, *, target: Any,
                device=None) -> Any:
        """The checkpoint at ``step`` (default: the latest) as a tree of
        ``target``'s structure.  ``target`` holds tensors (``meta`` ones
        will do), arrays or Python ints; it gives the structure and each
        leaf's shape and dtype, which the checkpoint must match.  Every leaf
        goes to ``device``; with ``None``, to its target leaf's device (the
        CPU for a ``meta`` tensor or a non-tensor)."""
        t0 = time.perf_counter()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(d / "manifest.json") as f:
            manifest = json.load(f)
        want = jax_leaves(target)
        entries = manifest["leaves"]
        if len(entries) != len(want):
            raise ValueError(f"{d}: {len(entries)} leaves in the checkpoint, "
                             f"{len(want)} in the target")
        leaves, nbytes = [], 0
        with np.load(d / "proc0.npz") as data:
            for i, (e, like) in enumerate(zip(entries, want)):
                _check_leaf(i, e, like)
                arr = data[f"leaf_{e['index']}"]
                if list(arr.shape) != list(e["shape"]):
                    raise ValueError(f"{d}: leaf {i} is {list(arr.shape)}, the manifest "
                                     f"says {e['shape']}")
                nbytes += arr.nbytes
                if e["dtype"] == BF16:
                    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(arr)
                dev = device
                if dev is None:
                    dev = (like.device if isinstance(like, torch.Tensor)
                           and like.device.type != "meta" else "cpu")
                leaves.append(t.to(dev))
                del arr, t
        self.log.append({"op": "restore", "step": step,
                         "seconds": time.perf_counter() - t0, "bytes": nbytes})
        return jax_unflatten(target, leaves)

    # ------------------------------------------------------------------ meta
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        out = []
        for p in Path(self.directory).iterdir():
            if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(
                    tuple(f".tmp{i}" for i in range(1024))):
                try:
                    out.append(int(p.name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
