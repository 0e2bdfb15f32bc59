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

Across processes (``world``, a group over every process of the run, and a
``layout``: per leaf of the tree a ``distributed.sharding.LeafShards``,
how the processes hold it), the file is the same one: ``save`` gathers
each leaf's blocks on rank 0 (padded to the largest block, as bytes, so
every bit survives), which writes that whole leaf and renames the
directory; every rank then passes a barrier, and rank 0 alone drops old
steps.  ``restore`` reads the file on every rank, leaf by leaf, and keeps
each rank's block, so a checkpoint restores into any count of processes.
The step to restore is rank 0's latest, broadcast through the world (a
rank that listed the directory before rank 0's rename had finished would
otherwise restore an older step).  Each ``log`` record keeps this
process's share (``bytes``) beside the file's size (``file_bytes``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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


def _whole(lay) -> bool:
    return lay is None or lay.whole


def _gather_leaf(leaf, lay, world):
    """``leaf`` whole on world rank 0 (``None`` elsewhere): a leaf every
    rank holds whole is rank 0's own; otherwise each rank's block, as
    bytes padded to the largest block, gathered on rank 0 and put in its
    place of a whole leaf on the host."""
    lead = world is None or world.rank == 0
    if _whole(lay):
        return leaf if lead else None
    t = leaf.detach()
    size = t.element_size()
    nbytes = [math.prod(b.shape(lay.shape)) * size for b in lay.blocks]
    buf = torch.zeros(max(nbytes), dtype=torch.uint8, device=t.device)
    buf[:nbytes[world.rank]] = t.contiguous().view(-1).view(torch.uint8)
    got = world.gather(buf, dst=0)
    if got is None:
        return None
    whole = torch.empty(lay.shape, dtype=t.dtype)
    for b, n, g in zip(lay.blocks, nbytes, got):
        b.place(whole, g[:n].cpu().view(t.dtype).view(b.shape(lay.shape)))
    return whole


def gather_tree(tree, layout, world):
    """The whole tree of a tree held by ``world``'s processes as ``layout``
    says (a tree of ``LeafShards`` of its structure), on world rank 0 (on
    the host where a leaf is cut; ``None`` on every other rank): the
    gather a save makes, every rank calling it together."""
    leaves = [_gather_leaf(a, lay, world) for a, lay in zip(jax_leaves(tree), jax_leaves(layout))]
    return jax_unflatten(tree, leaves) if world.rank == 0 else None


def _leaf_nbytes(leaf, lay) -> tuple:
    """``(this process's bytes, the whole leaf's bytes)`` of one leaf."""
    if isinstance(leaf, torch.Tensor):
        mine = leaf.numel() * leaf.element_size()
        whole = mine if _whole(lay) else math.prod(lay.shape) * leaf.element_size()
        return mine, whole
    n = np.asarray(leaf).nbytes
    return n, n


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
    one record per save and restore: ``{"op", "step", "seconds", "bytes",
    "file_bytes"}``.  ``world``: the group over every process of the run
    (module docstring), ``None`` for one process; every method but
    ``all_steps`` is then called by every rank together."""
    directory: str
    keep: int = 3
    log: List[Dict[str, Any]] = dataclasses.field(default_factory=list, repr=False)
    world: Any = dataclasses.field(default=None, repr=False)

    @property
    def lead(self) -> bool:
        return self.world is None or self.world.rank == 0

    def __post_init__(self):
        Path(self.directory).mkdir(parents=True, exist_ok=True)

    def _step_dir(self, step: int) -> Path:
        return Path(self.directory) / f"step_{step:08d}"

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, process_index: int = 0, layout: Any = None) -> str:
        """Writes ``tree`` as step ``step``.  ``layout``: how the world's
        processes hold each leaf of ``tree`` (a tree of ``LeafShards`` of
        its structure; ``None``: every leaf whole), whose whole leaves rank
        0 writes."""
        t0 = time.perf_counter()
        final = self._step_dir(step)
        tmp = Path(f"{final}.tmp{process_index}")
        leaves = jax_leaves(tree)
        lays = jax_leaves(layout) if layout is not None else [None] * len(leaves)
        assert len(lays) == len(leaves), (len(lays), len(leaves))
        if self.lead:
            tmp.mkdir(parents=True, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        mine = whole = 0
        with (zipfile.ZipFile(tmp / f"proc{process_index}.npz", "w",
                              compression=zipfile.ZIP_STORED, allowZip64=True)
              if self.lead else contextlib.nullcontext()) as zf:
            for i, (leaf, lay) in enumerate(zip(leaves, lays)):
                n_mine, n_whole = _leaf_nbytes(leaf, lay)
                mine, whole = mine + n_mine, whole + n_whole
                full = _gather_leaf(leaf, lay, self.world)
                if full is None:
                    continue
                arr, name = _host_array(full)
                with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                manifest["leaves"].append({"index": i, "shape": list(arr.shape),
                                           "dtype": name})
                del arr, full
        if self.lead:
            with open(tmp / "manifest.json", "w") as f:
                json.dump(manifest, f)
            if final.exists():         # re-save of the same step (e.g. after a restore)
                shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)      # atomic publish
        if self.world is not None:
            self.world.barrier()       # every rank returns once the step is listed
        if self.lead:
            self._gc()
        self.log.append({"op": "save", "step": step, "seconds": time.perf_counter() - t0,
                         "bytes": mine, "file_bytes": whole})
        return str(final)

    # --------------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None, *, target: Any,
                device=None, layout: Any = None) -> Any:
        """The checkpoint at ``step`` (default: the latest, rank 0's) as a
        tree of ``target``'s structure.  ``target`` holds tensors (``meta``
        ones will do), arrays or Python ints; it gives the structure and
        each whole leaf's shape and dtype, which the checkpoint must match.
        ``layout`` (as :meth:`save`'s): each leaf comes back as this
        process's block of it.  Every leaf goes to ``device``; with
        ``None``, to its target leaf's device (the CPU for a ``meta`` tensor
        or a non-tensor)."""
        t0 = time.perf_counter()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(d / "manifest.json") as f:
            manifest = json.load(f)
        want = jax_leaves(target)
        lays = jax_leaves(layout) if layout is not None else [None] * len(want)
        assert len(lays) == len(want), (len(lays), len(want))
        entries = manifest["leaves"]
        if len(entries) != len(want):
            raise ValueError(f"{d}: {len(entries)} leaves in the checkpoint, "
                             f"{len(want)} in the target")
        leaves, nbytes, whole = [], 0, 0
        with np.load(d / "proc0.npz") as data:
            for i, (e, like, lay) in enumerate(zip(entries, want, lays)):
                _check_leaf(i, e, like)
                arr = data[f"leaf_{e['index']}"]
                if list(arr.shape) != list(e["shape"]):
                    raise ValueError(f"{d}: leaf {i} is {list(arr.shape)}, the manifest "
                                     f"says {e['shape']}")
                whole += arr.nbytes
                if e["dtype"] == BF16:
                    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(arr)
                if not _whole(lay):
                    t = lay.mine.cut(t)
                nbytes += t.numel() * t.element_size()
                dev = device
                if dev is None:
                    dev = (like.device if isinstance(like, torch.Tensor)
                           and like.device.type != "meta" else "cpu")
                leaves.append(t.to(dev))
                del arr, t
        self.log.append({"op": "restore", "step": step, "seconds": time.perf_counter() - t0,
                         "bytes": nbytes, "file_bytes": whole})
        return jax_unflatten(target, leaves)

    # ------------------------------------------------------------------ meta
    def latest_step(self) -> Optional[int]:
        """The newest listed step (``None``: none); across processes rank
        0's, broadcast through the world."""
        steps = self.all_steps() if self.lead else []
        mine = steps[-1] if steps else None
        if self.world is None:
            return mine
        sent = torch.tensor(0 if mine is None else mine + 1, dtype=torch.int64,
                            device=self.world.device)
        got = int(self.world.all_reduce([sent])[0])
        return None if got == 0 else got - 1

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
