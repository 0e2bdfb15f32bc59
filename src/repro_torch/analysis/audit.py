"""Runtime audits of the pipelined step: the instruments, one audited step,
and the schedule matrix (reference: ``repro/analysis/audit.py``).

The reference traces each cell's loss-and-gradient program to a jaxpr and
walks it.  The port runs eagerly, so :func:`audit_step` runs one step of a
``make_terapipe_value_and_grad`` function under three instruments and
hands what they recorded to :mod:`.rules`:

* :func:`record_ring`: every ``LocalRing.shift`` (which ranks sent, on
  which ring) -> ``comm.ring-match`` against the schedule's tick table and
  ``comm_plan()``;
* :class:`SavedTensors`: ``torch.autograd.graph.saved_tensors_hooks`` over
  the step: each saved tensor's shape and dtype, and the peak bytes of the
  saved tensors alive at once (storages counted once, parameters not
  counted) -> ``buffer.score-matrix`` and ``buffer.repeated-kv`` (kernel
  cells only, as in the reference: the plain path materialises the scores
  by design) and ``scale.flat-in-d``.  Tensors saved inside a
  ``torch.utils.checkpoint`` region are held by the checkpoint's own hooks
  and do not reach these (the blocks under ``cfg.remat``); audit with
  remat off to see them;
* :class:`CastCensus`: a ``TorchDispatchMode`` counting ``aten._to_copy``
  by dtype pair -> ``dtype.upcast``.

A cell (:class:`Cell`) is one registered training schedule at one
``use_kernel`` setting on the reference's geometry: K 2 ranks, D 2
microbatches, M 5 slices of 8 tokens, 4 layers, Hq 4 / Hkv 2 (so a
repeated K/V would show), d_model 64, bf16, remat off.  ``run_matrix``
audits every cell and gives the JSON report that ``python -m
repro_torch.analysis`` writes.

The reference rules with no torch counterpart, and why, are listed in
the package's docstring (``repro_torch/analysis/__init__.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.pipeline import LocalRing
from repro_torch.tree import tree_leaves

from . import rules
from .findings import Finding, errors

#: the training schedules the matrix must hold clean
TRAIN_SCHEDULES = ("contiguous", "interleaved", "1f1b", "interleaved-1f1b", "zb-h1")


# ------------------------------------------------------------ instruments
@contextlib.contextmanager
def record_ring():
    """Within the block, every ``LocalRing.shift`` appends ``(step, ranks
    that sent a value)`` to the yielded list."""
    sends: List[tuple] = []
    shift = LocalRing.shift

    def recorded(ring, sent, step=1):
        sends.append((step, tuple(k for k, x in enumerate(sent) if x is not None)))
        return shift(ring, sent, step)

    LocalRing.shift = recorded
    try:
        yield sends
    finally:
        LocalRing.shift = shift


class _Held:
    """What autograd keeps for one saved tensor; freed with its graph node."""
    __slots__ = ("t", "__weakref__")

    def __init__(self, t: torch.Tensor):
        self.t = t


class SavedTensors:
    """``saved_tensors_hooks`` over a block: ``records`` holds one
    :class:`~.rules.SavedTensor` per save, ``peak_bytes`` the most bytes of
    saved storages alive at once (each storage once; those of ``exclude``,
    the parameters, not at all).  ``hq``/``hkv`` say which 4-D tensors to
    test for repeated head groups."""

    def __init__(self, *, hq: int, hkv: int, exclude: Sequence[torch.Tensor] = ()):
        self.hq, self.rep = hq, hq // hkv
        self.exclude = {t.untyped_storage().data_ptr() for t in exclude}
        self.records: List[rules.SavedTensor] = []
        self.live: Dict[tuple, int] = {}
        self.bytes = self.peak_bytes = 0
        self._hooks = torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)

    def _repeated(self, t: torch.Tensor) -> bool:
        if self.rep == 1 or t.dim() != 4 or t.shape[2] != self.hq:
            return False
        g = t.detach().unflatten(2, (self.hq // self.rep, self.rep))
        return torch.equal(g, g[:, :, :, :1].expand_as(g))

    def _pack(self, t: torch.Tensor):
        self.records.append(rules.SavedTensor(tuple(t.shape), self._repeated(t)))
        held = _Held(t.detach())     # no reference to its grad_fn: no cycle
        storage = t.untyped_storage()
        ptr = storage.data_ptr()
        if ptr and ptr not in self.exclude:
            key = (t.device, ptr)
            if not self.live.get(key):
                self.bytes += storage.nbytes()
                self.peak_bytes = max(self.peak_bytes, self.bytes)
            self.live[key] = self.live.get(key, 0) + 1
            weakref.finalize(held, self._release, key, storage.nbytes())
        return held

    def _release(self, key, nbytes: int) -> None:
        self.live[key] -= 1
        if not self.live[key]:
            del self.live[key]
            self.bytes -= nbytes

    @staticmethod
    def _unpack(held: _Held) -> torch.Tensor:
        return held.t

    def __enter__(self):
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        return self._hooks.__exit__(*exc)


class CastCensus(TorchDispatchMode):
    """Counts ``aten._to_copy`` calls that change the dtype, by
    ``"src->dst"`` (torch dtype names), in ``counts``."""

    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten._to_copy.default and args[0].dtype != out.dtype:
            name = lambda dt: str(dt).split(".")[-1]
            self.counts[f"{name(args[0].dtype)}->{name(out.dtype)}"] += 1
        return out


# -------------------------------------------------------------- one step
def audit_step(vg, params, batch, *, kernel_rules: bool) -> Dict[str, Any]:
    """One call of ``vg`` (a ``make_terapipe_value_and_grad`` function) on
    ``(params, batch)`` under the instruments, and the rules over what they
    recorded: ``ir.validate``, ``comm.ring-match``, ``dtype.upcast`` and,
    with ``kernel_rules``, ``buffer.score-matrix`` and
    ``buffer.repeated-kv``.  Returns ``{"findings", "loss",
    "saved_peak_bytes", "saved_tensors", "casts"}``."""
    p = vg.plan
    cfg = p.cfg
    saved = SavedTensors(hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                         exclude=list(tree_leaves(params)))
    census = CastCensus()
    with record_ring() as sends, saved, census:
        loss, grads = vg(params, batch)
    del grads
    findings = rules.check_ir(p.assign, p.DM)
    findings += rules.check_ring_match(sends, assign=p.assign, n_items=p.DM)
    if kernel_rules:
        pairs = {(l, ctx + l) for l, ctx in zip(p.slice_lens, p.starts)}
        findings += rules.check_score_matrix(saved.records, mb=p.mb, hq=cfg.n_heads,
                                             hkv=cfg.n_kv_heads, pairs=pairs)
        findings += rules.check_repeated_kv(saved.records, hq=cfg.n_heads,
                                            hkv=cfg.n_kv_heads, sks={sk for _, sk in pairs})
    findings += rules.check_dtype_casts(dict(census.counts))
    return {"findings": findings, "loss": float(loss), "saved_peak_bytes": saved.peak_bytes,
            "saved_tensors": len(saved.records), "casts": dict(census.counts)}


# ------------------------------------------------------------------ cells
@dataclasses.dataclass
class Cell:
    """One (schedule, use_kernel) audit cell's geometry."""
    schedule: str
    use_kernel: bool
    K: int = 2
    D: int = 2          # microbatches of 2 sequences
    M: int = 5          # token slices of 8 tokens: S = 40
    n_layers: int = 4

    def name(self) -> str:
        return f"{self.schedule}/kernel={'on' if self.use_kernel else 'off'}"


def build_audit_model(n_layers: int, use_kernel: bool, device):
    """The reference's audit model: dense, d_model 64, Hq 4 / Hkv 2, d_ff
    128, vocab 256, bf16, remat off."""
    from repro_torch.models import build_model
    from repro_torch.models.common import ModelConfig
    cfg = ModelConfig(name="audit", family="dense", n_layers=n_layers, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                      dtype=torch.bfloat16, remat=False, use_kernel=use_kernel)
    return build_model(cfg, device=device)


def cell_step(cell: Cell, model, params, D: int):
    """A cell's value-and-grad function and batch at D microbatches."""
    from repro_torch.core.pipeline import TeraPipeConfig, make_terapipe_value_and_grad
    from repro_torch.core.schedules import REGISTRY
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource
    B, S = 2 * D, 8 * cell.M
    tcfg = TeraPipeConfig(n_token_slices=cell.M, n_microbatches=D, schedule=cell.schedule,
                          virtual_stages=max(REGISTRY[cell.schedule].min_virtual, 1))
    vg = make_terapipe_value_and_grad(model, tcfg, S, B, cell.K)
    toks = DataPipeline(SyntheticSource(model.cfg.vocab_size, 0), B, S).batch_at(0)
    return vg, {k: torch.from_numpy(a).to(model.device) for k, a in toks.items()}


def audit_cell(cell: Cell, *, device) -> Dict[str, Any]:
    """Every rule on one cell: the audited step at D, and the peak saved
    bytes again at 2D for ``scale.flat-in-d`` (required of the
    explicit-backward schedules)."""
    model = build_audit_model(cell.n_layers, cell.use_kernel, device)
    params = model.init(seed=0)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    vg, batch = cell_step(cell, model, params, cell.D)
    rec = audit_step(vg, params, batch, kernel_rules=cell.use_kernel)
    vg2, batch2 = cell_step(cell, model, params, 2 * cell.D)
    saved = SavedTensors(hq=model.cfg.n_heads, hkv=model.cfg.n_kv_heads,
                         exclude=list(tree_leaves(params)))
    with saved:
        vg2(params, batch2)
    findings: List[Finding] = rec["findings"]
    findings += rules.check_flat_in_d(rec["saved_peak_bytes"], saved.peak_bytes,
                                      required=vg.plan.assign.has_backward,
                                      label=f"D {cell.D} -> {2 * cell.D}: ")
    p = vg.plan
    return {"cell": cell.name(), "schedule": cell.schedule, "use_kernel": cell.use_kernel,
            "geometry": {"K": cell.K, "D": cell.D, "M": cell.M, "S": 8 * cell.M, "l": 8,
                         "V": p.V, "hq": 4, "hkv": 2, "n_layers": cell.n_layers},
            "saved_peak_bytes": [rec["saved_peak_bytes"], saved.peak_bytes],
            "casts": rec["casts"], "findings": [f.to_dict() for f in findings],
            "ok": not errors(findings)}


def default_cells(schedules: Optional[Sequence[str]] = None) -> List[Cell]:
    """Every requested training schedule x use_kernel off/on."""
    return [Cell(name, use_kernel) for name in (schedules or TRAIN_SCHEDULES)
            for use_kernel in (False, True)]


def run_matrix(cells: Sequence[Cell], *, device, log=lambda msg: None) -> Dict[str, Any]:
    """Audit every cell; the JSON-ready report."""
    records = []
    for cell in cells:
        rec = audit_cell(cell, device=device)
        n_err = sum(f["severity"] == "error" for f in rec["findings"])
        log(f"  {rec['cell']}: {len(rec['findings'])} findings, {n_err} errors")
        records.append(rec)
    return {"torch": torch.__version__, "device": str(device),
            "rules": sorted(rules.rule_ids()), "cells": records,
            "ok": all(r["ok"] for r in records)}
