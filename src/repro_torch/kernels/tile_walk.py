"""The tile walk of the bf16 forward and dK/dV kernels, in plain Python.

States which tiles each work unit of ``csrc/terapipe_attention_fwd.cu::
fwd_kernel_bf16`` and ``csrc/terapipe_attention_bwd.cu::dkv_kernel_bf16``
loads, which of them each consumer warpgroup computes, which of those it
masks element by element, and which units each persistent block takes, with the kernels' own integer arithmetic (``_div``
truncates toward zero, as C does).  Nothing here runs a kernel: the tests
hold the walk against the brute-force mask of :mod:`repro_torch.kernels.ref`,
and ``chip_smoke.py`` prints it at the training shape.

Both kernels deal their numbered units to at most one block per SM in a
zigzag (:func:`deal`).

Forward: one work unit per (b, hq, ``bq``-row q tile), numbered longest
frontier first; :func:`fwd_walk` lists one (b, hq)'s units; the producer
loads the key tiles up to the unit's causal frontier ``ctx + min(q0 + bq,
l)``; warpgroup ``w`` owns rows ``q0 + group*w`` .. ``+ group - 1`` and
computes the prefix of those tiles up to its own frontier (one tile, on
zero rows, if its rows all lie past ``l``).

dK/dV: one work unit per (b, hkv, ``bk``-key tile), numbered key tile
first; a unit wholly at and past ``ctx + l`` only writes zeros.  Its producer streams the items (query head
of the group, q tile) from the first q tile that reaches the key tile;
warpgroup ``w`` owns keys ``k0 + group*w`` .. ``+ group - 1`` and computes
the items whose rows see one of them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

FWD_BQ = 128        # query rows per forward work unit
FWD_BK = 128        # keys per forward K/V tile
DKV_BK = 128        # keys per dK/dV work unit
GROUP = 64          # rows (forward) or keys (dK/dV) of one consumer warpgroup


def dkv_bq(hd: int) -> int:
    """Query rows per streamed Q/dO tile of the dK/dV kernel."""
    return 64 if hd <= 128 else 32


def _div(a: int, b: int) -> int:
    """C's integer division: truncates toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


@dataclass(frozen=True)
class FwdUnit:
    """One forward work unit: its q tile, the key tiles its producer loads
    (``0 .. n_loaded - 1``) and, per warpgroup, the (key tile, masked)
    pairs it computes."""
    iq: int
    n_loaded: int
    groups: Tuple[Tuple[Tuple[int, bool], ...], ...]


@dataclass(frozen=True)
class DkvUnit:
    """One dK/dV work unit: its key tile, the (query head in the group, q
    tile) items its producer streams, in order, and per warpgroup the (item
    index, masked) pairs it computes; ``zeros_only`` for a unit past ``ctx +
    l``."""
    ik: int
    zeros_only: bool
    items: Tuple[Tuple[int, int], ...]
    groups: Tuple[Tuple[Tuple[int, bool], ...], ...]


def fwd_walk(l: int, ctx: int, bq: int = FWD_BQ, bk: int = FWD_BK,
             group: int = GROUP) -> List[FwdUnit]:
    """The forward's work units of one (b, hq), longest frontier first."""
    nq = _div(l + bq - 1, bq)
    units = []
    for z in range(nq):
        iq = nq - 1 - z                              # longest frontier first
        q0 = iq * bq
        kv_end = ctx + min(q0 + bq, l)               # the tile's causal frontier
        n_tiles = _div(kv_end + bk - 1, bk)
        groups = []
        for wg in range(bq // group):
            w0 = q0 + group * wg
            w_end = ctx + min(w0 + group, l)
            n_w = min(_div(w_end + bk - 1, bk), n_tiles) if w0 < l else 1
            groups.append(tuple((it, it * bk + bk - 1 > ctx + w0 or w0 + group > l)
                                for it in range(n_w)))
        units.append(FwdUnit(iq, n_tiles, tuple(groups)))
    return units


def deal(n_units: int, grid: int) -> List[List[int]]:
    """The unit numbers each of ``grid`` persistent blocks takes, in
    order: pass k of block x takes k*grid + x, or k*grid + grid - 1 - x on
    odd passes, while below ``n_units``."""
    deal = []
    for x in range(grid):
        mine, k = [], 0
        while True:
            i = k * grid + ((grid - 1 - x) if k & 1 else x)
            if i >= n_units:
                break
            mine.append(i)
            k += 1
        deal.append(mine)
    return deal


def dkv_walk(l: int, ctx: int, sk: int, rep: int, bq: int, bk: int = DKV_BK,
             group: int = GROUP) -> List[DkvUnit]:
    """The dK/dV kernel's work units of one (b, hkv), in their order; ``rep``
    query heads per kv head, ``sk`` keys."""
    valid_end = ctx + l
    units = []
    for ik in range(_div(sk + bk - 1, bk)):
        k0 = ik * bk
        if k0 >= valid_end:
            units.append(DkvUnit(ik, True, (), ()))
            continue
        iq_first = _div(max(k0 - ctx, 0), bq)        # clamped before the division
        per_head = _div(l + bq - 1, bq) - iq_first
        items = tuple((it // per_head, iq_first + it % per_head)
                      for it in range(rep * per_head))
        groups = []
        for wg in range(bk // group):
            kw0 = k0 + group * wg
            visits = []
            for it, (_, iq) in enumerate(items):
                q0 = iq * bq
                if kw0 < valid_end and kw0 < ctx + min(q0 + bq, l):
                    visits.append((it, kw0 + group - 1 > ctx + q0 or q0 + bq > l))
            groups.append(tuple(visits))
        units.append(DkvUnit(ik, False, items, tuple(groups)))
    return units


def summary(l: int, ctx: int, hq: int, hkv: int, hd: int, batch: int = 1) -> dict:
    """Counts of both walks at one shape, over every (b, head): forward
    and dK/dV units, tiles loaded, tiles computed by the warpgroups
    and how many of those are masked element by element."""
    fwd = fwd_walk(l, ctx)
    sk = ctx + l
    dkv = dkv_walk(l, ctx, sk, hq // hkv, dkv_bq(hd))
    f_comp = [v for blk in fwd for g in blk.groups for v in g]
    d_comp = [v for blk in dkv for g in blk.groups for v in g]
    return dict(
        fwd_units=batch * hq * len(fwd),
        fwd_tiles_loaded=batch * hq * sum(b.n_loaded for b in fwd),
        fwd_tiles_computed=batch * hq * len(f_comp),
        fwd_tiles_masked=batch * hq * sum(m for _, m in f_comp),
        dkv_units=batch * hkv * len(dkv),
        dkv_items_loaded=batch * hkv * sum(len(b.items) for b in dkv),
        dkv_items_computed=batch * hkv * len(d_comp),
        dkv_items_masked=batch * hkv * sum(m for _, m in d_comp))
