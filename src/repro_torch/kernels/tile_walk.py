"""The tile walks of the bf16 forward, dQ and dK/dV kernels and the decode
kernel's split, in plain Python.

States which tiles each work unit of ``csrc/terapipe_attention_fwd.cu::
fwd_kernel_bf16``, ``csrc/terapipe_attention_bwd.cu::dq_kernel_bf16`` and
``::dkv_kernel_bf16`` loads, which of them each consumer warpgroup
computes, which of those it masks element by element, which units each
persistent block takes, and which keys each CTA of
``csrc/decode_attention.cu::decode_kernel``'s clusters reads, with the
kernels' own integer arithmetic (``_div`` truncates toward zero, as C
does).  Nothing here runs a kernel: the tests hold the walks against the
brute-force mask of :mod:`repro_torch.kernels.ref`, and ``chip_smoke.py``
prints them at the training shape.

The three persistent kernels deal their numbered units to at most one
block per SM in a zigzag (:func:`deal`).

dQ: the forward's walk (:func:`dq_walk` is :func:`fwd_walk` at ``DQ_BQ``
rows and :func:`dq_bk` keys): one unit per (b, hq, 128-row q tile), the
K/V ring up to the unit's frontier, each warpgroup up to its own.

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
DQ_BQ = 128         # query rows per dQ work unit
DQ_BK = 64          # keys per dQ K/V tile (32 at hd 160: dq_bk)
DKV_BK = 128        # keys per dK/dV work unit
GROUP = 64          # rows (forward, dQ) or keys (dK/dV) of one consumer warpgroup
DECODE_CLUSTER = 8  # CTAs of a decode cluster: one span of the keys each
DECODE_BOX = 32     # keys per TMA box of the decode kernel
DECODE_STAGE_BYTES = 72 * 1024   # K/V boxes in flight per decode CTA


def dq_bk(hd: int) -> int:
    """Keys per streamed K/V tile of the dQ kernel: at hd 160 the dQ
    accumulator leaves less room for S and dP."""
    return DQ_BK if hd <= 128 else 32


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


def dq_walk(l: int, ctx: int, hd: int) -> List[FwdUnit]:
    """The dQ kernel's work units of one (b, hq): the forward's walk at its
    own tiles."""
    return fwd_walk(l, ctx, DQ_BQ, dq_bk(hd), GROUP)


def decode_spans(kv_len: int, cluster: int = DECODE_CLUSTER,
                 box: int = DECODE_BOX) -> List[Tuple[int, int]]:
    """The [start, end) keys each rank of a decode cluster reads, in rank
    order: ``ceil(kv_len / cluster)`` keys rounded up to the box, the last
    ranks' spans cut at ``kv_len`` or empty."""
    span = _div(_div(kv_len + cluster - 1, cluster) + box - 1, box) * box
    spans = []
    for rank in range(cluster):
        k0 = min(rank * span, kv_len)
        spans.append((k0, min(k0 + span, kv_len)))
    return spans


def decode_warps(hd: int, itemsize: int) -> int:
    """Warps of a decode CTA, one ring stage (a K and a V box) each: as
    many as DECODE_STAGE_BYTES hold, 2 to 8; warp w takes boxes w, w + W,
    ... of its rank's span."""
    return min(8, max(2, DECODE_STAGE_BYTES // (2 * DECODE_BOX * hd * itemsize)))


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
    """Counts of the three walks at one shape, over every (b, head):
    forward, dQ and dK/dV units, tiles loaded, tiles computed by the
    warpgroups and how many of those are masked element by element."""
    fwd = fwd_walk(l, ctx)
    dq = dq_walk(l, ctx, hd)
    sk = ctx + l
    dkv = dkv_walk(l, ctx, sk, hq // hkv, dkv_bq(hd))
    f_comp = [v for blk in fwd for g in blk.groups for v in g]
    q_comp = [v for blk in dq for g in blk.groups for v in g]
    d_comp = [v for blk in dkv for g in blk.groups for v in g]
    return dict(
        fwd_units=batch * hq * len(fwd),
        fwd_tiles_loaded=batch * hq * sum(b.n_loaded for b in fwd),
        fwd_tiles_computed=batch * hq * len(f_comp),
        fwd_tiles_masked=batch * hq * sum(m for _, m in f_comp),
        dq_units=batch * hq * len(dq),
        dq_tiles_loaded=batch * hq * sum(b.n_loaded for b in dq),
        dq_tiles_computed=batch * hq * len(q_comp),
        dq_tiles_masked=batch * hq * sum(m for _, m in q_comp),
        dkv_units=batch * hkv * len(dkv),
        dkv_items_loaded=batch * hkv * sum(len(b.items) for b in dkv),
        dkv_items_computed=batch * hkv * len(d_comp),
        dkv_items_masked=batch * hkv * sum(m for _, m in d_comp))
