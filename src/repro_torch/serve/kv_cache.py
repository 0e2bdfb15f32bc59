"""Paged KV cache for the serving engine (reference:
``repro/serve/kv_cache.py``): vLLM-style paging on the model's dense cache
layout.

Every cache leaf ``(count, batch, max_len, kv_heads, hd)`` becomes a
physical pool ``(count, n_pages, page_size, kv_heads, hd)`` plus
per-request page tables (logical page ``i`` of request ``r`` lives in
physical page ``table[r][i]``).  Admission allocates pages, growth
allocates lazily, completion frees them; preemption keeps them, so a
re-admitted request resumes decoding from the pool.

The engine computes on the DENSE view: :func:`gather_pages` reassembles a
batch's logical caches from the pool (a pure gather, so values do not
depend on which physical pages back them), the model runs unchanged on
that view, and :func:`scatter_token` / :func:`scatter_prefill` write back
only the newly produced positions — in place into the pool, which this
module owns.

Physical page 0 is RESERVED and stays zero: unallocated page-table entries
and the tables of inactive slots point at it, so an inactive slot's masked
write-back lands there, rewriting the old value, and never touches a live
request's page.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a cache tree (lists/tuples of tensors)."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def gather_pages(phys, table: torch.Tensor):
    """Reassemble dense logical caches from the pool.

    ``table`` is integer ``(B, P)`` (slot page tables, padded with the
    reserved page 0); each leaf ``(count, n_pages, ps, ...)`` gathers to
    ``(count, B, P·ps, ...)``, the dense cache the model expects."""
    b, p = table.shape
    idx = table.long()

    def g(leaf):
        count, _, ps = leaf.shape[:3]
        return leaf[:, idx].reshape((count, b, p * ps) + tuple(leaf.shape[3:]))
    return _tree_map(g, phys)


def scatter_token(phys, dense, table: torch.Tensor, pos: torch.Tensor,
                  active: torch.Tensor):
    """Write one decoded token per slot back to the pool, in place.

    Slot ``b`` holds its new KV at ``pos[b]`` of the dense view; it goes to
    physical page ``table[b, pos[b]//ps]`` row ``pos[b]%ps``.  Inactive
    slots write their target's OLD value: their tables point at reserved
    page 0, so several of them may hit one address, which is harmless only
    because they all write the value already there — keep the ``where``."""
    b = table.shape[0]
    rows = torch.arange(b, device=table.device)
    pos = pos.long()

    def s(pleaf, dleaf):
        ps = pleaf.shape[2]
        pids = table[rows, pos // ps].long()
        slots = pos % ps
        new = dleaf[:, rows, pos]                    # (count, B, ...tail)
        old = pleaf[:, pids, slots]
        keep = active.reshape((1, b) + (1,) * (new.dim() - 2))
        pleaf[:, pids, slots] = torch.where(keep, new, old)
        return pleaf
    return _tree_map(s, phys, dense)


def scatter_prefill(phys, dense, table_row: torch.Tensor, ctx: int, length: int):
    """Write one request's prefill chunk ``[ctx, ctx+length)`` back to the
    pool, in place (``dense`` is that request's B=1 view)."""
    positions = ctx + torch.arange(length, device=table_row.device)

    def s(pleaf, dleaf):
        ps = pleaf.shape[2]
        pids = table_row[positions // ps].long()
        pleaf[:, pids, positions % ps] = dleaf[:, 0, positions]
        return pleaf
    return _tree_map(s, phys, dense)


class PagedKVCache:
    """Page pool + allocator + per-request page tables.

    ``phys`` (the pool) lives on the model's device and is updated in place
    by the scatters; the allocator (free list, page tables) is host-side
    Python.
    """

    def __init__(self, model, *, n_pages: int, page_size: int,
                 max_len: int, dtype=torch.bfloat16):
        if n_pages < 2:
            raise ValueError("need at least one allocatable page past the "
                             "reserved dummy (page 0)")
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} not a multiple of page_size {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.max_len = max_len
        self.pages_per_slot = max_len // page_size
        template = model.init_caches(1, page_size, dtype=dtype)
        self.phys = _tree_map(
            lambda leaf: leaf.new_zeros((leaf.shape[0], n_pages) + tuple(leaf.shape[2:])),
            template)
        self._free: List[int] = list(range(n_pages - 1, 0, -1))  # pop() = 1
        self._tables: Dict[int, List[int]] = {}

    # ---------------------------------------------------------- allocator
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.used_pages / (self.n_pages - 1)

    def pages_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.page_size)

    def capacity(self, rid: int) -> int:
        """Tokens the request's current pages can hold."""
        return len(self._tables.get(rid, ())) * self.page_size

    def can_ensure(self, rid: int, n_tokens: int) -> bool:
        need = self.pages_for(n_tokens) - len(self._tables.get(rid, ()))
        return need <= len(self._free)

    def ensure(self, rid: int, n_tokens: int) -> None:
        """Grow ``rid``'s page table to hold ``n_tokens`` (lazy alloc)."""
        if n_tokens > self.max_len:
            raise ValueError(f"request {rid}: {n_tokens} tokens > max_len {self.max_len}")
        t = self._tables.setdefault(rid, [])
        while len(t) * self.page_size < n_tokens:
            if not self._free:
                raise MemoryError(
                    f"out of KV pages growing request {rid} to "
                    f"{n_tokens} tokens ({self.n_pages - 1} allocatable)")
            t.append(self._free.pop())

    def free(self, rid: int) -> None:
        """Return a finished request's pages to the pool (stale contents
        are never read: every consumer masks beyond its own context)."""
        for p in self._tables.pop(rid, []):
            self._free.append(p)

    # ------------------------------------------------------------- views
    def table_row(self, rid: int) -> np.ndarray:
        """(pages_per_slot,) int32 page table, padded with reserved 0."""
        row = np.zeros(self.pages_per_slot, np.int32)
        t = self._tables.get(rid, ())
        row[:len(t)] = t
        return row

    def table_array(self, rids) -> np.ndarray:
        """(B, pages_per_slot) int32 slot table; ``rid < 0`` marks an
        inactive slot (all reserved page 0)."""
        rows = [self.table_row(r) if r >= 0 else
                np.zeros(self.pages_per_slot, np.int32) for r in rids]
        return np.stack(rows).astype(np.int32)
