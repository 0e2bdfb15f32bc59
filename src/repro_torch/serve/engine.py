"""Continuous-batching decode engine on the schedule IR (reference:
``repro/serve/engine.py``).

The loop every serving system runs — admit, prefill, decode, complete:

* **prefill** is TeraPipe token slicing: a new request's prompt is chunked
  by ``dp.plan_prefill`` (Algorithm 1 under the ``slo_tmax`` stall bound)
  and each chunk runs the sliced stage computation
  (``apply_groups_sliced`` at the chunk's context offset);
* **decode** is token-synchronous: every round, all in-flight requests
  advance one token through ``model.decode_step`` with a per-slot position
  vector, at one fixed shape whose rows are independent;
* **KV** lives in the paged pool (:mod:`repro_torch.serve.kv_cache`),
  gathered to the dense view each call, with only the newly produced
  positions scattered back;
* every unit of work is appended to a :class:`StreamUnit` trace, so
  ``engine.schedule()`` is a real ``streaming`` schedule whose
  ``validate()`` audits the IR's ring delivery and the serving invariants.

Bit-identity contract: every round runs at the SAME shape — ``max_batch``
slots, per-slot positions, an active mask — and every per-slot op is
row-independent, so a request's tokens depend only on its own prompt.  The
sequential baseline is THIS engine with ``max_concurrency=1``; continuous
batching must reproduce its tokens bit for bit.  Greedy decoding takes the
first index of a tied maximum (``torch.argmax``, as ``jnp.argmax``).

The reference jit-compiles ``_round`` and ``_chunk``; here they are plain
methods run eagerly on the model's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import dp as dp_mod
from repro_torch.core.schedules import (StreamingSchedule, StreamUnit,
                                        decode_round, prefill_unit, streaming)
from repro_torch.device import resolve_device
from repro_torch.models.lm import apply_groups_sliced

from .kv_cache import PagedKVCache, gather_pages, scatter_prefill, scatter_token


@dataclasses.dataclass
class Request:
    """One generation request and its in-flight state."""
    rid: int
    prompt: List[int]
    max_new_tokens: int
    arrival: float = 0.0
    # -- engine state --
    ctx: int = 0                     # tokens whose KV exists in the pages
    chunks: List[int] = dataclasses.field(default_factory=list)
    generated: List[int] = dataclasses.field(default_factory=list)
    next_token: Optional[int] = None  # pending input of the next round
    slot: int = -1
    prefilled: bool = False
    submit_round: int = -1
    first_token_round: int = -1
    finish_round: int = -1

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine geometry and policy (fields as the reference's).

    ``max_batch``       — decode-round slot count (the fixed round shape).
    ``max_concurrency`` — admission cap; ``None`` = ``max_batch``; ``1`` is
                          the sequential baseline.
    ``max_len``         — per-request logical cache length (page-aligned).
    ``n_pages`` / ``page_size`` — the physical pool (page 0 reserved).
    ``slo_tmax``        — largest per-chunk stall, in units of the chunk
                          cost model ``overhead + l·(ctx+l)``; ``None`` =
                          one chunk per prompt.
    ``chunk_overhead``  — per-chunk launch cost in the same units.
    ``n_ranks``         — notional pipeline depth for the DP plan and the
                          ``streaming``-schedule trace.
    """
    max_batch: int = 4
    max_len: int = 128
    page_size: int = 16
    n_pages: int = 64
    n_ranks: int = 1
    slo_tmax: Optional[float] = None
    chunk_overhead: float = 32.0
    max_concurrency: Optional[int] = None

    def __post_init__(self):
        if self.max_len % self.page_size:
            raise ValueError(f"max_len {self.max_len} not a multiple of "
                             f"page_size {self.page_size}")
        cap = self.max_concurrency
        if cap is not None and not 1 <= cap <= self.max_batch:
            raise ValueError(f"max_concurrency {cap} outside [1, {self.max_batch}]")


class DecodeEngine:
    """Continuous-batching engine over one model + params (see module doc).

    Runs on ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``), which must be the model's.  Drive it with
    :meth:`submit` + :meth:`run`, or :meth:`step` per round.
    """

    def __init__(self, model, params, cfg: EngineConfig, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on {self.device}")
        if model.cfg.family != "dense":
            raise ValueError(f"serve engine drives the dense decoder family; "
                             f"got family={model.cfg.family!r}")
        self.model, self.params, self.cfg = model, params, cfg
        self.kv = PagedKVCache(model, n_pages=cfg.n_pages, page_size=cfg.page_size,
                               max_len=cfg.max_len, dtype=model.cfg.dtype)
        self.waiting: List[Request] = []
        self.running: List[Request] = []          # admission order
        self.finished: Dict[int, Request] = {}
        self.units: List[StreamUnit] = []
        self.rounds = 0
        self._slots = list(range(cfg.max_batch))  # free slots, ascending
        self._next_rid = 0

    def _tensor(self, a, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

    def _round(self, table, tokens, pos, active):
        """One decode round over all slots; returns the greedy next tokens."""
        dense = gather_pages(self.kv.phys, table)
        logits, dense = self.model.decode_step(
            self.params, dense, {"tokens": tokens[:, None]}, pos)
        scatter_token(self.kv.phys, dense, table, pos, active)
        return torch.argmax(logits[:, -1, :], dim=-1)

    def _chunk(self, table_row, tokens_chunk, ctx: int):
        """One prefill chunk of one request; returns its last position's logits."""
        model = self.model
        dense = gather_pages(self.kv.phys, table_row[None, :])
        x = model.embed(self.params, {"tokens": tokens_chunk[None, :]}, ctx)
        x, dense = apply_groups_sliced(model, self.params, x, dense, ctx)
        scatter_prefill(self.kv.phys, dense, table_row, ctx, tokens_chunk.shape[0])
        return model.head(self.params, x[:, -1:, :])[0, -1]

    # ------------------------------------------------------------ intake
    def _plan_chunks(self, prompt_len: int) -> List[int]:
        """Prefill chunk plan: DP under the SLO stall bound, or one chunk
        in pure-throughput mode."""
        if self.cfg.slo_tmax is None or prompt_len == 1:
            return [prompt_len]
        oh = self.cfg.chunk_overhead
        plan = dp_mod.plan_prefill(
            lambda l, c: oh + l * (c + l), prompt_len, self.cfg.n_ranks,
            slo_tmax=self.cfg.slo_tmax)
        return list(plan.slices)

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               arrival: float = 0.0) -> int:
        """Queue a request; returns its id.  Tokens appear in
        ``finished[rid].generated`` once it completes."""
        prompt = [int(t) for t in prompt]
        if not prompt or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new_tokens >= 1")
        if len(prompt) + max_new_tokens - 1 > self.cfg.max_len:
            raise ValueError(f"prompt {len(prompt)} + {max_new_tokens} new tokens "
                             f"exceeds max_len {self.cfg.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        r = Request(rid, prompt, max_new_tokens, arrival,
                    chunks=self._plan_chunks(len(prompt)))
        r.submit_round = self.rounds
        self.waiting.append(r)
        return rid

    # ------------------------------------------------------------ rounds
    def _admit(self) -> None:
        cap = self.cfg.max_concurrency or self.cfg.max_batch
        while self.waiting and self._slots and len(self.running) < cap:
            r = self.waiting[0]
            # fresh: pages for the whole prompt; resumed: its pages exist,
            # the next decode write may need one more
            need = max(len(r.prompt), r.ctx + 1)
            if not self.kv.can_ensure(r.rid, need):
                break
            self.kv.ensure(r.rid, need)
            self.waiting.pop(0)
            r.slot = self._slots.pop(0)
            self.running.append(r)

    def _prefill_one(self) -> None:
        """Run ONE prefill chunk per round: the SLO knob bounded its
        length, so this is the stall in-flight requests actually see."""
        for r in self.running:
            if not r.chunks:
                continue
            length = r.chunks.pop(0)
            tokens = self._tensor(r.prompt[r.ctx:r.ctx + length])
            row = self._tensor(self.kv.table_row(r.rid))
            last_logits = self._chunk(row, tokens, r.ctx)
            final = not r.chunks
            self.units.append(prefill_unit(r.rid, r.ctx, length, final))
            r.ctx += length
            if final:
                r.prefilled = True
                r.first_token_round = self.rounds
                tok = int(torch.argmax(last_logits))
                r.generated.append(tok)
                r.next_token = tok
                self._maybe_finish(r)
            return

    def _decode_round(self) -> None:
        live = [r for r in self.running if r.prefilled and not r.done]
        # each slot writes its token's KV at pos=ctx; a request whose pool
        # growth would fail skips rounds until a sibling frees pages
        ready = [r for r in live if self.kv.can_ensure(r.rid, r.ctx + 1)]
        if live and not ready:
            raise MemoryError(
                f"all {len(live)} in-flight requests blocked on KV pages "
                f"({self.kv.free_pages} free of {self.cfg.n_pages - 1}); "
                f"pool too small for the admitted working set")
        if not ready:
            return
        for r in ready:
            self.kv.ensure(r.rid, r.ctx + 1)
        B = self.cfg.max_batch
        tokens = np.zeros(B, np.int64)
        pos = np.zeros(B, np.int64)
        active = np.zeros(B, bool)
        rids = [-1] * B
        for r in ready:
            tokens[r.slot] = r.next_token
            pos[r.slot] = r.ctx
            active[r.slot] = True
            rids[r.slot] = r.rid
        nxt = self._round(self._tensor(self.kv.table_array(rids)), self._tensor(tokens),
                          self._tensor(pos), self._tensor(active, torch.bool)).cpu()
        self.units.append(decode_round([r.rid for r in ready],
                                       [r.ctx for r in ready]))
        for r in ready:
            r.ctx += 1
            tok = int(nxt[r.slot])
            r.generated.append(tok)
            r.next_token = tok
            self._maybe_finish(r)

    def _maybe_finish(self, r: Request) -> None:
        if not r.done:
            return
        r.finish_round = self.rounds
        self.kv.free(r.rid)
        self.running.remove(r)
        self._slots.append(r.slot)
        self._slots.sort()
        r.slot = -1
        self.finished[r.rid] = r

    def preempt(self, rid: int) -> None:
        """Evict a running request: free its SLOT, keep its KV pages.  It
        rejoins the head of the waiting queue and resumes decoding from
        the paged cache on re-admission (no re-prefill)."""
        r = next(x for x in self.running if x.rid == rid)
        self.running.remove(r)
        self._slots.append(r.slot)
        self._slots.sort()
        r.slot = -1
        self.waiting.insert(0, r)

    def step(self) -> None:
        """One engine round: admit under the memory budget, run one
        SLO-bounded prefill chunk, run one token-synchronous decode round."""
        self._admit()
        self._prefill_one()
        self._decode_round()
        self.rounds += 1

    def run(self, max_rounds: int = 100_000) -> None:
        """Drive rounds until every submitted request finished."""
        while self.waiting or self.running:
            if self.rounds >= max_rounds:
                raise RuntimeError(f"engine failed to drain in {max_rounds} rounds")
            self.step()

    # ------------------------------------------------------------- trace
    def schedule(self) -> StreamingSchedule:
        """The run's work trace as a ``streaming`` schedule; ``validate()``
        audits ring delivery AND the serving invariants."""
        return streaming(self.cfg.n_ranks, self.model.cfg.n_layers,
                         tuple(self.units))
