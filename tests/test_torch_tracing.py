"""The program's spans (``repro_torch/tracing.py``) under ``torch.profiler``.

* A whole-sequence ``train_step``, the in-process pipelined step (K 2,
  M 2; autograd over the tick loop, and the explicit backward units of
  1f1b and zb-h1), one pipe rank per thread on a ``ThreadRing`` (the
  transposed tick table) and a MoE layer record the spans they should, as
  often as they should, each inside the span it belongs to.
* ``DistRing.shift`` records the header's exchange, then the payload's
  (its ``_batch`` a loopback: no process group).
* With no profiler recording, ``record_function`` is never entered; and a
  step's loss and gradients are bit-identical with and without one.
"""
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.core.pipeline import (TeraPipeConfig, make_terapipe_value_and_grad,
                                       shard_params, value_and_grad)
from repro_torch.core.schedules import KIND_BWD, KIND_BWD_INPUT, KIND_BWD_WEIGHT, KIND_FWD
from repro_torch.distributed import transport
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.train import train_step
from repro_torch.models import build_model, moe
from repro_torch.optim.adamw import adamw
from repro_torch.tree import tree_leaves, tree_map

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

B, S = 2, 16


def _recorded(fn, all_threads=False):
    """``fn()``'s result and the program's spans it recorded, each
    ``(name, thread, start, end)``, by start (outer first)."""
    kw = {}
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        out = fn()
    spans = [(e.name()[len(tracing.PREFIX):], e.start_thread_id(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(tracing.PREFIX)]
    return out, sorted(spans, key=lambda s: (s[2], -s[3]))


def _parent(spans, s):
    """The innermost span on ``s``'s thread that holds ``s``, or None."""
    holders = [p for p in spans if p is not s and p[1] == s[1] and p[2] <= s[2]
               and s[3] <= p[3]]
    return max(holders, key=lambda p: p[2])[0] if holders else None


def _parents(spans, name):
    return Counter(_parent(spans, s) for s in spans if s[0] == name)


def _setup(arch="gpt3-1b"):
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32)
    model = build_model(cfg, "cpu")
    params = tree_map(lambda a: a.requires_grad_(True), model.init(0))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
             for k in ("tokens", "labels")}
    return model, params, batch


def _train(vg, params, batch):
    opt = adamw(3e-4)
    state = {"params": params, "opt_state": opt.init(params)}
    loss = train_step(vg, opt, state, batch)
    return loss, state["params"]


def test_whole_sequence_train_step_spans():
    model, params, batch = _setup()
    _, spans = _recorded(lambda: _train(value_and_grad(model.loss), params, batch))
    assert Counter(s[0] for s in spans) == {"step.value_and_grad": 1, "grad.forward": 1,
                                            "grad.backward": 1, "step.optimizer": 1}
    assert _parents(spans, "grad.forward") == {"step.value_and_grad": 1}
    assert _parents(spans, "grad.backward") == {"step.value_and_grad": 1}
    assert _parents(spans, "step.optimizer") == {None: 1}


@pytest.mark.parametrize("schedule", ["contiguous", "1f1b", "zb-h1"])
def test_in_process_pipelined_step_spans(schedule):
    model, params, batch = _setup()
    K, M = 2, 2
    vg = make_terapipe_value_and_grad(model, TeraPipeConfig(n_token_slices=M, schedule=schedule),
                                      S, B, K)
    p = vg.plan
    ticks = p.tab.shape[0] + p.tcfg.extra_ticks
    kinds = Counter(int(k) for k in p.tab[..., 2][p.tab[..., 0] >= 0])
    _, spans = _recorded(lambda: vg(params, batch))
    n = Counter(s[0] for s in spans)
    units = {"pipe.fwd": kinds.pop(KIND_FWD), "pipe.bwd": kinds.pop(KIND_BWD, 0),
             "pipe.bwd_input": kinds.pop(KIND_BWD_INPUT, 0),
             "pipe.bwd_weight": kinds.pop(KIND_BWD_WEIGHT, 0)}
    assert not kinds and units["pipe.fwd"] == K * M
    want = {**{u: c for u, c in units.items() if c},
            "pipe.shift": ticks * (2 if p.comm.rev_ring else 1)}
    if schedule == "contiguous":          # autograd over the tick loop, then the head
        want.update({"grad.forward": 1, "grad.backward": 1, "pipe.head": 1})
        outer = "grad.forward"
        head = next(s for s in spans if s[0] == "pipe.head")
        assert all(s[3] <= head[2] for s in spans if s[0] == "pipe.fwd")
    else:                                 # every unit's own gradients; the head in the last unit
        assert units["pipe.bwd"] + units["pipe.bwd_weight"] == K * M
        want.update({"pipe.prologue": 1, "pipe.finish": 1})
        outer = None
    assert n == want
    for name in [u for u, c in units.items() if c] + ["pipe.shift"]:
        assert _parents(spans, name) == {outer: n[name]}, name


def test_rank_per_thread_spans():
    model, params, batch = _setup()
    K, M = 2, 2
    mesh = Mesh(pipe=K)

    def rank_run(rank):
        vg = make_terapipe_value_and_grad(model, TeraPipeConfig(n_token_slices=M), S, B, mesh,
                                          {"pipe": rank})
        return vg(shard_params(params, vg.plan.shard_layout(params)), batch)

    ticks = make_terapipe_value_and_grad(model, TeraPipeConfig(n_token_slices=M), S, B,
                                         K).plan.tab.shape[0]
    _, spans = _recorded(lambda: transport.ThreadRing(K, timeout=60).run(rank_run),
                         all_threads=True)
    by_thread = {}
    for s in spans:
        by_thread.setdefault(s[1], []).append(s)
    assert len(by_thread) == K
    heads = 0
    for own in by_thread.values():
        n = Counter(s[0] for s in own)
        heads += n.pop("pipe.head", 0)
        assert n == {"pipe.prologue": 1, "pipe.fwd": M, "pipe.bwd": M, "pipe.shift": 2 * ticks,
                     "pipe.finish": 1}
        # every forward unit before the head, every backward unit after it
        last_fwd = max(s[3] for s in own if s[0] == "pipe.fwd")
        assert all(s[2] >= last_fwd for s in own if s[0] in ("pipe.bwd", "pipe.finish"))
        assert _parents(own, "pipe.bwd") == {None: M}
    assert heads == 1


def test_moe_layer_spans():
    cfg = get_config("deepseek-moe-16b", smoke=True).replace(dtype=torch.float32)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    _, spans = _recorded(lambda: moe.moe_ffn(p, cfg, x))
    order = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe.shared"]
    assert [s[0] for s in spans] == order
    assert all(a[3] <= b[2] for a, b in zip(spans, spans[1:]))        # one after another


class _Loopback:
    """``DistRing._batch`` for a ring of one: each ``irecv`` receives the
    batch's ``isend`` of the same position."""

    def __init__(self):
        self.batches = []

    def __call__(self, ops):
        sends = [t for op, t, _ in ops if op is torch.distributed.isend]
        recvs = [t for op, t, _ in ops if op is torch.distributed.irecv]
        for sent, got in zip(sends, recvs):
            got.copy_(sent)
        self.batches.append(len(ops))


@pytest.mark.parametrize("x", [torch.arange(12.0).reshape(3, 4), None])
def test_dist_ring_shift_spans_the_header_then_the_payload(monkeypatch, x):
    ring = transport.DistRing.__new__(transport.DistRing)
    ring.pg, ring.size, ring.rank, ring.ranks, ring.members = None, 1, 0, (0,), [0]
    ring.device = torch.device("cpu")
    loop = _Loopback()
    monkeypatch.setattr(ring, "_batch", loop)
    got, spans = _recorded(lambda: ring.shift([x]))
    assert [s[0] for s in spans] == ["ring.header", "ring.payload"]
    assert spans[0][3] <= spans[1][2]
    assert loop.batches == ([2, 2] if x is not None else [2, 0])
    assert (got[0] is None) if x is None else torch.equal(got[0], x)


class _Counted:
    """``record_function`` that counts its entries."""
    entered = 0

    def __init__(self, name):
        self.inner = torch.autograd.profiler.record_function(name)

    def __enter__(self):
        _Counted.entered += 1
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


def test_no_span_is_entered_without_a_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counted)
    model, params, batch = _setup("deepseek-moe-16b")
    vg = make_terapipe_value_and_grad(model, TeraPipeConfig(n_token_slices=2), S, B, 2)
    _Counted.entered = 0
    _train(vg, params, batch)
    assert _Counted.entered == 0
    _recorded(lambda: _train(vg, params, batch))
    assert _Counted.entered > 0


@pytest.mark.parametrize("mode", ["gspmd", "terapipe"])
def test_a_step_is_bit_identical_with_and_without_the_profiler(mode):
    model, params, batch = _setup()
    vg = (value_and_grad(model.loss) if mode == "gspmd" else
          make_terapipe_value_and_grad(model, TeraPipeConfig(n_token_slices=2), S, B, 2))
    loss, grads = vg(params, batch)
    (loss_p, grads_p), spans = _recorded(lambda: vg(params, batch))
    assert spans and torch.equal(loss, loss_p)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(grads_p)))
