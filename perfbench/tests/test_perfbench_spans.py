"""The reduction of the program's spans (``perfbench/spans.py``) on a
hand-made timeline with correlation ids and two threads, and the span
metrics' readers on it."""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT)]

from perfbench import cells, spans, trace  # noqa: E402

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
STEP, AUTOGRAD = 1, 2                        # the profiler's thread ids


class _Event:
    def __init__(self, name, start, end, tid=STEP, kind="cpu_op", corr=0, linked=0,
                 device=CPU):
        self._n, self._s, self._e, self._t = name, start, end, tid
        self._k, self._c, self._l, self._d = kind, corr, linked, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def activity_type(self):
        return self._k

    def is_user_annotation(self):
        return self._k in ("user_annotation", "gpu_user_annotation")

    def start_thread_id(self):
        return self._t

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def _span(name, start, end, tid=STEP, corr=0):
    return _Event(spans.PREFIX + name, start, end, tid, "user_annotation", corr)


def _launch(op, start, end, tid, op_corr, rt_corr):
    """An operator and the runtime call inside it, linked to it (ids of two
    counters that overlap: the profiler's and CUPTI's)."""
    return [_Event(op, start, end, tid, "cpu_op", op_corr),
            _Event("cudaLaunchKernel", start + 10, start + 20, tid, "cuda_runtime", rt_corr,
                   op_corr)]


def _device(name, start, end, rt_corr, op_corr, kind="kernel"):
    return _Event(name, start, end, kind=kind, corr=rt_corr, linked=op_corr, device=CUDA)


def _timeline():
    """A 1000-ns window.  The step's thread: value-and-grad (forward with a
    unit holding a MoE route, then backward), the optimizer holding a ring
    header.  Autograd's thread: a backward op under no span, then a
    recompute under a route span of its own.  On the device: a GEMM, the
    backward's kernel, the recompute's, an NCCL kernel partly hidden by the
    optimizer's (its runtime call not in the trace: its linked operator is
    the header's span), one that no launch claims, and work outside the
    window."""
    return [
        _Event(trace.WINDOW_SPAN, 0, 1000, kind="user_annotation"),
        _Event(trace.SPAN_PREFIX + "step", 0, 1000, kind="user_annotation"),
        _span("step.value_and_grad", 0, 600), _span("grad.forward", 0, 300),
        _span("pipe.fwd", 40, 200), _span("moe.route", 50, 150),
        *_launch("aten::mm", 60, 100, STEP, 11, 101),
        _span("grad.backward", 300, 600),
        *_launch("aten::mul", 320, 360, AUTOGRAD, 13, 103),
        _span("moe.route", 400, 450, AUTOGRAD),
        *_launch("aten::mm", 410, 440, AUTOGRAD, 14, 104),
        _span("step.optimizer", 600, 1000),
        *_launch("aten::add_", 605, 615, STEP, 12, 102),
        _span("ring.header", 620, 700, corr=15),
        _device("gemm", 100, 250, 101, 11),
        _device("mul", 350, 400, 103, 13),
        _device("mm_recompute", 450, 500, 104, 14),
        _device("ncclDevKernel_SendRecv", 700, 900, 106, 15),
        _device("adam", 800, 850, 102, 12),
        _device("orphan", 950, 980, 999, 0),
        _device(spans.PREFIX + "moe.route", 100, 250, 0, 0, "gpu_user_annotation"),
        _device("late", 1200, 1300, 101, 11),
    ]


def test_spans_by_launch():
    s = spans.reduce(_prof(_timeline()), steps=2)["spans"]
    ns = lambda v: pytest.approx(v * 1e-9)
    assert s["moe.route"] == {"n": 2, "host_s": ns(150), "device_s": ns(200),
                              "device_incl_s": ns(200), "nccl_excl_s": 0.0}
    assert s["pipe.fwd"]["host_s"] == ns(160) and s["pipe.fwd"]["device_incl_s"] == ns(150)
    assert s["pipe.fwd"]["device_s"] == 0.0                  # its GEMM ran inside the route
    assert s["grad.forward"]["device_incl_s"] == ns(150)
    # autograd's thread: the backward op under no span is the step's
    # grad.backward; the recompute under its own route, inside it
    assert s["grad.backward"]["device_s"] == ns(50)
    assert s["grad.backward"]["device_incl_s"] == ns(100)
    assert s["step.value_and_grad"]["device_incl_s"] == ns(250)
    assert s["step.value_and_grad"]["device_s"] == 0.0
    assert s["step.optimizer"]["device_s"] == ns(50) and s["step.optimizer"]["device_incl_s"] \
        == ns(250)
    # the header's NCCL kernel runs alone 700..800 and 850..900
    assert s["ring.header"]["device_s"] == ns(200) and s["ring.header"]["nccl_excl_s"] == ns(150)
    assert s["step.optimizer"]["nccl_excl_s"] == 0.0
    assert sum(v["n"] for v in s.values()) == 8


def test_attribution_idle_gaps_and_the_unattributed():
    r = spans.reduce(_prof(_timeline()), steps=2)
    assert r["attributed_s"] == pytest.approx(450e-9)
    assert r["unattributed"] == {"orphan": pytest.approx(30e-9)}
    summary = trace.summarize(_prof(_timeline()), steps=2)
    assert r["attributed_s"] + 30e-9 == pytest.approx(summary["busy_s"])
    assert r["idle_by_span"] == {"grad.backward": pytest.approx(250e-9),
                                 "grad.forward": pytest.approx(200e-9),
                                 "step.optimizer": pytest.approx(70e-9)}
    assert sum(r["idle_by_span"].values()) == pytest.approx(
        summary["window_s"] - summary["busy_s"])


def test_a_trace_without_program_spans():
    events = [e for e in _timeline() if not e.name().startswith(spans.PREFIX)]
    r = spans.reduce(_prof(events), steps=2)
    assert r["spans"] == {} and r["attributed_s"] == 0.0
    assert set(r["unattributed"]) == {"gemm", "mul", "mm_recompute", "ncclDevKernel_SendRecv",
                                      "adam", "orphan"}
    assert r["idle_by_span"] == {"-": pytest.approx(520e-9)}
    with pytest.raises(RuntimeError):
        spans.reduce(_prof(events[1:]), steps=2)


def _run(traces):
    cfg = cells.load_cell("gpt3-1b.terapipe-m8.4card")
    return {"cfg": cfg.config, "traffic": cfg.traffic, "chips": len(traces), "step_s": 1.0,
            "ranks": traces}


def test_span_readers():
    s = trace.summarize(_prof(_timeline()), steps=2)
    s["spans"] = spans.reduce(_prof(_timeline()), steps=2)
    read = lambda name, traces: cells.load_reader(name)(_run(traces))
    assert read("optimizer_ms", [s, s]) == pytest.approx(250e-9 / 2 * 1e3)
    assert read("moe_route_ms", [s]) == pytest.approx(200e-9 / 2 * 1e3)
    for name in ("unit_host_ratio", "unit_host_ratio.4card"):
        assert read(name, [s, s]) == pytest.approx(160 / 150)
    wait = read("shift_wait_share.4card", [s, s])
    assert wait == pytest.approx(15.0)
    assert wait <= read("comm_exposed_share.4card", [s, s])


@pytest.mark.parametrize("name", ["optimizer_ms", "moe_route_ms", "unit_host_ratio",
                                  "unit_host_ratio.4card", "shift_wait_share.4card"])
def test_span_readers_find_nothing_without_the_spans(name):
    s = trace.summarize(_prof(_timeline()), steps=2)
    assert cells.load_reader(name)(_run([s])) is None                 # no reduction at all
    events = [e for e in _timeline() if not e.name().startswith(spans.PREFIX)]
    s["spans"] = spans.reduce(_prof(events), steps=2)
    assert cells.load_reader(name)(_run([s])) is None                 # no program spans


def test_runtime_calls_are_told_from_operators_without_the_event_kind():
    class Bare(_Event):
        activity_type = property()              # as on torch 2.11's profiler
    events = [Bare(e._n, e._s, e._e, e._t, e._k, e._c, e._l, e._d) for e in _timeline()]
    # an operator whose id is a runtime call's id must not take its place
    events.append(Bare("aten::empty", 900, 905, STEP, "cpu_op", 101))
    want = spans.reduce(_prof(_timeline()), steps=2)
    assert spans.reduce(_prof(events), steps=2) == want
