"""The reduction of a profiler trace on a hand-made timeline, and the
per-layer readers on that reduction."""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT)]

from perfbench import cells, trace, yardstick  # noqa: E402

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class _Event:
    def __init__(self, name, start, end, device=CPU, kind="cpu_op"):
        self._n, self._s, self._e, self._d, self._k = name, start, end, device, kind

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


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def _timeline():
    """A 1000-ns window: two kernels, an NCCL kernel partly hidden, a copy,
    an annotation on the device (not activity), work outside the window."""
    k = lambda n, s, e, kind="kernel": _Event(n, s, e, CUDA, kind)
    return [
        _Event(trace.WINDOW_SPAN, 0, 1000, kind="user_annotation"),
        _Event(trace.SPAN_PREFIX + "value_and_grad", 0, 600, kind="user_annotation"),
        _Event(trace.SPAN_PREFIX + "optimizer", 600, 1000, kind="user_annotation"),
        _Event("aten::mm", 0, 150), _Event("aten::add_", 350, 420),
        _Event("aten::mul", 700, 760),
        k("void fwd_kernel_bf16<128>(int)", 100, 300),
        k("ncclDevKernel_SendRecv(x)", 250, 450),
        k("Memcpy DtoD", 500, 550, "gpu_memcpy"),
        k(trace.SPAN_PREFIX + "value_and_grad", 0, 600, "gpu_user_annotation"),
        k("nccl:coalesced", 250, 450, "gpu_user_annotation"),
        k("elementwise_kernel", 800, 900),
        k("elementwise_kernel", 1200, 1300),
    ]


def test_summary_of_a_timeline():
    s = trace.summarize(_prof(_timeline()), steps=2)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx((450 - 100 + 50 + 100) * 1e-9)
    assert s["kernels"] == 3                               # the copy is not a launch
    assert s["nccl_exclusive_s"] == pytest.approx(150e-9)  # 300..450
    assert s["by_kernel"]["elementwise_kernel"] == [1, pytest.approx(100e-9)]
    idle = s["idle_by_host"]
    assert idle["value_and_grad / aten::mm"] == pytest.approx(100e-9)       # 0..100
    # a gap is labelled where it begins: 450..500 and 550..800 in value-and-grad
    assert idle["value_and_grad / -"] == pytest.approx(300e-9)
    assert idle["optimizer / -"] == pytest.approx(100e-9)           # 900..1000
    assert sum(idle.values()) == pytest.approx(500e-9)


def test_annotations_are_no_device_work_where_the_profiler_gives_no_kind():
    class Bare(_Event):
        activity_type = property()              # as on profilers without the method
    events = [Bare(e._n, e._s, e._e, e._d, e._k) for e in _timeline()]
    assert trace.summarize(_prof(events), steps=2) == trace.summarize(_prof(_timeline()), 2)


def test_a_trace_without_the_window_or_device_work_is_refused():
    with pytest.raises(RuntimeError):
        trace.summarize(_prof(_timeline()[1:]), steps=1)
    with pytest.raises(RuntimeError):
        trace.summarize(_prof([e for e in _timeline() if e.device_type() == CPU]), steps=1)


def test_readers_on_the_summary():
    s = trace.summarize(_prof(_timeline()), steps=2)
    cfg = cells.load_cell("gpt3-1b.gspmd")
    run = {"cfg": cfg.config, "traffic": cfg.traffic, "chips": 1, "step_s": 2.0,
           "ranks": [s, s]}
    read = lambda name: cells.load_reader(name)(run)
    assert read("idle_share") == pytest.approx(50.0)
    assert read("idle_share.4card") == pytest.approx(50.0)
    assert read("launches_per_step") == pytest.approx(1.5)
    assert read("comm_exposed_share.4card") == pytest.approx(15.0)
    flops = yardstick.model_flops_per_step(cfg.config, 16, 2048)
    assert read("mfu") == pytest.approx(100 * flops / (2.0 * yardstick.PEAK_BF16_FLOPS))
    bound = yardstick.attention_bound_per_step_s(cfg.config, 16, 2048)
    assert read("attn_roofline") == pytest.approx(100 * bound / 100e-9)
    s2 = dict(s, by_kernel={"elementwise_kernel": [1, 1e-7]})
    assert cells.load_reader("attn_roofline")(dict(run, ranks=[s2])) is None
