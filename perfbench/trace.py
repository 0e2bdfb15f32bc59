"""One card's profiler trace, reduced to what the per-layer metrics read.

The traced window is the benchmark's ``perfbench.profiled`` span, which
ends after the device has finished its steps.  Device activity is every
kernel, copy and set the trace shows on the card; ``busy_s`` is the union
of their intervals inside the window.  An idle gap is a stretch of the
window with none of them running; it is labelled by what the host was
doing when it began: the benchmark's own span around the call (the
program's value-and-grad, the optimizer's update, the batch) and the
innermost operator the host was in.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

WINDOW_SPAN = "perfbench.profiled"
SPAN_PREFIX = "perfbench."
_DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
_NCCL = re.compile(r"nccl", re.IGNORECASE)
#: device operations and idle labels kept per card (the attention kernels always)
TOP = 40


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _length(intervals: List[Tuple[int, int]]) -> int:
    return sum(e - s for s, e in intervals)


def _minus(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """The length of the union ``a`` outside the union ``b``."""
    total, j = 0, 0
    for s, e in a:
        covered = 0
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            covered += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
        total += (e - s) - covered
    return total


def _kind(e) -> str:
    """The event's kind; where the profiler does not say, from its name:
    annotations (the benchmark's spans, NCCL's ``nccl:<op>`` ranges) are
    no device activity."""
    try:
        return str(e.activity_type())
    except AttributeError:
        pass
    n = e.name()
    annotated = getattr(e, "is_user_annotation", None)
    if (annotated is not None and annotated()) or n.startswith(SPAN_PREFIX) \
            or n.startswith("nccl:"):
        return "gpu_user_annotation"
    return "gpu_memcpy" if n.startswith("Memcpy") else (
        "gpu_memset" if n.startswith("Memset") else "kernel")


def summarize(prof, steps: int) -> Dict[str, object]:
    """The reduction of ``prof`` (a finished ``torch.profiler.profile``
    around ``steps`` steps inside the :data:`WINDOW_SPAN` span)."""
    import torch

    window = None
    device, cpu, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.end_ns()
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if _kind(e) in _DEVICE_KINDS:
                device.append((start, end, name))
            continue
        if name == WINDOW_SPAN:
            window = (start, end)
        elif name.startswith(SPAN_PREFIX):
            spans.append((start, end, name[len(SPAN_PREFIX):]))
        else:
            cpu.append((start, end, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0, w1 = window
    device = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    if not device:
        raise RuntimeError("the trace shows no device activity in the traced window")
    busy = _union([(s, e) for s, e, _ in device])
    nccl = _union([(s, e) for s, e, n in device if _NCCL.search(n)])
    other = _union([(s, e) for s, e, n in device if not _NCCL.search(n)])

    by_kernel: Dict[str, List[float]] = {}
    kernels = 0
    for s, e, n in device:
        entry = by_kernel.setdefault(n, [0, 0.0])
        entry[0] += 1
        entry[1] += (e - s) * 1e-9
    for n, (c, _) in by_kernel.items():
        if not (n.startswith("Memcpy") or n.startswith("Memset")):
            kernels += c

    # idle gaps, each labelled by the host's innermost span and operator
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    idle: Dict[str, float] = {}
    cpu.sort()
    spans.sort()
    ops, outer, i, j = [], [], 0, 0
    for g0, g1 in gaps:
        while i < len(cpu) and cpu[i][0] <= g0:
            ops.append(cpu[i])
            i += 1
        while j < len(spans) and spans[j][0] <= g0:
            outer.append(spans[j])
            j += 1
        label = []
        for stack in (outer, ops):
            while stack and stack[-1][1] < g0:
                stack.pop()
            label.append(stack[-1][2] if stack else "-")
        key = " / ".join(label)
        idle[key] = idle.get(key, 0.0) + (g1 - g0) * 1e-9
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])
    return {"steps": steps, "window_s": (w1 - w0) * 1e-9, "busy_s": _length(busy) * 1e-9,
            "kernels": kernels, "nccl_exclusive_s": _minus(nccl, other) * 1e-9,
            "by_kernel": dict(ranked[:TOP] + [kv for kv in ranked[TOP:]
                                              if re.search(r"_kernel_(bf16|f32)", kv[0])]),
            "idle_by_host": dict(sorted(idle.items(), key=lambda kv: -kv[1])[:TOP])}
