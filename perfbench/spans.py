"""The program's own spans in one card's profiler trace: how often each ran,
how long the host spent in it, and the device time of what it launched.

The program names its spans ``repro_torch.<name>`` (``src/repro_torch/
tracing.py``); they land on the profiler's clock beside the device's
activity, over the same ``perfbench.profiled`` window that
``trace.summarize`` reads.  A span's host interval does not say where the
device time went (the host runs ahead of a busy card), so the device time
is assigned by launch:

1. a kernel, copy or set -> the runtime call with the same correlation id
   (CUPTI's), or where the trace lacks it the operator the activity is
   linked to (``linked_correlation_id``, the profiler's own ids);
2. that call's thread and start -> the innermost program span open there;
3. where that thread holds none (autograd's device thread outside a
   recompute), the innermost span that the thread holding
   ``perfbench.step`` holds at that time;
4. otherwise the activity is unattributed.

Nothing is assigned by the activity's own start time.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from perfbench import trace

PREFIX = "repro_torch."
STEP_SPAN = trace.SPAN_PREFIX + "step"
_RUNTIME_KINDS = {"cuda_runtime", "cuda_driver"}
#: the CUDA runtime's and driver's calls, by name, where the profiler does
#: not give an event's kind (their correlation ids are CUPTI's, apart from
#: the operators')
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")
#: unattributed device operations kept by name
TOP = 10


class _Thread:
    """One thread's program spans, properly nested: ``chain(t)`` is the
    names of the spans open at ``t``, innermost first."""

    def __init__(self, spans: List[Tuple[int, int, str]]):
        spans.sort(key=lambda s: (s[0], -s[1]))
        self.spans, self.starts = spans, [s[0] for s in spans]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (s, _, _) in enumerate(spans):
            while stack and spans[stack[-1]][1] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def chain(self, t: int) -> List[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] <= t:
            i = self.parent[i]
        out = []
        while i >= 0:
            out.append(self.spans[i][2])
            i = self.parent[i]
        return out


def _is_runtime(e) -> bool:
    try:
        return e.activity_type() in _RUNTIME_KINDS
    except AttributeError:
        return bool(_RUNTIME.match(e.name()))


def reduce(prof, steps: int) -> Dict[str, object]:
    """Per program span name (without the prefix): ``n``, ``host_s``,
    ``device_s`` (activity launched with the span innermost),
    ``device_incl_s`` (nested spans included) and ``nccl_excl_s`` (its own
    NCCL kernels while no other device activity runs); ``attributed_s``,
    the union of the attributed activity; ``unattributed``, the rest by
    name; and ``idle_by_span``, each idle gap by the innermost program span
    open at its start on the step's thread."""
    import torch

    window, step_tid = None, None
    device, ops, runtime = [], {}, {}
    spans: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        name, start, end = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if trace._kind(e) in trace._DEVICE_KINDS:
                device.append((start, end, name, e.correlation_id(), e.linked_correlation_id()))
            continue
        if name == trace.WINDOW_SPAN:
            window = (start, end)
        elif name == STEP_SPAN and step_tid is None:
            step_tid = e.start_thread_id()
        elif name.startswith(PREFIX):
            spans[e.start_thread_id()].append((start, end, name[len(PREFIX):]))
        corr = e.correlation_id()
        if corr:                                      # 0: linked to nothing
            launches = runtime if _is_runtime(e) else ops
            launches[corr] = (e.start_thread_id(), start)
    if window is None:
        raise RuntimeError(f"the trace holds no {trace.WINDOW_SPAN!r} span")
    w0, w1 = window
    threads = {tid: _Thread(s) for tid, s in spans.items()}
    step = threads.get(step_tid)
    step_chain = step.chain if step else (lambda t: [])

    def chain(corr: int, linked: int) -> List[str]:
        """The spans open at the activity's launch, innermost first."""
        launch = runtime.get(corr) or ops.get(linked)
        if launch is None:
            return []
        tid, t = launch
        own = threads[tid].chain(t) if tid in threads else []
        return own + (step_chain(t) if tid != step_tid else [])

    device = [(max(s, w0), min(e, w1), n, chain(c, lc))
              for s, e, n, c, lc in device if e > w0 and s < w1]
    other = trace._union([(s, e) for s, e, n, _ in device if not trace._NCCL.search(n)])
    out: Dict[str, dict] = defaultdict(lambda: {"n": 0, "host_s": 0.0, "device_s": 0.0,
                                                "device_incl_s": 0.0, "nccl_excl_s": 0.0})
    for s in spans.values():
        for s0, s1, n in s:
            if w0 <= s0 < w1:
                out[n]["n"] += 1
                out[n]["host_s"] += (s1 - s0) * 1e-9
    nccl: Dict[str, list] = defaultdict(list)
    attributed, unattributed = [], defaultdict(float)
    for s, e, n, names in device:
        if not names:
            unattributed[n] += (e - s) * 1e-9
            continue
        attributed.append((s, e))
        for span in dict.fromkeys(names):
            out[span]["device_incl_s"] += (e - s) * 1e-9
        out[names[0]]["device_s"] += (e - s) * 1e-9
        if trace._NCCL.search(n):
            nccl[names[0]].append((s, e))
    for span, intervals in nccl.items():
        out[span]["nccl_excl_s"] = trace._minus(trace._union(intervals), other) * 1e-9

    busy = trace._union([(s, e) for s, e, _, _ in device])
    idle: Dict[str, float] = defaultdict(float)
    t = w0
    for s, e in busy + [(w1, w1)]:
        if s > t:
            names = step_chain(t)
            idle[names[0] if names else "-"] += (s - t) * 1e-9
        t = max(t, e)
    ranked = sorted(unattributed.items(), key=lambda kv: -kv[1])
    return {"steps": steps, "spans": dict(out),
            "attributed_s": trace._length(trace._union(attributed)) * 1e-9,
            "unattributed": dict(ranked[:TOP]),
            "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1]))}


def per_card(ranks: List[dict], read) -> Optional[float]:
    """The mean over the cards of ``read(rank's trace, its spans)``; None
    where a card's trace holds no spans or ``read`` finds nothing."""
    values = []
    for r in ranks:
        found = r.get("spans", {}).get("spans")
        value = read(r, found) if found else None
        if value is None:
            return None
        values.append(value)
    return sum(values) / len(values) if values else None


def device_incl_ms_per_step(names, r: dict, found: dict) -> Optional[float]:
    """The device time launched under any of ``names`` (nested spans
    included), in ms per step; None where none of them ran."""
    present = [found[n] for n in names if n in found]
    if not present:
        return None
    return 1e3 * sum(p["device_incl_s"] for p in present) / r["steps"]


#: the tick loop's units, one span per unit
UNITS = ("pipe.fwd", "pipe.bwd", "pipe.bwd_input", "pipe.bwd_weight")


def unit_host_ratio(r: dict, found: dict) -> Optional[float]:
    """The host's time in the tick loop's units over the device time they
    launched: above 1, issuing a unit takes longer than running it."""
    units = [found[n] for n in UNITS if n in found]
    device = sum(u["device_incl_s"] for u in units)
    return sum(u["host_s"] for u in units) / device if device > 0 else None


def shift_wait_share(r: dict, found: dict) -> Optional[float]:
    """The share of the window (%) in which the header exchange's NCCL
    kernels run alone: waiting for the peer."""
    header = found.get("ring.header")
    return 100.0 * header["nccl_excl_s"] / r["window_s"] if header else None
