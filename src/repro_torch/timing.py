"""Device timing of one call on the card, and the least time the card could
take for its work, as ``chip_smoke.py`` and ``chip_compare.py`` report them.

Imports nothing but torch, so ``chip_compare.py`` can load this file by path
to time another tree's kernels the same way.
"""
from __future__ import annotations

import statistics

import torch

PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12           # H100 SXM HBM3
# ~0.5 ms of device-side wait before each timed launch: longer than the
# host takes to run a wrapper and enqueue its kernel, so the events time the
# kernel and not the host work of its call
HOST_SLACK_CYCLES = 1_000_000


def time_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn`` in ms over ``iters`` calls after
    ``warmup``, the L2 flushed before each (the serving path finds K/V cold:
    the pool gather ran between uses)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(HOST_SLACK_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float):
    """(ms, "operations" or "bytes"): the larger of ``flops`` at the bf16
    tensor-core peak and ``nbytes`` at the HBM rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")
