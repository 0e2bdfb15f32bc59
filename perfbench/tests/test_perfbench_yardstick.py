"""The benchmark's arithmetic against the numbers it was specified with, and
against the kernel bounds the repository's kernel table gives."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT)]

from perfbench import yardstick  # noqa: E402


def _config(name: str) -> dict:
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())


def test_gpt3_1b_matmul_parameters_and_step_flops():
    cfg = _config("gpt3-1b")
    assert yardstick.matmul_params(cfg) == 24 * (4 * 2048**2 + 3 * 2048 * 8192) + 2048 * 50257
    assert yardstick.matmul_params(cfg) / 1e9 == pytest.approx(1.7135, abs=5e-5)
    flops = yardstick.model_flops_per_step(cfg, 16, 2048)
    assert flops / 1e14 == pytest.approx(3.567, abs=5e-4)
    assert flops / yardstick.PEAK_BF16_FLOPS == pytest.approx(0.361, abs=5e-4)


def test_deepseek_three_layers_active_parameters_and_step_flops():
    cfg = _config("deepseek-moe-16b")
    assert cfg["d_ff"] == 10944 and cfg["n_layers"] == 3
    assert yardstick.matmul_params(cfg) / 1e8 == pytest.approx(4.660, abs=5e-4)
    flops = yardstick.model_flops_per_step(cfg, 8, 2048)
    assert flops / 1e13 == pytest.approx(4.70, abs=5e-3)
    assert flops / yardstick.PEAK_BF16_FLOPS == pytest.approx(0.048, abs=5e-4)


def test_attention_bounds_are_the_kernel_tables():
    """PERF.md's kernel table at B 4, l 2048, 16 heads of 128: forward
    0.0695 ms, dQ 0.1043, dK/dV 0.1390, each bound by its operations."""
    cfg = _config("gpt3-1b")
    b = yardstick.attention_bounds_s(cfg, 4, 2048)
    assert b["fwd"] * 1e3 == pytest.approx(0.0695, abs=5e-5)
    assert b["dq"] * 1e3 == pytest.approx(0.1043, abs=5e-5)
    assert b["dkv"] * 1e3 == pytest.approx(0.1390, abs=5e-5)
    per_step = yardstick.attention_bound_per_step_s(cfg, 16, 2048)
    assert per_step == pytest.approx(24 * 4 * sum(b.values()), rel=1e-12)


def test_bound_takes_the_slower_of_operations_and_bytes():
    assert yardstick.bound_s(989e12, 0) == pytest.approx(1.0)
    assert yardstick.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert yardstick.bound_s(989e12, 6.7e12) == pytest.approx(2.0)
