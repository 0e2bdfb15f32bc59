"""The control: the reference in fp8 in the program's place must come out
not correct under every cell's limits.  On the CPU at SMOKE size; on the
card (marked ``card``) at the cell's own size for one seed."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import cells, control, harness  # noqa: E402
from perfbench.reference import lowp  # noqa: E402
from perfbench.tests.smoke import smoke_cell  # noqa: E402

torch.set_num_threads(1)
NAMES = ["gpt3-1b.gspmd", "gpt3-1b.terapipe-m8", "deepseek-moe-16b.gspmd",
         "gpt3-1b.terapipe-m8.4card"]


def _control_is_caught(cell, seed, device) -> tuple:
    ref = harness.reference_readings(cell, seed, device)
    low = harness.reference_readings(cell, seed, device, mm=lowp.fp8_matmul)
    return harness.judge(control.as_program(low), ref, cell.limits)


def test_quantize_rounds_to_the_format():
    x = torch.tensor([1.0, 0.3, -448.0, 1e-3])
    q = lowp.quantize(x, torch.float8_e4m3fn)
    assert q[2] == -448.0 and q[0] == 1.0 and q[1] != 0.3
    assert lowp.quantize(torch.zeros(0), torch.float8_e4m3fn).numel() == 0
    a = torch.randn(3, 5, dtype=torch.float64, requires_grad=True)
    b = torch.randn(5, 4, dtype=torch.float64, requires_grad=True)
    lowp.fp8_matmul(a.float(), b.float()).sum().backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape


@pytest.mark.parametrize("name", ["gpt3-1b.gspmd", "deepseek-moe-16b.gspmd"])
def test_the_control_is_not_correct_at_smoke_size(name):
    correct, check = _control_is_caught(smoke_cell(name), 2**31 + 41, "cpu")
    assert not correct, check


@pytest.mark.card
@pytest.mark.parametrize("name", NAMES)
def test_the_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("the control at the cell's own size runs on a CUDA card")
    cell = cells.load_cell(name)
    cell = dataclasses.replace(cell, chips=1)       # the reference runs on one card
    correct, check = _control_is_caught(cell, 2**31 + 43, "cuda")
    assert not correct, check
