"""The plain reference against the port at SMOKE sizes on the CPU, both in
float32: the loss, every leaf's gradient and one AdamW update.  The
reference imports nothing of the port; only this test holds the two side
by side."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import cells, inputs  # noqa: E402
from perfbench.reference import model, train  # noqa: E402
from perfbench.tests.smoke import smoke_cell  # noqa: E402

torch.set_num_threads(1)
CELLS = ["gpt3-1b.gspmd", "deepseek-moe-16b.gspmd"]


def _port(cell):
    from repro_torch.core.pipeline import value_and_grad
    from repro_torch.models import build_model
    pcfg = cells.port_config(cell.config).replace(dtype=torch.float32)
    m = build_model(pcfg, device=torch.device("cpu"))
    return m, value_and_grad(m.loss)


def _reference_grads(cell, weights, batch):
    params = {p: t.requires_grad_(True) for p, t in weights.all().items()}
    loss = model.loss_sum(params, cell.config, batch["tokens"], batch["labels"]) \
        / batch["tokens"].numel()
    grads = torch.autograd.grad(loss, list(params.values()))
    return params, float(loss.detach()), dict(zip(params, grads))


@pytest.mark.parametrize("name", CELLS)
def test_loss_gradients_and_update_match_the_port(name):
    from repro_torch.optim.adamw import adamw, cosine_schedule
    from repro_torch.tree import tree_items

    cell = smoke_cell(name)
    seed = 2**31 + 11
    weights = inputs.Weights(cell.config, seed, "cpu")
    batch = inputs.make_batch(cell.config["vocab_size"], 2, 64, seed, 0, "cpu")
    m, vg = _port(cell)
    full = inputs.nest({p: a.requires_grad_(True) for p, a in weights.all().items()})
    loss, grads = vg(full, batch)
    port_grads = {p.lstrip("/"): g for p, g in tree_items(grads)}

    params, ref_loss, ref_grads = _reference_grads(cell, weights, batch)
    assert abs(float(loss) - ref_loss) < 1e-5 * abs(ref_loss)
    assert list(port_grads) == list(ref_grads)
    for p, g in ref_grads.items():
        err = float((port_grads[p] - g).abs().max())
        assert err <= 1e-4 * float(g.abs().max()) + 1e-7, (p, err)

    o = cell.traffic["optimizer"]
    opt = adamw(cosine_schedule(o["lr"], o["warmup_steps"], o["total_steps"], o["min_ratio"]),
                b1=o["b1"], b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"],
                clip_norm=o["clip_norm"])
    state = opt.init(full)
    updates, state = opt.update(grads, state, full)
    with torch.no_grad():
        moved = {p.lstrip("/"): a + u for (p, a), (_, u) in zip(tree_items(full),
                                                               tree_items(updates))}
        mv = {p: torch.zeros_like(t) for p, t in params.items()}
        vv = {p: torch.zeros_like(t) for p, t in params.items()}
        train.adamw_update(params, dict(ref_grads), mv, vv, 1, o)
    for p, t in params.items():
        start = weights.leaf(p)
        step_ref, step_port = t - start, moved[p] - start
        # by the norm: Adam's first step divides by |g|, so the elements
        # whose gradient is at rounding level move by their rounding
        err = float(torch.linalg.vector_norm(step_port - step_ref))
        assert err <= 1e-3 * float(torch.linalg.vector_norm(step_ref)), (p, err)


def test_row_blocks_sum_to_the_whole_batch():
    cell = smoke_cell("gpt3-1b.gspmd")
    weights = inputs.Weights(cell.config, 5, "cpu")
    batches = [inputs.make_batch(cell.config["vocab_size"], 4, 32, 5, i, "cpu")
               for i in range(2)]
    o = cell.traffic["optimizer"]
    whole = train.train_readings(cell.config, weights, batches, o, steps=2, row_block=4)
    rows = train.train_readings(cell.config, weights, batches, o, steps=2, row_block=1)
    for a, b in zip(whole["loss"], rows["loss"]):
        assert abs(a - b) < 1e-5
    for key in ("grad_norm", "change_norm"):
        for p in whole[key]:
            assert abs(whole[key][p] - rows[key][p]) <= 1e-4 * whole[key][p] + 1e-9, (key, p)


def test_learning_rate_follows_warmup_and_cosine():
    o = {"lr": 1.0, "warmup_steps": 10, "total_steps": 110, "min_ratio": 0.1}
    assert train.learning_rate(5, o) == pytest.approx(0.5)
    assert train.learning_rate(10, o) == pytest.approx(1.0)
    assert train.learning_rate(60, o) == pytest.approx(0.55)
    assert train.learning_rate(500, o) == pytest.approx(0.1)


def test_weights_remake_each_leaf_bit_for_bit():
    cell = smoke_cell("deepseek-moe-16b.gspmd")
    w = inputs.Weights(cell.config, 2**40 + 3, "cpu")
    every = w.all()
    for p, t in every.items():
        assert torch.equal(t, w.leaf(p))
    other = inputs.Weights(cell.config, 2**40 + 4, "cpu").all()
    assert not torch.equal(every["lm_head"], other["lm_head"])
