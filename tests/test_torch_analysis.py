"""The port's runtime audits (``repro_torch.analysis``), the counterpart of
``tests/test_analysis.py``: the matrix of every training schedule x
use_kernel off/on is clean; each ported rule flags a seeded violation:

* a plain-attention model in a kernel cell saves its score matrices
  (``buffer.score-matrix``);
* a K/V repeated to the query heads before the attention op
  (``buffer.repeated-kv``);
* a ring log with the reverse ring dropped (``comm.ring-match``);
* contiguous presented as a schedule whose memory is flat in D
  (``scale.flat-in-d``);

and the score rule does not fire where the sequence length equals
d_model, where an activation ``(B, l, d)`` has the trailing pair
``(l, ctx+l)``.
"""
import json

import pytest
import torch

from repro_torch.analysis import audit, rules
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

CELLS = audit.default_cells()


@pytest.fixture(scope="module")
def matrix():
    return {c.name(): audit.audit_cell(c, device="cpu") for c in CELLS}


def _errors(findings, rule=None):
    return [f for f in findings if f["severity"] == "error" and rule in (None, f["rule"])]


@pytest.mark.parametrize("cell", [c.name() for c in CELLS])
def test_matrix_cell_is_clean(matrix, cell):
    rec = matrix[cell]
    assert rec["ok"], _errors(rec["findings"])
    ran = {f["rule"] for f in rec["findings"]}
    want = {"ir.validate", "comm.ring-match", "dtype.upcast", "scale.flat-in-d"}
    assert want <= ran
    assert rec["casts"].get("float32->bfloat16", 0) > 0     # the weights' per-use casts
    ring = next(f for f in rec["findings"] if f["rule"] == "comm.ring-match")
    assert (ring["data"]["rev_shifts"] > 0) == (rec["schedule"] in ("1f1b", "interleaved-1f1b",
                                                                     "zb-h1"))


def test_flat_in_d_holds_for_the_1f1b_family_and_not_for_contiguous(matrix):
    """1F1B's memory claim, measured: the explicit-backward schedules keep
    one unit's graph at a time, contiguous keeps every unit to the drain.
    Presented as a schedule that must be flat, contiguous is flagged."""
    for name in ("1f1b", "interleaved-1f1b", "zb-h1"):
        small, big = matrix[f"{name}/kernel=on"]["saved_peak_bytes"]
        assert big <= small * 1.02, (name, small, big)
    small, big = matrix["contiguous/kernel=on"]["saved_peak_bytes"]
    assert big > 1.5 * small
    found = rules.check_flat_in_d(small, big, required=True)
    assert [f.severity for f in found] == ["error"]


def _cell_vg(schedule, use_kernel, M=5):
    cell = audit.Cell(schedule, use_kernel, M=M)
    model = audit.build_audit_model(cell.n_layers, use_kernel, "cpu")
    params = model.init(seed=0)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    vg, batch = audit.cell_step(cell, model, params, cell.D)
    return vg, params, batch


def test_plain_attention_in_a_kernel_cell_saves_scores():
    vg, params, batch = _cell_vg("1f1b", use_kernel=False)
    rec = audit.audit_step(vg, params, batch, kernel_rules=True)
    hits = [f for f in rec["findings"] if f.rule == "buffer.score-matrix"]
    assert hits and all(f.severity == "error" for f in hits)
    # grouped (B, Hkv, rep, l, ctx+l) at every slice's (l, ctx+l)
    assert [2, 2, 2, 8, 40] in [f.data["shape"] for f in hits]


def test_repeated_kv_is_flagged(monkeypatch):
    attend = ops.terapipe_attention

    def repeated(q, k, v, *, ctx_len):
        rep = q.shape[2] // k.shape[2]
        return attend(q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2),
                      ctx_len=ctx_len)

    monkeypatch.setattr(ops, "terapipe_attention", repeated)
    vg, params, batch = _cell_vg("contiguous", use_kernel=True)
    rec = audit.audit_step(vg, params, batch, kernel_rules=True)
    hits = [f for f in rec["findings"] if f.rule == "buffer.repeated-kv"]
    assert hits and all(f.severity == "error" for f in hits)
    assert {tuple(f.data["shape"][1:]) for f in hits} == {(8 * m, 4, 16) for m in range(1, 6)}
    assert not [f for f in rec["findings"] if f.rule == "buffer.score-matrix"]


@pytest.mark.parametrize("schedule", ["1f1b", "interleaved-1f1b", "zb-h1"])
def test_dropped_reverse_ring_is_flagged(schedule):
    vg, params, batch = _cell_vg(schedule, use_kernel=True)
    with audit.record_ring() as sends:
        vg(params, batch)
    p = vg.plan
    clean = rules.check_ring_match(sends, assign=p.assign, n_items=p.DM)
    assert [f.severity for f in clean] == ["info"]
    tampered = [s for s in sends if s[0] == 1]
    found = rules.check_ring_match(tampered, assign=p.assign, n_items=p.DM)
    assert found and all(f.severity == "error" for f in found)
    assert "declares the reverse ring" in found[0].message
    # a cotangent delivered a tick late: a hold that comm_plan() does not declare
    late = [(step, s) for step, s in sends if step == 1] + [(-1, ())]
    late += [s for s in sends if s[0] == -1]
    assert rules.check_ring_match(late, assign=p.assign, n_items=p.DM)[0].severity == "error"


def test_no_score_false_positive_where_seq_equals_d_model():
    """S = 64 = d_model: the last slice's (l, ctx+l) = (8, 64) is the
    trailing pair of every (B, l, d) activation; the rule keys on the head
    axis and stays clean."""
    vg, params, batch = _cell_vg("1f1b", use_kernel=True, M=8)
    assert vg.plan.L == vg.plan.cfg.d_model == 64
    rec = audit.audit_step(vg, params, batch, kernel_rules=True)
    assert not [f for f in rec["findings"] if f.severity == "error"]
    act = rules.SavedTensor((2, 8, 64))
    pairs = {(8, 8 * (m + 1)) for m in range(8)}
    assert not rules.check_score_matrix([act], mb=2, hq=4, hkv=2, pairs=pairs)
    for shape in ((2, 4, 8, 64), (2, 2, 2, 8, 64), (8, 8, 64), (4, 16, 64)):
        assert rules.check_score_matrix([rules.SavedTensor(shape)], mb=2, hq=4,
                                        hkv=2, pairs=pairs), shape


def test_cli_lists_rules_and_exits_zero_on_clean_cells(tmp_path, capsys):
    assert analysis_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rid in ("ir.validate", "comm.ring-match", "buffer.score-matrix", "buffer.repeated-kv",
                "scale.flat-in-d", "dtype.upcast"):
        assert rid in listed
    out = tmp_path / "audit.json"
    assert analysis_main(["--device", "cpu", "--schedules", "interleaved", "--out",
                          str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["ok"] and [c["cell"] for c in report["cells"]] == [
        "interleaved/kernel=off", "interleaved/kernel=on"]
    assert "audit: OK" in capsys.readouterr().out
