"""Stage-sharded training state with one pipe rank per process, run in one
process through ``distributed.transport.ThreadRing`` (a thread per rank).

* (a) Per case of ``tests/test_torch_rank_per_process.py``: each rank
  holds exactly its blocks of the whole parameters (the layer rows of its
  chunks, everything else whole), the ranks' rows cover the stack once,
  and the gather of the blocks on rank 0 rebuilds the tree bit for bit;
  on pipe 2 × tp 2 with one rank of each axis per process (stand-in
  groups: only the layout is built), each block is ``_leaf_pspec``'s tp
  block of the rank's rows, KV heads the axis does not divide stay whole;
  every element is owned by exactly one process.
* (b) gpt3 SMOKE on ``Mesh(pipe=4)``: each rank's resident parameters,
  AdamW moments and batch are the dry run's per-device ``state_bytes``
  (``launch/dryrun.py::trace_terapipe``, counted at each tensor's bytes).
* (c) One AdamW step on four ranks against one process: the clip norm
  within 1e-6 (relative), every updated block within 2e-6 of its leaf's
  largest magnitude, the replicated leaves bit-equal across ranks.
* (d) The launcher's loop (``launch/train.py::main``) on four ranks: 4
  steps with a checkpoint every 2 and a fault at step 3 restore step 2 on
  every rank and end bit-equal to the run without the fault, within 2e-6
  of one process; without a checkpoint dir every rank retries from its
  rescue references, with a dir and nothing saved every rank raises.
* (e) A checkpoint of four ranks restores bit for bit into two ranks, into
  one process and into the JAX package's ``CheckpointManager`` (whose save
  of it has the port's manifest); one of one process restores into four
  ranks, each getting its block.

SMOKE configs in f32 on the CPU.
"""
import functools
import json
import math

import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.optim import adamw as jax_adamw
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager, gather_tree, meta_target
from repro_torch.configs import ShapeSpec, input_specs
from repro_torch.core.pipeline import (TeraPipeConfig, _leaf_pspec, full_shapes,
                                       make_terapipe_value_and_grad, shard_params)
from repro_torch.distributed.sharding import REPLICATED, local_shard, map_specs
from repro_torch.distributed.transport import ThreadRing
from repro_torch.launch import dryrun
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.tree import jax_items, jax_leaves, tree_items, tree_leaves, tree_map

from test_torch_rank_per_process import CASES, B, S

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

REL = 2e-6            # against one process, of each leaf's largest magnitude
NORM_REL = 1e-6
GPT = "gpt3-1b"


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg = configs.get_config(arch, smoke=True).replace(dtype=torch.float32)
    model = build_model(cfg, "cpu")
    return model, model.init(0)


# ---------------------------------------------------------------- (a)
@pytest.mark.parametrize("case", sorted(CASES))
def test_each_rank_holds_its_blocks_and_the_gather_rebuilds_the_tree(case):
    arch, K, tkw, axes = CASES[case]
    model, params = _model(arch)
    tcfg = TeraPipeConfig(cache_dtype=torch.float32, **tkw)
    mesh = Mesh(pipe=K, **axes)
    plan = make_terapipe_value_and_grad(model, tcfg, S, B, mesh).plan
    assert plan.shard_layout(params) is None           # in process: everything whole
    main = plan.main.name

    def rank_run(rank):
        layout = make_terapipe_value_and_grad(model, tcfg, S, B, mesh,
                                              {"pipe": rank}).plan.shard_layout(params)
        shard = shard_params(params, layout)
        return shard, layout, gather_tree(shard, layout, rank)

    runs = ThreadRing(K, timeout=30).run(rank_run)
    _owned_once(params, [layout for _, layout, _ in runs])
    covered = 0
    for k, (shard, layout, _) in enumerate(runs):
        assert tree_map(lambda a: a.shape, params) == full_shapes(layout)
        rows = [plan.rows[k, v] for v in range(plan.V)]
        covered += sum(hi - lo for lo, hi in rows)
        for (path, a), b in zip(tree_items(params), tree_leaves(shard)):
            if path.startswith(f"/groups/{main}/"):
                want = torch.cat([a[lo:hi] for lo, hi in rows])
                assert b.untyped_storage().nbytes() == want.numel() * want.element_size(), path
            else:
                want = a
                assert b is a, path                      # held whole, not copied
            assert torch.equal(b, want), (k, path)
    assert covered == plan.n_main
    whole = runs[0][2]
    assert all(r[2] is None for r in runs[1:])
    assert [p for p, _ in jax_items(whole)] == [p for p, _ in jax_items(params)]
    for (path, a), w in zip(jax_items(params), jax_leaves(whole)):
        assert w.dtype == a.dtype and torch.equal(w, a), path


def _owned_once(params, layouts) -> None:
    """Every element of every leaf is owned by exactly one process: the
    owned blocks' sizes sum to the leaf's."""
    per_rank = [list(tree_leaves(layout)) for layout in layouts]
    for i, (path, a) in enumerate(tree_items(params)):
        owned = sum(math.prod(ls[i].mine.shape(a.shape)) for ls in per_rank if ls[i].owned)
        assert owned == a.numel(), (path, owned, a.numel())


class _Hosted:
    """One rank of a group of ``size`` hosted by this process: the sizes
    and ranks the plan's layout reads (no collective runs)."""

    def __init__(self, size: int, rank: int):
        self.size, self.rank, self.ranks = size, rank, (rank,)


@pytest.mark.parametrize("arch,kv_heads", [(GPT, None), ("qwen3-0.6b", 1)])
def test_pipe_by_tp_layout_holds_each_tp_block_of_the_ranks_rows(arch, kv_heads):
    cfg = configs.get_config(arch, smoke=True)
    if kv_heads is not None:                           # the tp axis does not divide them
        cfg = cfg.replace(n_kv_heads=kv_heads)
    model = build_model(cfg, "cpu")
    params = model.init(0)
    mesh = Mesh(pipe=2, tp=2)
    tcfg = TeraPipeConfig(n_token_slices=4)
    specs = model.specs()
    layouts = []
    for w in range(4):
        k, t = divmod(w, 2)
        groups = {"pipe": _Hosted(2, k), "tp": _Hosted(2, t), "world": _Hosted(4, w)}
        plan = make_terapipe_value_and_grad(model, tcfg, 32, B, mesh, groups).plan
        assert plan.tp_sharded
        layout = plan.shard_layout(params)
        layouts.append(layout)
        main = plan.main.name
        want_main = map_specs(
            lambda spec, a: local_shard(
                torch.cat([a[lo:hi] for lo, hi in (plan.rows[k, v] for v in range(plan.V))]),
                (None,) + tuple(_leaf_pspec(spec, "tp", 2, "pipe", cfg)[1:]), mesh, {"tp": t}),
            specs["groups"][main], params["groups"][main])
        shard = shard_params(params, layout)
        got = dict(tree_items(shard["groups"][main]))
        for path, want in tree_items(want_main):
            assert torch.equal(got[path], want), (w, path)
        if kv_heads is not None:
            assert shard["groups"][main]["attn"]["wk"].shape[1:] == \
                params["groups"][main]["attn"]["wk"].shape[1:]
            assert shard["groups"][main]["attn"]["wq"].shape[-1] * 2 == \
                params["groups"][main]["attn"]["wq"].shape[-1]
        for key in params:
            if key != "groups":
                assert all(b is a for a, b in zip(tree_leaves(params[key]),
                                                   tree_leaves(shard[key]))), (w, key)
    _owned_once(params, layouts)


# ---------------------------------------------------------------- (b)
def test_resident_state_is_the_dry_runs_per_device_state_bytes():
    cfg = configs.get_config(GPT, smoke=True)
    model = build_model(cfg, "cpu")
    params = model.init(0)
    shape = ShapeSpec("smoke", 32, B, "train")
    tcfg = TeraPipeConfig(n_token_slices=4)
    mesh = Mesh(pipe=4)
    want = dryrun.trace_terapipe(cfg, shape, mesh, tcfg, per_device=True, block=1)["state_bytes"]
    batch = sum(t.numel() * t.element_size() for t in input_specs(cfg, shape).values())
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in jax_leaves(tree))
    whole = nbytes(params) + nbytes(adamw.adamw(1e-3).init(params))

    def rank_run(rank):
        layout = make_terapipe_value_and_grad(model, tcfg, shape.seq_len, B, mesh,
                                              {"pipe": rank}).plan.shard_layout(params)
        shard = shard_params(params, layout)
        return nbytes(shard) + nbytes(adamw.adamw(1e-3).init(shard))

    resident = ThreadRing(4, timeout=30).run(rank_run)
    for k, r in enumerate(resident):
        assert r + batch == want, (k, r + batch, want)
        assert r < whole / 2, (k, r, whole)


# ---------------------------------------------------------------- (c)
def test_adamw_step_on_four_ranks_matches_one_process():
    model, params = _model(GPT)
    gen = torch.Generator().manual_seed(5)
    grads = tree_map(lambda a: torch.randn(a.shape, generator=gen), params)
    opt = adamw.adamw(1e-2)
    state = opt.init(params)
    state = state._replace(m=tree_map(lambda a: 0.1 * a, grads),
                           v=tree_map(lambda a: 0.01 * a * a, grads))
    norm = adamw.global_norm(grads)
    assert float(norm) > 10                             # the clip acts
    upd, new = opt.update(grads, state, params)
    tcfg = TeraPipeConfig(cache_dtype=torch.float32, n_token_slices=4)

    def rank_run(rank):
        layout = make_terapipe_value_and_grad(model, tcfg, S, B, 4,
                                              {"pipe": rank}).plan.shard_layout(params)
        reduce = adamw.world_sq_norm(layout, rank)
        cut = lambda tree: shard_params(tree, layout)
        st = state._replace(m=cut(state.m), v=cut(state.v))
        g = cut(grads)
        u, n = adamw.adamw(1e-2, sq_norm_reduce=reduce).update(g, st, cut(params))
        return layout, adamw.global_norm(g, reduce), u, n

    runs = ThreadRing(4, timeout=30).run(rank_run)
    for k, (layout, n4, u, st) in enumerate(runs):
        assert torch.equal(n4, runs[0][1])              # one scalar on every rank
        assert abs(float(n4) - float(norm)) <= NORM_REL * float(norm), (k, float(n4), float(norm))
        for want_tree, got_tree, rank0 in ((upd, u, runs[0][2]), (new.m, st.m, runs[0][3].m),
                                           (new.v, st.v, runs[0][3].v)):
            for (path, w), g, g0, ls in zip(tree_items(want_tree), tree_leaves(got_tree),
                                            tree_leaves(rank0), tree_leaves(layout)):
                wb = ls.mine.cut(w)
                assert g.shape == wb.shape, (k, path)
                assert float((g - wb).abs().max()) <= REL * float(w.abs().max()), (k, path)
                if ls.whole:                            # replicated: bit-equal across ranks
                    assert torch.equal(g, g0), (k, path)


# ---------------------------------------------------------------- (d)
ARGS = ["--arch", GPT, "--smoke", "--device", "cpu", "--mode", "terapipe", "--token-slices",
        "4", "--steps", "4", "--batch", "4", "--seq", "32", "--log-every", "1"]


def _four_ranks(argv, K=4):
    """``launch.train.main(argv)`` on K ThreadRing ranks: each rank's
    ``out`` and history."""
    outs, hists = [{} for _ in range(K)], [[] for _ in range(K)]
    ThreadRing(K, timeout=60).run(
        lambda rank: train_launch.main(argv, hists[rank.rank], outs[rank.rank],
                                       groups={"pipe": rank}))
    return outs, hists


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def plain_four(tmp_path_factory):
    """Four ranks, 4 steps, a checkpoint every 2, no fault."""
    d = tmp_path_factory.mktemp("plain_four")
    outs, hists = _four_ranks(ARGS + ["--checkpoint-dir", str(d), "--checkpoint-every", "2"])
    return d, outs, hists


def test_a_fault_on_four_ranks_restores_every_rank_and_ends_as_without_it(plain_four, tmp_path,
                                                                          capsys):
    d_plain, plain, _ = plain_four
    d = tmp_path / "faulted"
    outs, hists = _four_ranks(ARGS + ["--checkpoint-dir", str(d), "--checkpoint-every", "2",
                                      "--simulate-failure-at", "3"])
    err = capsys.readouterr().err
    assert err.count("[fault] step 3, rank") == 4
    for k, (out, ref) in enumerate(zip(outs, plain)):
        assert [(r["op"], r["step"]) for r in out["checkpoints"]] == [
            ("save", 2), ("restore", 2), ("save", 4)], k
        for (path, a), b in zip(jax_items(out["state"]), jax_leaves(ref["state"])):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), (k, path)
    assert [r["step"] for r in hists[0]] == [1, 2, 3, 3, 4]
    got, want = (_npz(p / "step_00000004" / "proc0.npz") for p in (d, d_plain))
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(got[key], want[key]), key

    one = tmp_path / "one"
    train_launch.main(ARGS + ["--checkpoint-dir", str(one), "--checkpoint-every", "2"])
    solo = _npz(one / "step_00000004" / "proc0.npz")
    assert solo.keys() == want.keys()
    for key in want:
        w, g = solo[key].astype(np.float64), want[key].astype(np.float64)
        assert np.abs(g - w).max() <= REL * max(np.abs(w).max(), 1e-30), key
    assert ((one / "step_00000004" / "manifest.json").read_text()
            == (d_plain / "step_00000004" / "manifest.json").read_text())


def test_rescue_and_cannot_retry_on_four_ranks(plain_four, tmp_path, capsys):
    _, plain, _ = plain_four
    outs, _ = _four_ranks(ARGS + ["--simulate-failure-at", "1"])
    assert capsys.readouterr().out.count("retrying step with rescue references") == 1
    for k, (out, ref) in enumerate(zip(outs, plain)):
        for (path, a), b in zip(jax_items(out["state"]), jax_leaves(ref["state"])):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), (k, path)

    with pytest.raises(RuntimeError, match="injected fault"):
        _four_ranks(ARGS + ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every",
                            "3", "--simulate-failure-at", "1"])
    assert capsys.readouterr().err.count("cannot retry") == 4


# ---------------------------------------------------------------- (e)
def _whole_target(model, params):
    whole = meta_target(params)
    return {"params": whole, "opt": adamw.adamw(1e-3).init(whole), "step": 0}


def _ck_layout(layout):
    return {"params": layout, "opt": adamw.AdamWState(REPLICATED, layout, layout),
            "step": REPLICATED}


def test_four_rank_checkpoint_restores_into_two_ranks_one_process_and_jax(plain_four, tmp_path):
    d, plain, _ = plain_four
    model, params = _model(GPT)
    target = _whole_target(model, params)
    whole = CheckpointManager(str(d)).restore(target=target)
    assert whole["step"] == 4
    for k, out in enumerate(plain):                     # each rank's state: its blocks
        for (path, w), a, ls in zip(jax_items(whole), jax_leaves(out["state"]),
                                    jax_leaves(out["layout"])):
            assert torch.equal(torch.as_tensor(a), ls.mine.cut(torch.as_tensor(w))), (k, path)

    tcfg = TeraPipeConfig(n_token_slices=4)

    def two(rank):
        layout = make_terapipe_value_and_grad(model, tcfg, 32, B, 2, {"pipe": rank}) \
            .plan.shard_layout(params)
        ck = _ck_layout(layout)
        got = CheckpointManager(str(d), world=rank).restore(target=target, layout=ck)
        return got, ck

    for k, (got, ck) in enumerate(ThreadRing(2, timeout=30).run(two)):
        for (path, w), a, ls in zip(jax_items(whole), jax_leaves(got), jax_leaves(ck)):
            assert torch.equal(torch.as_tensor(a), ls.mine.cut(torch.as_tensor(w))), (k, path)

    jparams = tree_map(lambda a: a.numpy(), params)
    jtarget = {"params": jparams, "opt": jax_adamw.adamw(1e-3).init(jparams), "step": 0}
    back = JaxCheckpointManager(str(d)).restore(target=jtarget)
    for (path, w), j in zip(jax_items(whole), jax_leaves(back)):
        w = torch.as_tensor(w).numpy()
        assert np.array_equal(np.asarray(j), w), path
        assert path == "/step" or np.asarray(j).dtype == w.dtype, path
    JaxCheckpointManager(str(tmp_path / "jax")).save(4, back)
    assert (json.loads((tmp_path / "jax" / "step_00000004" / "manifest.json").read_text())
            == json.loads((d / "step_00000004" / "manifest.json").read_text()))


def test_one_process_checkpoint_restores_into_four_ranks(tmp_path):
    model, params = _model(GPT)
    opt = adamw.adamw(1e-2)
    gen = torch.Generator().manual_seed(7)
    grads = tree_map(lambda a: torch.randn(a.shape, generator=gen), params)
    upd, st = opt.update(grads, opt.init(params), params)
    state = {"params": adamw.apply_updates(params, upd), "opt": st, "step": 1}
    CheckpointManager(str(tmp_path)).save(1, state)
    target = _whole_target(model, params)
    tcfg = TeraPipeConfig(n_token_slices=4)

    def four(rank):
        layout = make_terapipe_value_and_grad(model, tcfg, 32, B, 4, {"pipe": rank}) \
            .plan.shard_layout(params)
        ck = _ck_layout(layout)
        mgr = CheckpointManager(str(tmp_path), world=rank)
        return mgr.restore(target=target, layout=ck), ck, mgr.log[-1]

    for k, (got, ck, rec) in enumerate(ThreadRing(4, timeout=30).run(four)):
        assert rec["step"] == 1 and rec["bytes"] < rec["file_bytes"], rec
        for (path, w), a, ls in zip(jax_items(state), jax_leaves(got), jax_leaves(ck)):
            assert torch.equal(torch.as_tensor(a), ls.mine.cut(torch.as_tensor(w))), (k, path)
