"""Multi-pod dry run on the meta device (reference: ``repro/launch/dryrun.py``):
one traced step of every (arch × shape × mode) cell, without hardware.

The reference builds the production mesh (16×16 single pod, 2×16×16
multi-pod) from 512 placeholder devices, lowers and compiles each cell's
step and records XLA's memory and cost analyses and the HLO's collectives.
The port's counterpart of lower-and-compile is one step of its own code on
``meta`` tensors, which allocates nothing (``--mode`` picks
``launch/steps.py::make_train_step``, ``make_prefill_step`` or
``make_decode_step``, or the pipelined step of ``launch/train.py``'s
``train_step`` over ``core/pipeline.py``), under the instruments of
``launch/instruments.py``: the live bytes by category, FLOPs, bytes
accessed, kernel calls and collective bytes, all per device.  The meta
device is this entry point's own device, not a fallback: nothing here
touches ``cuda``, and the kernels take their meta routes
(``kernels/ops.py``).

The per-device program is one device's, not the sum over the ranks the
process hosts:

* gspmd: the TP-local model over the ``model`` axis (``n_heads / 16``
  heads, the ``ff`` and ``experts`` axes cut as ``core/pipeline.py``'s
  ``_Plan`` cuts a stage's, KV heads replicated where 16 does not divide
  them) on one data rank's rows, its tensor-parallel group a
  :class:`~repro_torch.launch.instruments.RecordingGroup` hosting one rank.
  The embedding and head run whole on every device (the port's TP shards
  the blocks).  The state families refuse tensor parallelism
  (``models/rglru.py::check_no_tp``, ``models/ssm.py``), and heads that 16
  does not divide cannot be cut: those cells fail with the refusal, as the
  reference records a failed lowering (``--layout dp`` runs them);
* terapipe: one data rank (the data group hosts one rank); the pipe ranks
  all run in the process, and the account gives each rank the bytes of
  its own units, the shared work and its share of the state by its
  placement, and reports the largest rank.  With ``--terapipe-pipe`` below
  16 the stages run one tp rank, and the tp all-reduce of the TP regions'
  gradients after the step is counted at whole stacks (every pipe rank's
  rows).

What a record holds, and how it differs from the reference's (a later
roofline report reads both): the same keys (``memory``, ``flops``,
``bytes_accessed``, ``collectives``, ``analytic_memory``,
``min_bytes_per_dev``, ``roofline``, ``ok``/``skipped``/``error``), with

* ``memory`` the port's own: ``state_bytes`` (what the device holds before
  the step), ``peak_above_state`` and its ``by_category`` breakdown at the
  peak, ``peak_bytes`` their sum, and ``placement_state_bytes``, the state
  at the reference's placements (FSDP-sharded over the data axes: the
  eager port gathers nothing, so the trace holds the TP-local leaves
  whole);
* ``flops`` the trace's (``torch.utils.flop_counter``'s registry plus the
  kernels' meta routes), ``bytes_accessed`` each eager op's inputs read
  and outputs written once (the reference's is the HLO's);
* ``collectives`` per device, ring-weighted, with ``collectives_counted``
  (traced: the ring's shifts, the groups' all-reduces) and
  ``collectives_derived`` (what the eager port does not perform: FSDP's
  all-gathers and reduce-scatters, or data-parallel all-reduces of the
  gradients without FSDP, from the placements; the cotangents of a
  forward-only schedule's ring shifts) apart;
* ``trace_s`` in place of ``lower_s`` and no ``compile_s``, and
  ``kernel_calls`` (the meta routes' calls).

Usage:
  python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--mode gspmd|terapipe]
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, get_config, input_specs, skip_reason
from repro_torch.core.pipeline import TeraPipeConfig, _leaf_pspec, make_terapipe_value_and_grad
from repro_torch.core.schedules import (REGISTRY, check_virtual_stages, schedule_help,
                                        schedule_names)
from repro_torch.distributed.sharding import (NamedSharding, batch_shardings, local_shard,
                                              map_specs)
from repro_torch.kernels import ops as kops
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch import train as train_launch
from repro_torch.launch.instruments import (BLOCK, Account, Collectives, RecordingGroup,
                                           RecordingRing)
from repro_torch.launch.mesh import Mesh, data_axes, make_production_mesh, make_terapipe_mesh
from repro_torch.launch.steps import (abstract_caches, abstract_init, gspmd_shardings,
                                      make_decode_step, make_prefill_step, make_train_step)
from repro_torch.models import build_model
from repro_torch.models.attention import kv_heads_of_rank, tp_local_kv_heads
from repro_torch.optim.adamw import Optimizer, adamw, cosine_schedule
from repro_torch.tree import tree_leaves, tree_map

OUT_DIR = "experiments/dryrun_torch"

DP_ONLY_RULES = {"heads": None, "kv_heads": None, "ff": None,
                 "experts": None, "vocab": None, "embed": None}

#: the reference's flags with no counterpart here, and why
NO_COUNTERPART = {
    "save_hlo": "--save-hlo: the port lowers nothing, so there is no HLO to save",
    "compile": "--compile: the port compiles nothing; a cell is one traced step",
    "compare_executors": ("--compare-executors: the port has one tick executor, a Python "
                          "loop (TeraPipeConfig has no unroll), so there is no rolled vs "
                          "unrolled executor to compare"),
}


def cell_tag(arch: str, shape_name: str, multi_pod: bool, mode: str,
             virtual_stages: int = 1, variant: str = "",
             schedule: str = "contiguous") -> str:
    """Result-file tag for one cell — the single source of truth, used both
    when writing results (run_cell) and when probing the --skip-done cache."""
    tag = f"{arch}_{shape_name}_{'pod2' if multi_pod else 'pod1'}_{mode}"
    if virtual_stages > 1:
        tag += f"_v{virtual_stages}"
    if schedule not in ("contiguous", "interleaved"):
        tag += f"_{schedule}"       # interleaved is already the _v tag
    if variant:
        tag += f"_{variant}"
    return tag


def _optimizer(param_dtype=None) -> Optimizer:
    return adamw(cosine_schedule(3e-4, 100, 10_000), master_weights=param_dtype is not None)


def _tagging(opt: Optimizer, acct: Account, shares=None) -> Optimizer:
    """``opt`` whose ``update`` tags the gradients it is given."""
    def update(grads, state, params):
        acct.tag(grads, "grads", shares)
        return opt.update(grads, state, params)
    return Optimizer(opt.init, update)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _axes(spec) -> list:
    """The mesh axes a PartitionSpec cuts."""
    return [a for e in spec if e for a in (e if isinstance(e, tuple) else (e,))]


def _share(spec, mesh: Mesh) -> float:
    """The share of a leaf that one device holds under ``spec``."""
    return 1.0 / math.prod(mesh.shape[a] for a in _axes(spec))


def _specs_list(tree) -> list:
    """The PartitionSpecs of a placement tree in leaf order."""
    out = []
    map_specs(lambda s: out.append(s.spec if isinstance(s, NamedSharding) else s), tree)
    return out


def _account_result(acct: Account, ranks, whole: bool) -> dict:
    """Peak above the state (the largest rank's), its breakdown, FLOPs and
    bytes per device, the kernels' meta calls."""
    peaks = acct.peaks(ranks, whole=whole)
    rank = max(peaks, key=lambda r: peaks[r][0])
    peak, index = peaks[rank]
    out = {"peak_above_state": peak, "by_category": acct.breakdown(rank, index, whole=whole),
           "peak_rank": rank, "largest_off_meta_bytes": acct.largest_off_meta}
    out.update(acct.per_device(ranks, whole=whole))
    out["kernel_calls"] = {k: e["calls"] for k, e in kops.META.items()}
    out["kernel_flops"] = sum(e["flops"] for e in kops.META.values())
    return out


# ----------------------------------------------------------------- gspmd
def _tp_local_cfg(cfg, tp: int, group):
    """The TP-local config of ``core/pipeline.py::_Plan``: heads cut over
    ``tp``, KV heads cut where ``tp`` divides them, else the ones a rank's
    q heads read; ``tp_axis`` the group."""
    if cfg.n_heads % tp:
        raise ValueError(f"tensor parallelism cuts whole heads: n_heads {cfg.n_heads} is "
                         f"not a multiple of the model axis ({tp})")
    return cfg.replace(tp_axis=group, head_dim=cfg.hd, n_heads=cfg.n_heads // tp,
                       n_kv_heads=tp_local_kv_heads(cfg.n_heads, cfg.n_kv_heads, tp))


def _tp_local_params(params, specs, cfg, tp: int):
    """Rank 0's block of every group leaf (views of the full meta leaves,
    cut as a stage's by ``_leaf_pspec``), its attention keeping the KV heads
    its q heads read where they are replicated; the rest whole."""
    if tp == 1:
        return params
    mesh = Mesh(tp=tp)

    def leaf(spec, a):
        ps = _leaf_pspec(spec, "tp", tp, "pipe", cfg)
        return local_shard(a, (None,) + tuple(ps[1:]), mesh, {"tp": 0})

    def attn_heads(tree):
        if not isinstance(tree, dict):
            return tree
        tree = {k: attn_heads(v) for k, v in tree.items()}
        if "wk" in tree and "wv" in tree and cfg.n_kv_heads % tp:
            heads = kv_heads_of_rank(cfg.n_heads, cfg.n_kv_heads, tp, 0)
            hd = cfg.hd
            for key in ("wk", "wv"):
                w = tree[key]
                tree[key] = torch.cat([w[..., h * hd:(h + 1) * hd] for h in heads], dim=-1)
        return tree

    out = dict(params)
    out["groups"] = {g: attn_heads(map_specs(leaf, specs["groups"][g], sub))
                     for g, sub in params["groups"].items()}
    return out


def _local_rows(batch: dict, mesh: Mesh, daxes) -> dict:
    """The first data rank's rows of every batch leaf (all of them where
    the data axes do not divide the batch)."""
    sh = batch_shardings(batch, mesh, daxes)
    coord = {a: 0 for a in mesh.axis_names}
    return {k: local_shard(v, sh[k].spec, mesh, coord) for k, v in batch.items()}


def trace_gspmd(cfg, shape: ShapeSpec, mesh: Mesh, *, daxes=None, rules=None, fsdp=True,
                param_dtype=None, device: str = "meta") -> dict:
    """One device's step of a gspmd cell on meta (module docstring).  A
    mesh of one device (``Mesh(data=1, model=1)``) is one card's step of
    the whole model.  ``device="cpu"`` runs the same step on CPU tensors
    (seeded parameters, zero tokens), for tests.  Returns the trace's
    numbers."""
    daxes = tuple(data_axes(mesh) if daxes is None else daxes)
    tp = 1 if "model" in daxes else mesh.get("model")
    data = math.prod(mesh.shape[a] for a in daxes)
    counted = Collectives()
    group = RecordingGroup(tp, counted) if tp > 1 else None
    local_cfg = _tp_local_cfg(cfg, tp, group) if tp > 1 else cfg
    model = build_model(cfg, "meta")
    local = build_model(local_cfg, device)
    train = shape.kind == "train"
    opt = _optimizer(param_dtype) if train else None
    structs, specs, p_sh, o_structs, o_sh = gspmd_shardings(
        model, mesh, optimizer=opt, fsdp=fsdp, data_axes=daxes, param_dtype=param_dtype,
        rules=rules)
    coord = {a: 0 for a in mesh.axis_names}
    placed = lambda tree, sh: sum(_nbytes(local_shard(a, s, mesh, coord)) for a, s in
                                  zip(tree_leaves(tree), _specs_list(sh)))
    placement_state = {"params": placed(structs, p_sh)}
    if train:
        placement_state["opt_state"] = (placed(o_structs.m, o_sh.m) + placed(o_structs.v, o_sh.v)
                                        + (placed(o_structs.master, o_sh.master)
                                           if o_structs.master is not None else 0))
    del o_structs
    if device != "meta":
        structs = build_model(cfg, device).init(0)
        if param_dtype is not None:
            structs = tree_map(lambda a: a.to(param_dtype) if a.is_floating_point() else a,
                               structs)
    params = _tp_local_params(structs, specs, cfg, tp)
    batch = _local_rows(input_specs(cfg, shape), mesh, daxes)
    if device != "meta":
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device) for k, v in batch.items()}
    b_local = next(iter(batch.values())).shape[0]

    # derived: what XLA's placements imply and the eager port does not do:
    # FSDP gathers each leaf it cuts for the forward and the backward and
    # reduce-scatters its gradient; a leaf it does not cut has its
    # gradient all-reduced over the data axes
    derived = Collectives()
    for a, s in zip(tree_leaves(params), _specs_list(p_sh)) if data > 1 else ():
        if set(_axes(s)) & set(daxes):
            derived.add("all-gather", _nbytes(a) * (2 if train else 1))
            if train:
                derived.add("reduce-scatter", _nbytes(a))
        elif train:
            derived.add("all-reduce", _nbytes(a))

    kops.reset_meta()
    acct = Account()
    state = {"params": params, "batch": batch}
    if train:
        state["opt_state"] = opt.init(params)
    else:
        if shape.kind == "decode":
            state["caches"] = abstract_caches(local, b_local, shape.seq_len)
    for tree in state.values():
        acct.register_state(tree)
    state_bytes = acct.base
    with acct:
        if train:
            step = make_train_step(local, _tagging(opt, acct))
            new_params, new_opt, _ = step(state["params"], state["opt_state"], batch)
            acct.tag(new_params, "params")
            acct.tag(new_opt, "opt_state")
        elif shape.kind == "prefill":
            _, caches = make_prefill_step(local, shape.seq_len)(params, batch)
            acct.tag(caches, "caches")
        else:   # one new token against a seq_len-deep cache
            make_decode_step(local)(params, state["caches"], batch, shape.seq_len - 1)
    res = _account_result(acct, (None,), whole=True)
    res.update(state_bytes=state_bytes, placement_state_bytes=placement_state, events=acct.events,
               b_local=b_local, tp=tp, data=data,
               counted=counted.per_device((None,)), derived=derived.per_device((None,)),
               program=(f"TP-local model ({local_cfg.n_heads} heads, {local_cfg.n_kv_heads} KV "
                        f"heads per device) at {b_local} rows" if tp > 1 else
                        f"the whole model at {b_local} rows"))
    return res


# -------------------------------------------------------------- terapipe
def trace_terapipe(cfg, shape: ShapeSpec, mesh: Mesh, tcfg: TeraPipeConfig, *,
                   per_device: bool = True, block: int = BLOCK) -> dict:
    """The pipelined train step (``launch/train.py::train_step`` over
    ``make_terapipe_value_and_grad``) on meta.  ``per_device``: one data
    rank and one tp rank (recording groups hosting one rank), the largest
    pipe rank's numbers, the state at each device's share of its
    placement; else the whole process, every rank it hosts on one card,
    as a single-card run holds them.  ``block``: the account's allocation
    granularity in bytes (1: each tensor's own bytes)."""
    if shape.kind != "train":
        raise ValueError("terapipe mode traces the train step")
    K, tp = mesh.get("pipe"), mesh.get("tp")
    daxes = data_axes(mesh)
    data = math.prod(mesh.shape[a] for a in daxes)
    counted = Collectives()
    acct: Optional[Account] = None
    rank_fn = lambda: acct.rank() if acct is not None else None
    ring = RecordingRing(K, counted, on_tick=lambda: acct.new_tick() if acct else None)
    groups = {"pipe": ring}
    model = build_model(cfg, "meta")
    params, specs = abstract_init(model)
    if per_device:
        if tp > 1:
            groups["tp"] = RecordingGroup(tp, counted, rank_fn)
        groups["data"] = RecordingGroup(data, counted, rank_fn)
    vg = make_terapipe_value_and_grad(model, tcfg, shape.seq_len, shape.global_batch, mesh,
                                      groups)
    plan = vg.plan
    if per_device:
        share = [_share(s, mesh) for s in _specs_list(plan.param_shardings_fn()(specs))]
        # the data group's calls: the loss, then every gradient leaf in order
        groups["data"].weights = [1.0] + share
    else:
        share = [1.0] * sum(1 for _ in tree_leaves(params))
    shares = lambda i: share[i]
    opt = _optimizer()
    state = {"params": tree_map(lambda p: p.requires_grad_(True), params)}
    del params
    state["opt_state"] = opt.init(state["params"])
    opt_share = [1.0] + share + share
    batch = input_specs(cfg, shape)
    kops.reset_meta()
    acct = Account(plan, block)
    acct.register_state(state["params"], shares)
    acct.register_state(state["opt_state"], lambda i: opt_share[i])
    acct.register_state(batch, (lambda i: 1.0 / data) if per_device else None)
    state_bytes = acct.base
    with acct:
        train_launch.train_step(vg, _tagging(opt, acct, shares), state, batch)
        acct.tag(state["params"], "params", shares)
        acct.tag(state["opt_state"], "opt_state", lambda i: opt_share[i])
    ranks = plan.ring.ranks
    res = _account_result(acct, ranks, whole=not per_device)
    res.update(state_bytes=state_bytes, b_local=plan.b_local, tp=tp, data=data,
               counted=counted.per_device(ranks),
               derived=ring.derived.per_device(ranks),
               slice_lens=list(plan.slice_lens),
               residual_peak=getattr(vg, "residual_peak", None),
               program=(f"one data rank ({plan.b_local} rows), pipe {K}"
                        + (f" x tp {tp} (one tp rank)" if tp > 1 else "")
                        + ", the largest pipe rank" if per_device else
                        f"every rank in one process ({plan.b_local} rows)"))
    return res


def _terapipe_tcfg(model, shape, multi_pod, n_slices, n_pipe, *, dp_plan, virtual_stages,
                   schedule, rec: dict):
    """The reference's ``_lower_terapipe`` set-up: the mesh, the schedule
    (V > 1 promotes contiguous to interleaved), the DP plan or the slice
    count snapped for V > 1, and the TeraPipeConfig."""
    mesh = make_terapipe_mesh(n_pipe=n_pipe, multi_pod=multi_pod)
    tp = mesh.get("tp")
    if virtual_stages > 1 and schedule == "contiguous":
        schedule = "interleaved"     # back-compat: V>1 implies interleaving
    if REGISTRY[schedule].has_backward and tp > 1:
        raise NotImplementedError(
            f"--schedule {schedule} needs a TP-free pipe mesh; pipe={n_pipe} "
            f"leaves tp={tp} (pick --terapipe-pipe 16)")
    slice_lens = None
    if dp_plan:
        from repro_torch.core.cost_model import H100, AnalyticCostModel
        from repro_torch.core.dp import ensure_executable, optimal_slicing
        cm = AnalyticCostModel(model.cfg, H100,
                               layers_per_stage=max(1, model.n_blocks // n_pipe))
        plan = optimal_slicing(cm, shape.seq_len, n_pipe, granularity=128,
                               virtual_stages=virtual_stages)
        slices = ensure_executable(plan.slices, schedule=schedule, n_ranks=n_pipe,
                                   n_microbatches=1, granularity=128)
        slice_lens = tuple(slices)
        rec["dp_plan_hardware"] = (f"{H100.name}: core/cost_model.py::H100, one H100 SXM's "
                                   f"data-sheet rates with the efficiency and occupancy floor "
                                   f"fitted on the card")
        print(f"[dp-plan] {len(slice_lens)} slices: {list(slice_lens)}", flush=True)
    elif virtual_stages > 1 and n_slices % n_pipe:
        ok = [m for m in range(n_pipe, shape.seq_len + 1, n_pipe)
              if shape.seq_len % m == 0]
        if not ok:
            raise ValueError(
                f"--virtual-stages {virtual_stages} needs a token-slice "
                f"count that is a multiple of pipe={n_pipe} AND divides "
                f"seq_len={shape.seq_len}; none exists — pick a pipe degree "
                f"whose factors divide the sequence length")
        snapped = min((m for m in ok if m >= n_slices), default=ok[-1])
        print(f"[terapipe] V={virtual_stages} needs M % pipe == 0; adjusting "
              f"token slices {n_slices} -> {snapped}"
              + (" (capped: no valid count >= request)"
                 if snapped < n_slices else ""), flush=True)
        n_slices = snapped
    tcfg = TeraPipeConfig(n_token_slices=n_slices, slice_lens=slice_lens, n_microbatches=1,
                          schedule=schedule, virtual_stages=virtual_stages)
    return mesh, tcfg


# -------------------------------------------------------------- the cells
def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             mode: str = "gspmd", out_dir: str = OUT_DIR,
             terapipe_slices: int = 4, terapipe_pipe: int = 16,
             param_dtype=None, remat_policy: str = "full",
             layout: str = "tp", fsdp: bool = True, capacity=None,
             seqpar: bool = False, terapipe_dp: bool = False,
             virtual_stages: int = 1, variant: str = "",
             schedule: str = "contiguous", use_kernel: bool = False,
             smoke: bool = False, shape: Optional[ShapeSpec] = None,
             mesh: Optional[Mesh] = None) -> dict:
    """One cell's record, written to ``out_dir/<cell_tag>.json``.  The
    reference's arguments; ``smoke`` (the SMOKE config), ``shape`` (a
    ShapeSpec in place of ``SHAPES[shape_name]``) and ``mesh`` (in place
    of the production mesh, gspmd only) cut a cell down for tests.
    ``seqpar`` is accepted and does nothing (``gspmd_shardings``)."""
    shape = shape or SHAPES[shape_name]
    cfg = get_config(arch, smoke=smoke)
    if remat_policy != "full":
        cfg = cfg.replace(remat_policy=remat_policy)
    if capacity is not None:
        cfg = cfg.replace(capacity_factor=capacity)
    if use_kernel:
        cfg = cfg.replace(use_kernel=True)
    reason = skip_reason(arch, shape_name)
    if mode != "terapipe":
        virtual_stages = 1      # only the terapipe lowering consumes these —
        schedule = "contiguous"  # don't stamp tags onto identical cells
    tag = cell_tag(arch, shape_name, multi_pod, mode, virtual_stages, variant,
                   schedule)
    rec = {"arch": arch, "shape": shape_name, "mode": mode,
           "multi_pod": multi_pod, "n_chips": 512 if multi_pod else 256,
           "virtual_stages": virtual_stages, "schedule": schedule}
    if reason:
        rec["skipped"] = reason
        return _dump(rec, out_dir, tag)

    t0 = time.time()
    try:
        if param_dtype == "bf16":
            param_dtype = torch.bfloat16
        if mode == "terapipe":
            model = build_model(cfg, "meta")
            t_mesh, tcfg = _terapipe_tcfg(model, shape, multi_pod, terapipe_slices,
                                          terapipe_pipe, dp_plan=terapipe_dp,
                                          virtual_stages=virtual_stages,
                                          schedule=schedule, rec=rec)
            res = trace_terapipe(cfg, shape, mesh or t_mesh, tcfg)
            n_chips = (mesh or t_mesh).size
        else:
            g_mesh = mesh or make_production_mesh(multi_pod=multi_pod)
            daxes, rules = data_axes(g_mesh), None
            if layout == "dp":
                daxes, rules = daxes + ("model",), DP_ONLY_RULES
            res = trace_gspmd(cfg, shape, g_mesh, daxes=daxes, rules=rules, fsdp=fsdp,
                              param_dtype=param_dtype)
            n_chips = g_mesh.size
        rec["n_chips"] = n_chips
        rec["trace_s"] = time.time() - t0
        rec["program"] = res["program"]
        rec["memory"] = {"state_bytes": res["state_bytes"],
                         "peak_above_state": res["peak_above_state"],
                         "by_category": res["by_category"],
                         "peak_bytes": res["state_bytes"] + res["peak_above_state"],
                         "peak_rank": res["peak_rank"]}
        if "placement_state_bytes" in res:
            rec["memory"]["placement_state_bytes"] = res["placement_state_bytes"]
        rec["flops"] = float(res["flops"])
        rec["bytes_accessed"] = float(res["bytes_accessed"])
        coll = {k: res["counted"][k] + res["derived"][k] for k in ha.COLLECTIVE_MULT}
        coll["total"] = sum(coll.values())
        rec["collectives"] = coll
        rec["collectives_counted"] = res["counted"]
        rec["collectives_derived"] = res["derived"]
        rec["kernel_calls"] = res["kernel_calls"]
        rec["largest_off_meta_bytes"] = res["largest_off_meta_bytes"]
        for key in ("slice_lens", "residual_peak"):
            if key in res:
                rec[key] = res[key]

        model_shard = n_chips // res["data"]        # 16 on the production meshes
        rec["analytic_memory"] = ha.analytic_memory_per_device(
            cfg, shape.seq_len, shape.global_batch, shape.kind, n_chips,
            model_shard=model_shard)
        rec["min_bytes_per_dev"] = ha.analytic_min_bytes(
            cfg, shape.seq_len, shape.global_batch, shape.kind, n_chips,
            model_shard=model_shard)
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        if shape.kind == "train":
            mf = ha.model_flops_train(cfg, shape.seq_len, shape.global_batch)
        else:
            mf = ha.model_flops_forward(cfg, tokens)
        roof = ha.Roofline(rec["flops"], rec["bytes_accessed"], coll["total"], n_chips, mf)
        rec["roofline"] = roof.to_dict()
        rec["ok"] = True
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return _dump(rec, out_dir, tag)


def _dump(rec: dict, out_dir: str, tag: str) -> dict:
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    with open(Path(out_dir) / f"{tag}.json", "w") as f:
        json.dump(rec, f, indent=1)
    status = ("SKIP" if rec.get("skipped") else
              "OK" if rec.get("ok") else "FAIL")
    extra = ""
    if rec.get("ok"):
        extra = (f" mem/dev={rec['memory']['peak_bytes']/2**30:.2f}GiB "
                 f"flops={rec['flops']:.3e} "
                 f"coll={rec['collectives']['total']:.3e}B "
                 f"bottleneck={rec['roofline']['bottleneck']} "
                 f"trace={rec['trace_s']:.1f}s")
    elif rec.get("error"):
        extra = " " + rec["error"][:160]
    print(f"[{status}] {tag}{extra}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mode", default="gspmd", choices=["gspmd", "terapipe"])
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--terapipe-slices", type=int, default=4)
    ap.add_argument("--terapipe-pipe", type=int, default=16)
    ap.add_argument("--schedule", default="contiguous",
                    choices=list(schedule_names()),
                    help="pipeline schedule (core/schedules registry; "
                    "terapipe mode only): " + schedule_help())
    ap.add_argument("--virtual-stages", type=int, default=1,
                    help="V layer chunks per pipeline rank (interleaved "
                    "schedule; terapipe mode only)")
    ap.add_argument("--param-dtype", default=None, choices=[None, "bf16"])
    ap.add_argument("--remat-policy", default="full", choices=["full", "dots"])
    ap.add_argument("--layout", default="tp", choices=["tp", "dp"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--capacity", type=float, default=None)
    ap.add_argument("--seqpar", action="store_true",
                    help="accepted; does nothing (no sharding propagation to hint)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="route attention through the kernels' meta routes "
                    "(pair with --variant to tag cells)")
    ap.add_argument("--terapipe-dp", action="store_true",
                    help="plan the slices with Algorithm 1 on core/cost_model.py's H100")
    ap.add_argument("--variant", default="")
    for flag in NO_COUNTERPART:
        ap.add_argument("--" + flag.replace("_", "-"), action="store_true",
                        help="refused: " + NO_COUNTERPART[flag].split(": ", 1)[1])
    args = ap.parse_args(argv)
    for flag, why in NO_COUNTERPART.items():
        if getattr(args, flag):
            ap.error(why)
    # validate up front: an invalid combination must not run (and, worse,
    # write its failure record under another schedule's cell tag)
    sched_eff = ("interleaved" if args.schedule == "contiguous"
                 and args.virtual_stages > 1 else args.schedule)
    try:
        check_virtual_stages(sched_eff, args.virtual_stages)
    except ValueError as e:
        ap.error(str(e))

    cells = []
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    n_fail = 0
    t0 = time.time()
    for a, s, mp in cells:
        tag = cell_tag(a, s, mp, args.mode,
                       args.virtual_stages if args.mode == "terapipe" else 1,
                       args.variant,
                       args.schedule if args.mode == "terapipe"
                       else "contiguous")
        if args.skip_done and (Path(args.out_dir) / f"{tag}.json").exists():
            prev = json.loads((Path(args.out_dir) / f"{tag}.json").read_text())
            if prev.get("ok") or prev.get("skipped"):
                print(f"[CACHED] {tag}", flush=True)
                continue
        rec = run_cell(a, s, multi_pod=mp, mode=args.mode, out_dir=args.out_dir,
                       terapipe_slices=args.terapipe_slices,
                       terapipe_pipe=args.terapipe_pipe,
                       param_dtype=args.param_dtype,
                       remat_policy=args.remat_policy, layout=args.layout,
                       fsdp=not args.no_fsdp, capacity=args.capacity,
                       seqpar=args.seqpar, terapipe_dp=args.terapipe_dp,
                       virtual_stages=args.virtual_stages,
                       variant=args.variant, schedule=args.schedule,
                       use_kernel=args.use_kernel)
        if not (rec.get("ok") or rec.get("skipped")):
            n_fail += 1
    print(f"[dryrun] {len(cells)} cells, {n_fail} failed, {time.time() - t0:.1f} s",
          flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
