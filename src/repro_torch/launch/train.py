"""Training launcher (reference: ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch gpt3-1b --use-kernel \\
        --steps 5 --batch 4 --seq 2048
    python -m repro_torch.launch.train --arch gpt3-1b --use-kernel \\
        --mode terapipe --token-slices 8 --steps 5 --batch 4 --seq 2048
    python -m repro_torch.launch.train --arch gpt3-1b --smoke --device cpu \\
        --mode terapipe --dp-plan --steps 3 --batch 2 --seq 512
    python -m repro_torch.launch.train --arch deepseek-moe-16b --smoke --device cpu \\
        --mode terapipe --seq 64 --token-slices 4 --steps 3 --batch 2
    python -m repro_torch.launch.train --arch phi-3-vision-4.2b --smoke --device cpu \\
        --mode terapipe --seq 64 --token-slices 4 --steps 3 --batch 2

Each step computes the loss and its gradients on a synthetic batch (with
the stubbed frontends' random inputs: vlm patch embeddings ahead of
``--seq - n_patches`` text tokens, enc-dec ``--seq`` frames), then
AdamW with a cosine schedule updates the parameters, all on ``--device``
(``cuda`` unless the caller asks for ``cpu``; without a GPU the default
raises).  ``--use-kernel`` routes attention through the hand-written CUDA
kernels, forward and backward.

Modes:
* ``gspmd``: ``model.loss`` on one device, the reference's single-device
  step;
* ``terapipe``: the token-slice pipeline (``core/pipeline.py``) on
  ``PIPE_RANKS`` virtual ranks, M = ``--token-slices`` uniform slices or the
  slices that Algorithm 1 plans (``--dp-plan``), D = ``--microbatches``,
  under ``--schedule`` with ``--virtual-stages`` chunks per rank;
* ``gpipe``: the same executor with D microbatches and M = 1.
The pipelined modes never fall back to the gspmd step.

One process per card (the reference's mesh over its devices,
``repro/launch/train.py:200-205``): under ``torchrun`` (``WORLD_SIZE`` > 1)
the pipelined modes run on ``Mesh(data=n // pipe, pipe=min(4, n))`` over
the ``n`` processes, each hosting one rank of each axis
(``distributed/transport.py``): NCCL on ``cuda:LOCAL_RANK``, or gloo on
the CPU with ``--device cpu``.  Every rank builds the same parameters from
``--seed``, keeps its shard of them and drops the rest
(``core/pipeline.py::shard_params``: the layer rows of its pipe rank's
chunks, with the embedding, the head, the final norm and the pre- and
post-groups whole), creates the AdamW moments on that shard, and takes its
data rank's rows of each batch.  The clip norm is summed over the world
(``optim/adamw.py::world_sq_norm``), so the replicated leaves get the same
update on every rank; at the end their checksum must be equal on every
rank.  ``--dp-plan`` plans on rank 0, which hands the slices to the
others; only rank 0 prints.  ``--mode gspmd`` is refused across processes
(the reference builds no mesh for it)::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch gpt3-1b --use-kernel --mode terapipe --token-slices 8 \
        --steps 3 --batch 4 --seq 2048 --checkpoint-dir ck --checkpoint-every 50
    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
        --arch gpt3-1b --use-kernel --mode terapipe --token-slices 8 \
        --steps 6 --batch 4 --seq 2048 --checkpoint-dir ck --resume

Fault tolerance, the reference's supervisor (``repro/launch/train.py``,
PR 3's contract), in every mode and schedule:
* ``--checkpoint-dir``: a checkpoint (``checkpoint/manager.py``, the
  reference's format) every ``--checkpoint-every`` steps and at the end;
  ``--resume`` restores the latest one first;
* ``--simulate-failure-at k`` raises once, after step k's ``train_step``
  has returned; that step's result is thrown away;
* on a fault the supervisor restores the latest checkpoint and continues.
  With a checkpoint dir but nothing saved yet it raises ("cannot retry");
  without a checkpoint dir it replays the step from the pre-step
  ``params``/``opt_state`` references.  ``train_step`` rebinds the state,
  so those references are the torch form of the reference's "donation off":
  they are held only in the one case that retries (no checkpoint dir and a
  fault to inject), since they keep a second copy of the moments alive
  across the update.  A fault that repeats at the same step after a
  restore is raised: replaying cannot cure it.

Across processes the supervisor runs on every rank together (``main``'s
loop, which a caller hosting the ranks itself, such as ``ThreadRing``'s
threads, drives the same way through ``main(argv, groups=...)``).  Each
step's fault flag is summed over the world before the step counts, so a
fault on any rank sends every rank to
the same checkpoint (rank 0's latest step, broadcast), or every rank to
its rescue references, or every rank to the "cannot retry" raise.  The
checkpoint is the reference's one ``proc0.npz`` of whole leaves, gathered
on rank 0 and cut again on restore, so it restores into any count of
processes and into the JAX package.  A fault raised inside a collective
(a dead NCCL peer, a broken ``ThreadRing``) cannot be agreed on: it ends
the run with an error on every rank, and the recovery from it is
``torchrun --max-restarts N`` with ``--resume``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, meta_target
from repro_torch.configs import get_config
from repro_torch.core.cost_model import H100, TPU_V5E, AnalyticCostModel, HardwareSpec
from repro_torch.core.dp import DPResult, ensure_executable, optimal_slicing, plan_schedule_info
from repro_torch.core.pipeline import (TeraPipeConfig, make_terapipe_value_and_grad,
                                       shard_params, value_and_grad)
from repro_torch.core.schedule import SlicingScheme
from repro_torch.core.schedules import (KIND_BWD, KIND_BWD_INPUT, KIND_BWD_WEIGHT, REGISTRY,
                                        check_virtual_stages, schedule_help, schedule_names)
from repro_torch.core.simulator import simulate
from repro_torch.data.pipeline import DataPipeline, SyntheticSource
from repro_torch.distributed import transport
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.distributed.sharding import REPLICATED
from repro_torch.optim.adamw import (AdamWState, adamw, apply_updates, cosine_schedule,
                                     world_sq_norm)
from repro_torch.tree import jax_leaves, tree_leaves, tree_map

#: pipeline ranks: the reference's ``pipe = min(4, n_devices)`` on any host
#: with four devices or more; on one card the ranks are virtual
PIPE_RANKS = 4


def launch_mesh(n: int) -> Mesh:
    """The reference's mesh over ``n`` devices (``repro/launch/train.py:
    200-205``): ``pipe = min(4, n)``, ``data = n // pipe``; ``n`` must fill
    it, as the reference's ``make_mesh`` requires."""
    pipe = min(PIPE_RANKS, n)
    if n < 1 or n % pipe:
        raise ValueError(f"{n} processes do not fill the reference's (data, pipe) mesh: pipe = "
                         f"min(4, n) = {pipe} must divide n (repro/launch/train.py:200-205)")
    return Mesh(data=n // pipe, pipe=pipe)


def check_processes(args, n: int) -> None:
    """What the launcher refuses with ``n`` > 1 processes, with the reason
    the reference gives."""
    if n > 1 and args.mode == "gspmd":
        raise ValueError("--mode gspmd runs one process: the reference's launcher builds no "
                         "mesh for it (repro/launch/train.py:202), so its step is one "
                         "device's; use --mode terapipe or gpipe across processes")


def plan_slices(cfg, seq: int, n_ranks: int, hw: HardwareSpec, *, microbatches: int = 1,
                batch: int = 1, schedule: str = "contiguous", virtual_stages: int = 1):
    """Algorithm 1 end to end, the reference's ``--dp-plan`` block
    (``repro/launch/train.py:51-120``): plan the slicing at granularity
    ``seq // 16`` and ``virtual_stages`` on the analytic model of ``hw``
    with ``batch`` sequences per slice, make it executable for
    ``schedule`` (the promoted one), then rank every registered schedule on
    it with the simulator, each at ``V = max(virtual_stages, min_virtual)``
    where its V is free.  Prints the ``[dp-plan]`` lines; returns
    ``(slice_lens, DPResult)``."""
    layers = max(1, cfg.n_layers // n_ranks)
    cm = AnalyticCostModel(cfg, hw, layers_per_stage=layers, batch=batch)
    g = max(1, seq // 16)
    plan: DPResult = optimal_slicing(cm, seq, n_ranks, granularity=g,
                                     virtual_stages=virtual_stages)
    slice_lens = tuple(ensure_executable(plan.slices, schedule=schedule, n_ranks=n_ranks,
                                         n_microbatches=microbatches, granularity=g))
    info = plan_schedule_info(slice_lens, schedule=schedule, n_ranks=n_ranks,
                              virtual_stages=virtual_stages, n_microbatches=microbatches)
    print(f"[dp-plan] slices {list(slice_lens)} "
          f"(predicted {plan.latency*1e3:.1f} ms/iter; "
          + " ".join(f"{k}={v}" for k, v in info.items()) + ")")
    # rank every registered schedule on this plan: its executability
    # post-pass, then its fwd(+typed bwd) tick table priced by the model
    cm_u = AnalyticCostModel(cfg, hw, layers_per_stage=layers, batch=batch,
                             include_backward=False)
    D = microbatches
    best = None
    for name, spec in REGISTRY.items():
        V = max(virtual_stages, spec.min_virtual) if spec.max_virtual is None else spec.min_virtual
        sl = ensure_executable(plan.slices, schedule=name, n_ranks=n_ranks,
                               n_microbatches=D, granularity=g)
        sch = SlicingScheme.from_dp(seq, D, [(1, list(sl))] * D)
        if spec.has_backward:
            lat = simulate(
                sch, n_ranks, lambda b, l, c: cm_u.unit_cost(l, c),
                discipline=name, virtual_stages=V, include_backward=True,
                t_bwd_of=lambda b, l, c: cm_u.unit_cost(l, c, kind=KIND_BWD),
                t_bwd_input_of=lambda b, l, c: cm_u.unit_cost(l, c, kind=KIND_BWD_INPUT),
                t_bwd_weight_of=lambda b, l, c: cm_u.unit_cost(l, c, kind=KIND_BWD_WEIGHT))
        else:
            disc = "lockstep" if name == "contiguous" else name
            lat = simulate(sch, n_ranks, lambda b, l, c: cm(l, c),
                           discipline=disc, virtual_stages=V)
        sinfo = plan_schedule_info(sl, schedule=name, n_ranks=n_ranks,
                                   virtual_stages=V, n_microbatches=D)
        print(f"[dp-plan]   {name:<17} V={V} {lat*1e3:10.3f} ms/iter  "
              + " ".join(f"{k}={v}" for k, v in sinfo.items()))
        if best is None or lat < best[1]:
            best = (name, lat, V)
    print(f"[dp-plan] winner: {best[0]} (V={best[2]}, "
          f"{best[1]*1e3:.3f} ms/iter simulated fwd+bwd)")
    return slice_lens, plan


def make_data(cfg, batch: int, seq: int, seed: int) -> DataPipeline:
    """The synthetic batches of ``seq`` positions (reference
    ``launch/train.py:229-237``), with the stubbed frontends' inputs: vlm
    patch embeddings, which prefix the token stream, so only ``seq -
    n_patches`` positions carry text; enc-dec frames, as many as ``seq``."""
    extra, text_len = None, seq
    if cfg.family == "vlm":
        extra = {"patch_embeds": ((cfg.n_patches, cfg.d_model), np.float32)}
        text_len = seq - cfg.n_patches
    elif cfg.family == "encdec":
        extra = {"frames": ((seq, cfg.d_model), np.float32)}
    return DataPipeline(SyntheticSource(cfg.vocab_size, seed), batch, text_len,
                        extra_specs=extra)


def _promoted_schedule(args) -> str:
    """``contiguous`` with ``--virtual-stages > 1`` is ``interleaved``."""
    if args.schedule == "contiguous" and args.virtual_stages > 1:
        return "interleaved"
    return args.schedule


def build_value_and_grad(model, args, mesh=None, groups=None):
    """``(params, batch) -> (loss, grads)`` for the selected mode; the
    pipelined modes on ``mesh`` with the process's ``groups`` (default:
    ``PIPE_RANKS`` virtual ranks in process).  Across processes
    ``--dp-plan`` plans on rank 0 alone and hands its slices to the
    others."""
    if args.mode == "gspmd":
        return value_and_grad(model.loss)
    mesh = mesh or Mesh(pipe=PIPE_RANKS)
    schedule = _promoted_schedule(args)
    slice_lens = None
    if args.dp_plan:
        # on the card: the card's spec, fitted at the executor's batch per
        # slice, priced at that batch; on the CPU: the reference's own
        # target at its batch of 1, so a CPU plan equals the reference's
        on_card = model.device.type == "cuda"
        planned = [None]
        if not _distributed() or torch.distributed.get_rank() == 0:
            planned[0], _ = plan_slices(
                model.cfg, args.seq, mesh.get("pipe"), H100 if on_card else TPU_V5E,
                microbatches=args.microbatches,
                batch=args.batch // args.microbatches if on_card else 1,
                schedule=schedule, virtual_stages=args.virtual_stages)
        if _distributed():
            torch.distributed.broadcast_object_list(planned, src=0)
        slice_lens = planned[0]
    tcfg = TeraPipeConfig(
        n_token_slices=args.token_slices if args.mode == "terapipe" else 1,
        slice_lens=slice_lens, n_microbatches=args.microbatches,
        schedule=schedule, virtual_stages=args.virtual_stages)
    return make_terapipe_value_and_grad(model, tcfg, args.seq, args.batch, mesh, groups)


def _distributed() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def _start_processes(args) -> tuple:
    """Under torchrun: the process group (NCCL on ``cuda:LOCAL_RANK``, gloo
    with ``--device cpu``), the launch mesh and this process's groups, and
    the device it runs on.  One process: ``(None, None, args.device)``."""
    n = int(os.environ.get("WORLD_SIZE", "1"))
    check_processes(args, n)
    if n == 1:
        return None, None, args.device
    mesh = launch_mesh(n)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"--device {args.device}: across processes cuda (NCCL) or cpu (gloo)")
    if not _distributed():
        transport.init_process_group("env://", int(os.environ["RANK"]), n,
                                     "nccl" if device.type == "cuda" else "gloo")
    return mesh, transport.mesh_groups(mesh, device), device


def _check_ranks_agree(params, layout, world) -> None:
    """Raises on every rank unless every rank's checksum of the leaves
    every rank holds whole (the sum and the sum of squares in float64,
    leaf by leaf in tree order) is rank 0's: every rank must have applied
    the same updates to them."""
    mine = torch.zeros(2, dtype=torch.float64, device=next(iter(tree_leaves(params))).device)
    for a, ls in zip(tree_leaves(params), tree_leaves(layout)):
        if ls.whole:
            a = a.detach().double()
            mine[0] += a.sum()
            mine[1] += (a * a).sum()
    every = world.gather(mine, dst=0)
    differ = [r for r, c in enumerate(every or []) if not torch.equal(c, every[0])]
    flag = torch.tensor(len(differ), dtype=torch.int64, device=mine.device)
    if int(world.all_reduce([flag])[0]):
        raise RuntimeError("ranks ended with replicated parameters unlike rank 0's"
                           + (f": ranks {differ}, checksums {[c.tolist() for c in every]}"
                              if every else ""))


def train_step(vg_fn, opt, state: dict, batch) -> torch.Tensor:
    """One step: loss and gradients of ``state["params"]`` on ``batch`` by
    ``vg_fn``, then the AdamW update of ``state["params"]`` and
    ``state["opt_state"]``, rebound in the dict; returns the loss, detached."""
    loss, grads = vg_fn(state["params"], batch)
    # rebinding as soon as each value is replaced keeps one copy of the
    # moments and of the gradients alive at a time
    updates, state["opt_state"] = opt.update(grads, state["opt_state"], state["params"])
    del grads
    state["params"] = tree_map(lambda p: p.requires_grad_(True),
                               apply_updates(state["params"], updates))
    return loss


def main(argv=None, history: Optional[list] = None, out: Optional[dict] = None,
         groups: Optional[dict] = None) -> float:
    """Runs the training loop and returns the final loss.  If ``history``
    is a list, each logged step appends ``{"step", "loss", "tok_s",
    "ms_per_step"}`` to it, the numbers its printed line shows.  If ``out``
    is a dict, it receives the final ``"state"`` (``{"params", "opt",
    "step"}``, a checkpoint's tree; across processes this process's
    shard), its ``"layout"`` (``None`` in one process) and the checkpoint
    manager's records (``"checkpoints"``: one ``{"op", "step", "seconds",
    "bytes", "file_bytes"}`` per save and restore).  ``groups``: the
    process's groups, for a caller that hosts the ranks itself (one
    ``ThreadRing`` rank per thread: ``{"pipe": rank}``, the launch mesh of
    ``rank.size`` processes); by default torchrun's environment decides."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--mode", default="gspmd", choices=["gspmd", "terapipe", "gpipe"])
    ap.add_argument("--token-slices", type=int, default=4)
    ap.add_argument("--dp-plan", action="store_true",
                    help="plan slice lengths with the paper's DP (Alg. 1); --mode terapipe")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--schedule", default="contiguous", choices=list(schedule_names()),
                    help="pipeline schedule of --mode terapipe/gpipe (core/schedules "
                    "registry): " + schedule_help())
    ap.add_argument("--virtual-stages", type=int, default=1,
                    help="V: layer chunks per rank (interleaved schedules; V > 1 with "
                    "contiguous means interleaved)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="attention through the hand-written CUDA kernels")
    ap.add_argument("--unroll", action="store_true",
                    help="accepted for the reference's CLI: the port's tick loop is eager "
                    "Python either way (rolled vs unrolled is a JAX tracing choice)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-failure-at", type=int, default=-1,
                    help="raise a fault once, after this step's train_step has returned; "
                    "the step's result is thrown away (the fault-tolerance test)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        check_virtual_stages(_promoted_schedule(args), args.virtual_stages)
    except ValueError as e:
        ap.error(str(e))
    if args.dp_plan and args.mode != "terapipe":
        ap.error("--dp-plan plans token slices: it needs --mode terapipe")

    if groups is not None:               # ranks hosted by the caller (one per thread)
        world = groups.get("world") or groups["pipe"]
        try:
            check_processes(args, world.size)
            mesh = launch_mesh(world.size)
        except ValueError as e:
            ap.error(str(e))
        device = args.device
    else:
        try:
            mesh, groups, device = _start_processes(args)
        except ValueError as e:
            ap.error(str(e))
        world = groups["world"] if groups else None
    lead = world is None or world.rank == 0
    say = print if lead else (lambda *a, **k: None)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.use_kernel:
        cfg = cfg.replace(use_kernel=True)
    if cfg.family == "moe":          # a routing group is moe_block tokens
        args.seq = max(args.seq, cfg.moe_block)
    model = build_model(cfg, device=device)
    dev = model.device
    vg_fn = build_value_and_grad(model, args, mesh, groups)
    # the whole parameters once: this process's shard of them is kept, the
    # rest dropped, and the moments are made on the shard alone
    full = tree_map(lambda p: p.requires_grad_(True), model.init(args.seed))
    plan = getattr(vg_fn, "plan", None)
    layout = plan.shard_layout(full) if plan is not None else None
    whole = meta_target(full)
    opt = adamw(cosine_schedule(args.lr, args.warmup, args.steps),
                sq_norm_reduce=world_sq_norm(layout, world) if layout is not None else None)
    state = {"params": shard_params(full, layout)}
    del full
    state["opt_state"] = opt.init(state["params"])
    data = make_data(cfg, args.batch, args.seq, args.seed)

    ckpt = CheckpointManager(args.checkpoint_dir, world=world) if args.checkpoint_dir else None
    # a checkpoint's tree carries the reference's keys; its target holds
    # the whole leaves' shapes (meta), its layout how the processes hold them
    tree = lambda step: {"params": state["params"], "opt": state["opt_state"], "step": step}
    target = {"params": whole, "opt": opt.init(whole), "step": 0}
    ck_layout = None if layout is None else {
        "params": layout, "opt": AdamWState(REPLICATED, layout, layout), "step": REPLICATED}

    def restore() -> int:
        state.clear()                  # the live state goes first: no second copy
        got = ckpt.restore(target=target, device=dev, layout=ck_layout)
        state["params"] = tree_map(lambda p: p.requires_grad_(True), got["params"])
        state["opt_state"] = got["opt"]
        if lead:
            _print_io(ckpt, f"restored step {int(got['step'])}")
        return int(got["step"])

    def faults_anywhere(mine: bool) -> int:
        """The count of ranks that faulted at this step (this one alone in
        one process)."""
        if world is None:
            return int(mine)
        flag = torch.tensor(int(mine), dtype=torch.int64, device=world.device)
        return int(world.all_reduce([flag])[0])

    step = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        step = restore()
        say(f"[resume] restored step {step}")
    rescue = ckpt is None and args.simulate_failure_at >= 0
    failed_once, faulted = False, set()
    loss = None
    t_last, tok_count, steps_since = time.time(), 0, 0
    while step < args.steps:
        held = (state["params"], state["opt_state"]) if rescue else None
        fault = None
        try:
            batch = {k: torch.from_numpy(a).to(dev) for k, a in data.batch_at(step).items()}
            step_loss = train_step(vg_fn, opt, state, batch)
            if args.simulate_failure_at == step and not failed_once:
                # after the step: the state already holds its result, as a
                # fault during a real step leaves it half replaced
                failed_once = True
                raise RuntimeError("injected fault (simulate-failure-at)")
        except Exception as e:  # noqa: BLE001 -- the supervisor: restore and continue
            fault = e
            print(f"[fault] step {step}" + ("" if world is None else f", rank {world.rank}")
                  + f": {e}", file=sys.stderr)
            if not str(e).startswith("injected fault"):
                traceback.print_exc()
        # every rank learns of a fault anywhere before the step counts
        if faults_anywhere(fault is not None):
            fault = fault or RuntimeError(f"step {step}: another rank faulted")
            if step in faulted:
                raise fault
            faulted.add(step)
            if ckpt and ckpt.latest_step() is not None:
                step = restore()
                say(f"[fault] restored checkpoint at step {step}")
                continue
            if ckpt:
                print("[fault] no checkpoint saved yet and the faulted step has replaced "
                      "the state; cannot retry", file=sys.stderr)
                raise fault
            if failed_once and held is not None:
                state["params"], state["opt_state"] = held
                say("[fault] no checkpoint dir; retrying step with rescue references")
                continue
            raise fault
        del held
        loss = step_loss
        tok_count += batch["tokens"].numel()
        steps_since += 1
        step += 1
        if step % args.log_every == 0:
            loss_f = float(loss)     # waits for the device
            dt = time.time() - t_last
            rec = {"step": step, "loss": loss_f, "tok_s": tok_count / dt,
                   "ms_per_step": dt / steps_since * 1e3}
            if history is not None:
                history.append(rec)
            say(f"step {step:5d} loss {loss_f:.6f} {rec['tok_s']:,.0f} tok/s "
                f"{rec['ms_per_step']:.1f} ms/step", flush=True)
            t_last, tok_count, steps_since = time.time(), 0, 0
        if ckpt and (step % args.checkpoint_every == 0 or step == args.steps):
            saved = ckpt.save(step, tree(step), layout=ck_layout)
            if lead:
                _print_io(ckpt, f"saved {saved}")
    if out is not None:
        out["state"] = tree(step)
        out["layout"] = ck_layout
        out["checkpoints"] = list(ckpt.log) if ckpt else []
    final = float(loss) if loss is not None else float("nan")
    n_params = sum(a.numel() for a in tree_leaves(whole))
    resident = sum(a.numel() * a.element_size() for a in jax_leaves(
        {"params": state["params"], "opt": state["opt_state"]}))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    gib = lambda xs: (f"{xs[0] / 2**30:.3f}" if len({f"{x / 2**30:.3f}" for x in xs}) == 1
                      else "(" + ", ".join(f"{x / 2**30:.3f}" for x in xs) + ")")
    where = f"{dev}, {resident / 2**30:.3f} GiB resident" + (
        "" if peak is None else f", peak {peak / 2**30:.2f} GiB")
    if mesh is not None:
        _check_ranks_agree(state["params"], layout, world)
        every = world.gather(torch.tensor([float(resident), float(peak or 0)], dtype=torch.float64,
                                          device=world.device or "cpu"), dst=0) or []
        every = [e.tolist() for e in every]
        where = (f"{mesh.size} processes on {mesh}, {dev.type}, resident state (params + AdamW) "
                 f"{mesh.size} x {gib([r for r, _ in every])} GiB" if every else "")
        if every and peak is not None:
            where += f", peaks {gib([p for _, p in every])} GiB"
    say(f"done: {args.steps} steps, final loss {final:.4f} "
        f"({cfg.name}, {n_params:,} parameters, {where}, mode {args.mode})")
    return final


def _print_io(ckpt: CheckpointManager, what: str) -> None:
    """The ``[ckpt]`` line of the manager's last save or restore: this
    process's share and the file's size (the same across processes in one
    process)."""
    rec = ckpt.log[-1]
    share = "" if ckpt.world is None else (
        f"this rank's share {rec['bytes'] / 2**30:.3f} GiB of ")
    print(f"[ckpt] {what} ({share}{rec['file_bytes'] / 2**30:.3f} GiB in {rec['seconds']:.2f} s, "
          f"{rec['file_bytes'] / rec['seconds'] / 1e9:.2f} GB/s)", flush=True)


if __name__ == "__main__":
    try:
        main()
    finally:
        if _distributed():
            torch.distributed.destroy_process_group()
