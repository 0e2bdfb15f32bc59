"""Training launcher (reference: ``repro/launch/train.py``), single-device path.

    python -m repro_torch.launch.train --arch gpt3-1b --use-kernel \\
        --steps 5 --batch 4 --seq 2048
    python -m repro_torch.launch.train --arch gpt3-1b --smoke --device cpu \\
        --steps 3 --batch 2 --seq 32

Each step is the reference's ``gspmd`` step on one device: ``model.loss``
on a synthetic batch, ``loss.backward()``, AdamW with a cosine schedule,
then ``apply_updates``, all on ``--device`` (``cuda`` unless the caller asks
for ``cpu``; without a GPU the default raises).  ``--use-kernel`` routes
attention through the hand-written CUDA kernels, forward and backward.

The TeraPipe/GPipe executors, the DP slice planner, the other schedules
and the checkpoint/supervisor loop are not ported yet: their flags raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports them,
where the reference would quietly run ``model.loss`` on one device.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataPipeline, SyntheticSource
from repro_torch.models import build_model
from repro_torch.optim.adamw import adamw, apply_updates, cosine_schedule
from repro_torch.tree import tree_leaves, tree_map

# flag -> (value that means "not asked for", ROADMAP Queue 1 item that ports it)
_UNPORTED = {
    "dp_plan": (False, "item 3 (planning layer)"),
    "schedule": (None, "items 3 and 6 (schedule IR, the other schedules)"),
    "virtual_stages": (1, "item 6 (interleaved schedules)"),
    "unroll": (False, "item 4 (pipeline executor)"),
    "checkpoint_dir": (None, "item 5 (checkpoint/manager.py and the supervisor)"),
    "resume": (False, "item 5 (checkpoint/manager.py and the supervisor)"),
    "simulate_failure_at": (-1, "item 5 (checkpoint/manager.py and the supervisor)"),
}


def _check_ported(args) -> None:
    if args.mode != "gspmd":
        raise NotImplementedError(
            f"--mode {args.mode}: not yet ported (ROADMAP Queue 1 item 4, the "
            f"pipeline executor); the port runs the single-device gspmd step")
    for name, (default, item) in _UNPORTED.items():
        if getattr(args, name) != default:
            flag = "--" + name.replace("_", "-")
            raise NotImplementedError(f"{flag}: not yet ported (ROADMAP Queue 1 {item})")


def train_step(model, opt, state: dict, batch) -> torch.Tensor:
    """One step: ``model.loss`` on ``batch``, its backward, and the AdamW
    update of ``state["params"]`` and ``state["opt_state"]``, rebound in
    the dict; returns the loss, detached."""
    loss = model.loss(state["params"], batch)
    loss.backward()
    # rebinding as soon as each value is replaced keeps one copy of the
    # moments and of the gradients alive at a time
    updates, state["opt_state"] = opt.update(tree_map(lambda p: p.grad, state["params"]),
                                             state["opt_state"], state["params"])
    for p in tree_leaves(state["params"]):
        p.grad = None
    state["params"] = tree_map(lambda p: p.requires_grad_(True),
                               apply_updates(state["params"], updates))
    return loss.detach()


def main(argv=None, history: Optional[list] = None) -> float:
    """Runs the training loop and returns the final loss.  If ``history``
    is a list, each logged step appends ``{"step", "loss", "tok_s",
    "ms_per_step"}`` to it, the numbers its printed line shows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--mode", default="gspmd", choices=["gspmd", "terapipe", "gpipe"])
    ap.add_argument("--dp-plan", action="store_true", help="not yet ported")
    ap.add_argument("--schedule", default=None, help="not yet ported")
    ap.add_argument("--virtual-stages", type=int, default=1, help="not yet ported")
    ap.add_argument("--use-kernel", action="store_true",
                    help="attention through the hand-written CUDA kernels")
    ap.add_argument("--unroll", action="store_true", help="not yet ported")
    ap.add_argument("--checkpoint-dir", default=None, help="not yet ported")
    ap.add_argument("--resume", action="store_true", help="not yet ported")
    ap.add_argument("--simulate-failure-at", type=int, default=-1, help="not yet ported")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _check_ported(args)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.use_kernel:
        cfg = cfg.replace(use_kernel=True)
    model = build_model(cfg, device=args.device)
    dev = model.device
    opt = adamw(cosine_schedule(args.lr, args.warmup, args.steps))
    state = {"params": tree_map(lambda p: p.requires_grad_(True), model.init(args.seed))}
    state["opt_state"] = opt.init(state["params"])
    data = DataPipeline(SyntheticSource(cfg.vocab_size, args.seed), args.batch, args.seq)

    step, loss = 0, None
    t_last, tok_count, steps_since = time.time(), 0, 0
    while step < args.steps:
        batch = {k: torch.from_numpy(a).to(dev) for k, a in data.batch_at(step).items()}
        loss = train_step(model, opt, state, batch)
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
            print(f"step {step:5d} loss {loss_f:.4f} {rec['tok_s']:,.0f} tok/s "
                  f"{rec['ms_per_step']:.1f} ms/step", flush=True)
            t_last, tok_count, steps_since = time.time(), 0, 0
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"done: {args.steps} steps, final loss {float(loss):.4f} "
          f"({cfg.name}, {n_params:,} parameters, {dev})")
    return float(loss)


if __name__ == "__main__":
    main()
