"""One run of one cell: set-up, the measured window, the traced steps, and
the comparison with the plain reference that decides ``correct``.

Set-up builds the program as ``repro_torch/launch/train.py::main`` does
(``build_model``, ``build_value_and_grad``, AdamW with the cosine
schedule; across processes its process start, ``shard_layout`` and
``shard_params``), hands it the benchmark's weights, and drives that one
object through the traffic's first ``checked_steps`` steps with
``launch.train.train_step`` on the benchmark's batches: those steps warm
up every shape the window uses, and their losses, the first gradient as
the optimizer took it (its first moment over ``1 - b1``) and the
parameters' change after them are the program's readings.  The window
then drives the same object step after step for ``--seconds``.  Once the
window (and with ``--trace 1`` the profiled steps) has closed and the
peak memory is read, the program is freed, the reference follows the
same steps from the same weights and batches, and each number compared
is printed beside its limit.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List

import torch

from perfbench import cells, inputs, trace
from perfbench.reference import train as reference

#: top-level module names that no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def quiet(*a) -> None:
    """The ``log`` of a rank that leaves reporting to rank 0."""


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def sq_sum(a: torch.Tensor) -> torch.Tensor:
    """The sum of squares of ``a`` in float64, a few million elements at a
    time (no second copy of a large leaf)."""
    flat = a.detach().reshape(-1)
    total = flat.new_zeros((), dtype=torch.float64)
    for i in range(0, flat.numel(), 1 << 24):
        c = flat[i:i + (1 << 24)].double()
        total += torch.dot(c, c)
    return total


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------
class Program:
    """The port's training step and its state, on ``device``; across
    processes ``dist`` holds the launcher's mesh, groups and world."""

    def __init__(self, cell: cells.Cell, seed: int, device, dist=None):
        from repro_torch.core.pipeline import shard_params
        from repro_torch.launch import train as launch
        from repro_torch.models import build_model
        from repro_torch.optim.adamw import adamw, cosine_schedule, world_sq_norm
        from repro_torch.tree import tree_items

        self.tree_items = tree_items
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        t = cell.traffic
        self.batch, self.seq = t["batch"], t["seq"]
        pcfg = cells.port_config(cell.config)
        model = build_model(pcfg, device=self.device)
        args = SimpleNamespace(mode=t["mode"], seq=t["seq"], batch=t["batch"],
                               token_slices=t.get("token_slices", 1),
                               microbatches=t.get("microbatches", 1),
                               schedule=t.get("schedule", "contiguous"),
                               virtual_stages=t.get("virtual_stages", 1), dp_plan=False)
        mesh, groups = (dist.mesh, dist.groups) if dist else (None, None)
        if t["mode"] != "gspmd":
            pipe = mesh.get("pipe") if mesh else launch.PIPE_RANKS
            if pipe != t["pipe_ranks"]:
                raise ValueError(f"the launcher runs {pipe} pipe ranks; {cell.name}'s traffic "
                                 f"states {t['pipe_ranks']}")
        self.world = groups["world"] if groups else None
        self.vg = launch.build_value_and_grad(model, args, mesh, groups)
        self.weights = inputs.Weights(cell.config, seed, self.device)
        flat = self.weights.all()
        self._check_layout(flat, pcfg)
        full = inputs.nest({p: a.requires_grad_(True) for p, a in flat.items()})
        del flat
        plan = getattr(self.vg, "plan", None)
        self.layout = plan.shard_layout(full) if plan is not None else None
        o = t["optimizer"]
        self.b1 = o["b1"]
        self.opt = adamw(cosine_schedule(o["lr"], o["warmup_steps"], o["total_steps"],
                                         o["min_ratio"]),
                         b1=o["b1"], b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"],
                         clip_norm=o["clip_norm"],
                         sq_norm_reduce=(world_sq_norm(self.layout, self.world)
                                         if self.layout is not None else None))
        self.state = {"params": shard_params(full, self.layout)}
        del full
        self.state["opt_state"] = self.opt.init(self.state["params"])
        self.model = model
        self.step_fn = launch.train_step

    def _check_layout(self, flat, pcfg) -> None:
        """The benchmark's weights must be the program's tree, leaf for leaf."""
        from repro_torch.models import build_model
        meta = build_model(pcfg, device=torch.device("meta")).init(0)
        theirs = [(p.lstrip("/"), tuple(a.shape)) for p, a in self.tree_items(meta)]
        ours = [(p, tuple(a.shape)) for p, a in flat.items()]
        if theirs != ours:
            raise ValueError(f"the program's parameter tree is not the benchmark's:\n"
                             f"program {theirs}\nbenchmark {ours}")

    def batch_at(self, step: int) -> dict:
        return inputs.make_batch(self.cell.config["vocab_size"], self.batch, self.seq,
                                 self.seed, step, self.device)

    def step(self, i: int, vg=None, opt=None) -> torch.Tensor:
        return self.step_fn(vg or self.vg, opt or self.opt, self.state, self.batch_at(i))

    # -- readings ----------------------------------------------------------
    def _leaf_blocks(self):
        """``(path, layout leaf or None)`` in the parameters' order."""
        paths = [p.lstrip("/") for p, _ in self.tree_items(self.state["params"])]
        if self.layout is None:
            return [(p, None) for p in paths]
        return list(zip(paths, (ls for _, ls in self.tree_items(self.layout))))

    def _norms(self, leaves) -> Dict[str, float]:
        """Each leaf's norm over the whole leaf: this process's owned blocks
        summed over the world.  ``leaves`` yields one tensor at a time."""
        blocks = self._leaf_blocks()
        sq = []
        for a, (_, ls) in zip(leaves, blocks):
            owned = ls is None or ls.owned
            sq.append(sq_sum(a) if owned else a.new_zeros((), dtype=torch.float64))
            del a
        sq = torch.stack(sq)
        if self.world is not None:
            torch.distributed.all_reduce(sq)
        return {p: math.sqrt(v) for (p, _), v in zip(blocks, sq.tolist())}

    def first_grad_norms(self) -> Dict[str, float]:
        """The first step's clipped gradient, as the optimizer's first moment
        holds it: ``m / (1 - b1)``."""
        m = self.state["opt_state"].m
        return self._norms(a / (1 - self.b1) for _, a in self.tree_items(m))

    def change_norms(self) -> Dict[str, float]:
        def diffs():
            params = (a for _, a in self.tree_items(self.state["params"]))
            for a, (path, ls) in zip(params, self._leaf_blocks()):
                start = self.weights.leaf(path)
                if ls is not None and not ls.mine.whole:
                    start = ls.mine.cut(start)
                yield a.detach() - start
        return self._norms(diffs())

    def free(self) -> None:
        for name in ("state", "vg", "opt", "model", "layout"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _window_over(mine: bool, dist, device, flags: List[torch.Tensor]) -> bool:
    """Whether to stop before the next step.  One process: its own clock.
    Across processes every rank must run the same steps, so each step's
    flag is summed over the world without waiting (into ``flags``), and
    every rank stops on the sum of the flags raised one step earlier."""
    if dist is None:
        return mine
    flag = torch.tensor([float(mine)], device=device)
    torch.distributed.all_reduce(flag)
    flags.append(flag)
    return len(flags) >= 2 and float(flags[-2]) > 0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _Traced:
    """The program's value-and-grad and optimizer, each call inside a span
    of the benchmark's, for the traced steps."""

    def __init__(self, program: Program):
        from torch.profiler import record_function
        vg, opt = program.vg, program.opt

        def value_and_grad(params, batch):
            with record_function(trace.SPAN_PREFIX + "value_and_grad"):
                return vg(params, batch)

        def update(grads, state, params):
            with record_function(trace.SPAN_PREFIX + "optimizer"):
                return opt.update(grads, state, params)

        self.vg = value_and_grad
        self.opt = SimpleNamespace(init=opt.init, update=update)


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------
def setup_and_window(cell: cells.Cell, seed: int, seconds: float, traced: bool, device,
                     dist=None, barrier=None, say=log) -> dict:
    """Set-up, the window and, with ``traced``, the profiled steps of one
    process, reporting progress through ``say``.  Returns the program's
    readings and measurements; the program is freed."""
    t = time.time()
    prog = Program(cell, seed, device, dist)
    say(f"[perfbench] program set up in {time.time() - t:.2f} s")
    losses, checked = [], cell.traffic["checked_steps"]
    for i in range(checked):
        t = time.time()
        losses.append(float(prog.step(i)))
        say(f"[perfbench] checked step {i + 1}: loss {losses[-1]!r}, {time.time() - t:.2f} s")
        if i == 0:
            first_grad = prog.first_grad_norms()
    change = prog.change_norms()
    # what set-up left behind is no garbage for the window's collections
    gc.collect()
    gc.freeze()
    _sync(device)
    if barrier:
        barrier()
    t_start = time.time()
    window_losses, n, flags = [], 0, []
    while not _window_over(time.time() - t_start >= seconds, dist, device, flags):
        window_losses.append(prog.step(checked + n).detach())
        n += 1
    _sync(device)
    t_end = time.time()
    say(f"[perfbench] window: {n} steps in {t_end - t_start:.3f} s")
    out = {"losses": losses, "first_grad": first_grad, "change": change,
           "window_start": t_start, "window_s": t_end - t_start, "steps": n,
           "nonfinite": int((~torch.isfinite(torch.stack(window_losses))).sum()),
           "tokens_per_step": prog.batch * prog.seq}
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function
        wrapped = _Traced(prog)
        k = cell.traffic["profiled_steps"]
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW_SPAN):
                for j in range(k):
                    with record_function(trace.SPAN_PREFIX + "step"):
                        prog.step(checked + n + j, wrapped.vg, wrapped.opt)
                _sync(device)
        t = time.time()
        out["trace"] = trace.summarize(prof, k)
        say(f"[perfbench] trace of {k} steps read in {time.time() - t:.2f} s")
        del prof
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if torch.device(device).type == "cuda" else 0)
    prog.free()
    return out


def gaps(program: dict, ref: dict) -> Dict[str, dict]:
    """The numbers compared, each with the leaf or step it was read at:
    ``loss_gap``, the largest gap of a step's loss (nats); ``grad_gap``,
    the largest gap of a leaf's norm of the first clipped gradient over
    the larger of the reference's norm of that leaf and of the median
    leaf; ``change_gap``, the same of the parameters' change, over the
    leaves whose reference gradient is at least a thousandth of the median
    leaf's."""
    out = {}
    lg = [abs(a - b) for a, b in zip(program["losses"], ref["loss"])]
    out["loss_gap"] = {"value": max(lg), "at": f"step {lg.index(max(lg)) + 1}"}
    rg = ref["grad_norm"]
    med_g = statistics.median(rg.values())
    counted = [p for p in rg if rg[p] >= 1e-3 * med_g]
    for key, mine, theirs, leaves in (("grad_gap", program["first_grad"], rg, list(rg)),
                                      ("change_gap", program["change"], ref["change_norm"],
                                       counted)):
        med = statistics.median(theirs[p] for p in leaves)
        per = {p: abs(mine[p] - theirs[p]) / max(theirs[p], med) for p in leaves}
        worst = max(per, key=lambda p: per[p])
        out[key] = {"value": per[worst], "at": worst}
    return out


def reference_readings(cell: cells.Cell, seed: int, device, **kw) -> dict:
    t = cell.traffic
    weights = inputs.Weights(cell.config, seed, device)
    batches = [inputs.make_batch(cell.config["vocab_size"], t["batch"], t["seq"], seed, i,
                                 device) for i in range(t["checked_steps"])]
    return reference.train_readings(cell.config, weights, batches, t["optimizer"],
                                    steps=t["checked_steps"],
                                    **cell.config["reference"], **kw)


def judge(program: dict, ref: dict, limits: dict) -> tuple:
    """``(correct, check)``: every number that ``limits`` holds against its
    limit, and the window's losses all finite.  A number the cell does not
    compare (it has no limit) is printed without one."""
    check = {}
    correct = program["nonfinite"] == 0
    for key, reading in gaps(program, ref).items():
        if key not in limits:
            log(f"[check] {key} {reading['value']!r} (at {reading['at']}) not compared")
            continue
        limit = limits[key]
        ok = math.isfinite(reading["value"]) and reading["value"] <= limit
        correct = correct and ok
        check[key] = {"value": reading["value"], "limit": limit}
        log(f"[check] {key} {reading['value']!r} (at {reading['at']}) limit {limit!r} "
            f"{'ok' if ok else 'FAILED'}")
    log(f"[check] non-finite window losses {program['nonfinite']} limit 0")
    check["nonfinite_losses"] = {"value": program["nonfinite"], "limit": 0}
    return correct, check


def per_layer_metrics(cell: cells.Cell, runs: List[dict], step_s: float) -> dict:
    ctx = {"cfg": cell.config, "traffic": cell.traffic, "chips": cell.chips,
           "step_s": step_s, "ranks": [r["trace"] for r in runs]}
    out = {}
    for m in cell.per_layer:
        value = cells.load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(runs: List[dict]) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, each averaged over the cards."""
    def top(key):
        acc: Dict[str, float] = {}
        for r in runs:
            for name, v in r["trace"][key].items():
                acc[name] = acc.get(name, 0.0) + (v[1] if isinstance(v, list) else v) / len(runs)
        return [[n[:160], s] for n, s in sorted(acc.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top("by_kernel"), "idle_gaps": top("idle_by_host")}


def result_line(cell: cells.Cell, runs: List[dict], t0: float, traced: bool,
                correct: bool, check: dict, device_kind: str) -> dict:
    """The run's last line from every process's measurements (``runs``,
    rank order)."""
    lead = runs[0]
    tokens = lead["steps"] * lead["tokens_per_step"]
    step_s = lead["window_s"] / lead["steps"]
    peak = max(r["peak_bytes"] for r in runs)
    values = {"tok_s": tokens / lead["window_s"], "tok_s_4card": tokens / lead["window_s"],
              "peak_gib": peak / 2**30, "setup_s": lead["window_start"] - t0}
    device = {"platform": "cpu" if device_kind == "cpu" else "gpu", "kind": device_kind,
              "count": cell.chips,
              "memory_peak_bytes": peak}
    line = {"correct": bool(correct), "attempted": len(lead["losses"]) + lead["steps"],
            "failed": lead["nonfinite"]}
    if traced:
        line["metrics"] = per_layer_metrics(cell, runs, step_s)
        device["busy_s"] = statistics.fmean(r["trace"]["busy_s"] for r in runs)
        device["window_s"] = statistics.fmean(r["trace"]["window_s"] for r in runs)
    else:
        line["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                           for m in cell.end_to_end}
    line["device"] = device
    if traced:
        line["breakdown"] = breakdown(runs)
    line["check"] = check
    return line


def finish(line: dict) -> int:
    """Prints the last line unless the process holds a forbidden module."""
    bad = forbidden_modules()
    if bad:
        log(f"[perfbench] the process holds forbidden modules: {bad}; no result")
        return 4
    log("[perfbench] " + "; ".join(f"{k} {v['value']!r} limit {v['limit']!r}"
                                   for k, v in line["check"].items()))
    print(json.dumps(line), flush=True)
    return 0


def run_one_process(cell: cells.Cell, seed: int, seconds: float, traced: bool, t0: float,
                    device="cuda") -> int:
    measured = setup_and_window(cell, seed, seconds, traced, device)
    t = time.time()
    ref = reference_readings(cell, seed, device)
    log(f"[perfbench] reference: {time.time() - t:.2f} s")
    correct, check = judge(measured, ref, cell.limits)
    return finish(result_line(cell, [measured], t0, traced, correct, check,
                              _device_kind(device)))


def _device_kind(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def run_rank(cell: cells.Cell, seed: int, seconds: float, traced: bool, t0: float,
             run_dir: Path, device="cuda") -> int:
    """One rank of a multi-card cell under ``torch.distributed.run``: the
    launcher's process start (NCCL on ``cuda:LOCAL_RANK``; gloo with
    ``device`` cpu), this rank's set-up, window and trace; its
    measurements go to ``run_dir``; rank 0 gathers them, runs the
    reference and prints the line."""
    from repro_torch.launch import train as launch
    mesh, groups, device = launch._start_processes(SimpleNamespace(mode=cell.traffic["mode"],
                                                                   device=device))
    world = groups["world"]
    dist = SimpleNamespace(mesh=mesh, groups=groups)
    measured = setup_and_window(cell, seed, seconds, traced, device, dist, world.barrier,
                                log if world.rank == 0 else quiet)
    (run_dir / f"rank{world.rank}.json").write_text(json.dumps(measured))
    world.barrier()
    torch.distributed.destroy_process_group()
    if world.rank != 0:
        return 0
    runs = [json.loads((run_dir / f"rank{r}.json").read_text()) for r in range(world.size)]
    t = time.time()
    ref = reference_readings(cell, seed, device)
    log(f"[perfbench] reference: {time.time() - t:.2f} s")
    correct, check = judge(runs[0], ref, cell.limits)
    return finish(result_line(cell, runs, t0, traced, correct, check, _device_kind(device)))
