"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line):
  1. build   — compile every CUDA kernel (forward, backward, decode) from
               src/repro_torch/kernels/csrc with nvcc (sm_90a), one nvcc per
               source, all at once; print each instance's registers and
               spills (-Xptxas -v) and its HGMMA (wgmma), HMMA (mma.sync)
               and UTMALDG (TMA load) counts (cuobjdump -sass); every bf16
               instance of fwd_kernel_bf16, dq_kernel_bf16 and
               dkv_kernel_bf16 (six head dims) must run wgmma fed by TMA and
               no mma.sync, no bf16 SIMT instance of them may remain, and
               the hd-128 ones (the main paths') must not spill; decode is
               one kernel (decode_kernel, one launch over a thread-block
               cluster) whose every instance loads by TMA: its registers
               and spills at hd 128, and no other decode kernel remains;
  2. kernels — hold each kernel against its plain PyTorch version on the
               card, bf16 (atol/rtol 2e-2) and f32 (2e-5; with logits x30,
               1e-4 for the forward and 3e-3 for the backward): prefill O
               and lse, decode O (lengths at the decode cluster's split
               edges 0, 1, C-1, C, BOX*C-1, BOX*C+1 and L, per-batch mixes,
               GQA rep 1-16, two query-head groups),
               and the backward's dQ, dK and dV (with exactly zero dK/dV on
               every stale cache tail), on a grid of serving shapes (every
               head dim 16-160, an 8-token chunk at ctx 250) and at the
               training step's own shape (B 4, l 2048, Hq = Hkv = 16, hd
               128); two launches of the forward, decode, dQ and dK/dV must
               agree bit for bit; the pipelined step's slices (B 4, l 256 at ctx 256 and
               1792, Sk = ctx + l); qwen3-moe's GQA ratio of 16 (Hq 64 /
               Hkv 4: the forward at B 2, l 1024; dQ and dK/dV at B 1, l 256,
               ctx 256; decode at L 2048 with per-row kv_len); phase 8b's
               training shapes (B 4, l 2048, Hq = Hkv = 32, hd 96: phi-3-vision;
               Hq = Hkv = 16, hd 64: whisper's decoder) and decodes (B 2, L
               2112, kv_len 2049, 32 heads of 96; B 2, L 448, kv_len 65, 16 of
               64); the autograd Function against autograd of the plain op;
               a bf16 row stride that is not a multiple of 8 is refused;
  3. serve   — qwen3-0.6b at full width (28 layers, random weights from a
               seeded generator, bf16, use_kernel=True) behind the
               continuous-batching DecodeEngine: 8 requests, once with one
               prefill chunk per prompt and once with SLO-split chunks;
               launch counts must equal (prefill chunks x 28) and
               (decode rounds x 28); continuous batching must reproduce the
               sequential engine's tokens;
  4. train   — gpt3-1b at full width (24 layers, d 2048, bf16, random
               weights): the loss and every gradient through the kernels
               against the plain attention path at batch 1 x seq 2048, then
               5 AdamW steps at batch 4 x seq 2048 through
               repro_torch.launch.train.main --use-kernel; losses finite
               and within 1 of ln(vocab); launches must equal the remat
               formula (2 forward, 1 dQ, 1 dK/dV per layer per step);
  5. pipeline — the token-slice pipeline (core/pipeline.py, K = 4 virtual
               ranks) on gpt3-1b at full width, after the gspmd run's state
               is freed: one stage's (6 blocks) forward at batch 4, ctx 0,
               over l = 32..2048 (the paper's Fig. 3), with the H100 spec's
               efficiency and occupancy floor fitted to its CUDA-graph
               times; the pipelined loss and gradients through the kernels
               against the plain paths at batch 1 x seq 2048, within the
               bounds of phase 4, under contiguous (M 8, and fixed
               non-uniform slices), 1f1b, zb-h1, interleaved (V 2) and
               interleaved-1f1b (V 2), M 8; 3 steps of launch.train.main
               --mode terapipe --use-kernel --token-slices 8 under each of
               those five schedules, then 3 with --dp-plan, at batch 4 x seq
               2048, each with its ms/step, peak allocated memory and exact
               launch counts (_launches_per_step); 1F1B's memory flat in D:
               one step at microbatch 1 x seq 2048, M 8, D 2 and D 4, whose
               peak allocated memory above the pre-step baseline must agree
               within 10% (the residual store's peak is
               peak_live_items = min(D*M, K+M-1) = 11 at both), beside
               contiguous at the same D; the kernel cost table
               (measure_kernel_cost_table: the forward kernel, and dQ +
               dK/dV on one saved forward) at a few (l, ctx), measured
               twice: every bwd/fwd ratio in [2, 6], and the l 256, ctx 0
               backward entry within 25% across the two;
  6. restart — gpt3-1b at full width (full depth when the disk holds two
               checkpoints of its 20.3 GiB state, else fewer layers, said in
               the line), batch 4 x seq 2048, --use-kernel, through
               repro_torch.launch.train.main: (a) 6 uninterrupted gspmd steps,
               twice (does the run repeat bit for bit?); (b) the same with
               --checkpoint-dir, --checkpoint-every 3 and
               --simulate-failure-at 4: restores step 3 and ends bit-equal
               to (a), every leaf of params, m, v and step compared on the
               host (within 4x the run-to-run spread if (a) does not
               repeat); (c) --resume from (b)'s step-3 checkpoint under
               --mode terapipe --schedule 1f1b, M 8, steps 4-6 within 1e-3
               relative of (a)'s losses; launches exact per step run, the
               seconds and GB/s of each save and restore; the checkpoints
               are deleted at the end.  Then the audit (analysis.audit): one
               full-width pipelined step, M 8, kernels, under contiguous as
               trained, contiguous with remat off at batch 1 (so that the
               blocks' saved tensors reach the hooks) and 1f1b:
               comm.ring-match and buffer.score-matrix clean, the saved
               bytes and the dtype census printed; one [checkpoint] and one
               [audit] line with the card's name and power limit;
  7. moe     — the MoE family at full width.  deepseek-moe-16b (d 2048,
               16/16 heads, 64 experts top-6 of width 1408, 2 shared, dense0
               of width 11264, vocab 102400) cut to 3 of 28 layers (dense0 +
               2 MoE), random weights: the loss and gradients through the
               kernels against the plain paths at batch 1 x seq 2048 (phase
               4's bounds) under gspmd, contiguous and 1f1b (K 4, M 8; two
               ranks hold pad rows only) and slices (384, 256, 128, 640,
               640), with each bf16 path's routing drops and the (token,
               choice) assignments it changes against the f32 path; two
               gspmd calls at batch 4 x seq 2048 bit-equal; 5 gspmd steps and
               3 pipelined steps (M 8, dense0 as the pre-group) under
               contiguous and 1f1b through launch.train.main --use-kernel at
               batch 4 x seq 2048, with ms/step, peak memory above the
               baseline, exact launches and the routing drops per step.
               Then qwen3-moe-235b-a22b (d 4096, 64/4 heads, 128 experts
               top-8 of width 1536, vocab 151936) cut to 2 of 94 layers:
               Model.prefill of 2 x 1024 tokens and 16 greedy decode_steps
               through the kernels against the plain path (logits of every
               row routed alike within 5e-2; greedy tokens);
  8. state   — the state-carrying families at full width; neither reaches
               the kernels (mamba2 has no attention, recurrentgemma's is
               windowed and takes the plain route), so every launch count of
               their runs must stay 0.  mamba2-2.7b (d 2560, d_inner 5120, 80
               SSD heads of 64, state 128, conv 4, chunk 256, vocab 50280)
               cut to 40 of 64 layers: the loss and gradients in bf16 against
               f32 at batch 1 x seq 2048 (phase 4's bounds) under gspmd and
               the pipelined step (K 4, M 8) with contiguous and interleaved
               (V 2); two gspmd calls at batch 4 x seq 2048 bit-equal; 5 gspmd
               steps and 3 contiguous steps through launch.train.main at batch
               4 x seq 2048 with ms/step, tok/s and peak memory.  Then
               recurrentgemma-9b (d 4096, 16 query heads and 1 KV head of 256,
               d_ff 12288, vocab 256000, window 2048) cut to 14 of 38 layers
               (4 super-blocks and the 2-block tail, a post-group of the
               pipeline): the same parity at batch 1 x seq 4096 under gspmd
               and contiguous (K 4, M 8); one timed value-and-grad call of
               each at batch 2 x seq 4096 with its peak; Model.prefill of 2 x
               3072 tokens into 3200 rows, then 64 greedy decode_steps through
               the windowed ring, every logit row within 5e-2 of Model.forward
               of the same tokens;
 8b. families — the vlm and enc-dec families at full width.  phi-3-vision-
               4.2b (d 3072, 32 heads of 96, d_ff 8192, vocab 32064, 576 patch
               rows) cut to 12 of 32 layers: the loss and gradients through
               the kernels against the plain paths at batch 1 x seq 2048 (576
               patches + 1472 text tokens; phase 4's bounds) under gspmd,
               contiguous (K 4, M 8) and slices (256, 256, 328, 504, 704),
               whose first two hold only patch rows; 5 gspmd and 3 contiguous
               steps through launch.train.main --use-kernel at batch 4 x seq
               2048, launches exact per step; Model.prefill of 2 x (576 +
               1472) into 2112 rows and 16 greedy decode_steps against the
               plain path (5e-2); remat_policy "dots" against "full" on the
               gspmd value-and-grad at batch 1: loss and gradients bit-equal,
               ms and peak memory of both.  whisper-medium (d 1024, 16 heads
               of 64, d_ff 4096, vocab 51865) at full depth, 24 encoder + 24
               decoder layers: parity under gspmd at batch 1 x 2048 frames
               and tokens, 5 gspmd steps at batch 4, --mode terapipe refused
               (the encoder cannot be token-sliced), prefill of 2 x 1500
               frames and 2 x 64 tokens into 448 rows and 32 decode steps
               against the plain path; only the decoder's self-attention
               launches the kernels (the encoder's bidirectional attention
               and the cross-attention take the plain route, as in the
               reference), every count exact;
 8c. layout  — the layout layer (launch/steps.py, the configs' SHAPES,
               skip_reason and input_specs, distributed/collectives.py):
               abstract_init, abstract_opt_state, every (arch x shape)
               cell's skip_reason or input_specs and abstract_caches at the
               decode cells for all 14 FULL configs from models built on
               the card, memory_allocated unchanged to the byte and the
               parameter counts the reference's; 3 steps of make_train_step
               on gpt3-1b (batch 4 x seq 2048, kernels) bit-equal in loss to
               launch.train.train_step's from the same seed and batches, run
               one after the other, launches exactly 48 / 24 / 24 per step;
               qwen3-0.6b make_prefill_step of 2 x 1024 tokens into 2048
               rows and 16 greedy make_decode_step calls (caches as
               abstract_caches says, launches 28 and 16 x 28, logits within
               5e-2 of the plain path); 3 rounds of int8 compression with
               error feedback over one gpt3-1b step's gradients (1.817 B
               f32), four leaves' q, scales and residuals bit-equal to the
               host's, the accumulated sent gradient within each leaf's
               largest residual of the true one, the bf16 round trip; then
               examples/serve_decode_torch.py on the card, launches exact;
 8d. parallel — the parallel layer (launch/mesh.py, distributed/sharding.py,
               the executor on a mesh, distributed/transport.py): gpt3-1b at
               full width on data 2 x pipe 2 x tp 2 (8 virtual ranks, 8 of
               16 heads per tp rank) against the same step on pipe 4 and
               the plain paths (batch 2 x seq 2048, contiguous M 8, within
               phase 4's bounds), then 3 launch.train steps of each at batch
               4 x seq 2048, launches exactly 1536 / 768 / 768 per step on
               the mesh (384 / 192 / 192 on pipe 4); deepseek-moe-16b, 3
               layers, on pipe 2 x tp 2 (32 of 64 routed experts per rank)
               against pipe 2 in bf16 within the bounds, and the whole
               model in f32: the routing at tp 2 changes a token's choices
               only at a near-tie of its pipe-2 gates (top-k gap at most
               twice its gates' change) and keep bits only in groups with
               such a change; CPU processes under gloo, one per rank
               (GLOO_CASES: SMOKE f32, two processes, and four for pipe 2 x
               tp 2, spawned at once): gpt3 on pipe 2 (DistRing) under
               1f1b, contiguous, gpipe D 2 and interleaved V 2, tp 2 and
               data 2 (DistGroup), pipe 2 x tp 2, and recurrentgemma on
               pipe 2 (its post-group tail on the last rank), each rank's
               loss and every gradient bit-equal to the in-process
               LocalRing/LocalGroup run (the forward-only schedules across
               processes: within 2e-6 of each leaf's largest magnitude
               where not, those leaves named), a process whose ring hosts
               one rank holding and returning only its blocks; then the
               launcher under torchrun on four CPU processes (gloo,
               Mesh(data=1, pipe=4)) beside one process, 4 steps with a
               checkpoint every 2, the printed losses within 1e-6, and at
               the same time four processes with a fault at step 3, every
               rank restored at step 2, its final checkpoint bit-equal to
               the run's without the fault; then --resume from the four
               processes' step 2 on two processes and on one, final
               checkpoints within 2e-6 of the four processes';
 8e. dryrun  — launch/dryrun.py's prediction on the meta device, no step on
               the card: gpt3-1b's make_train_step at batch 4 x seq 2048
               with kernels (as phase 8c ran it) and the contiguous M 8
               step on pipe 4 through launch.train.train_step (as phase 8d
               ran it), each traced once; its kernel calls equal to the
               card's launches per step, its FLOPs equal to
               FlopCounterMode's count of one card step plus the kernels'
               FLOPs by ops.attention_flops for the card's calls, its peak
               above the state within DRYRUN_PEAK_BOUND of the card's
               max_memory_allocated, nothing allocated on the card; the
               peak's breakdown by category printed;
 8f. rank per process — gpt3-1b at full width, batch 4 x seq 2048,
               kernels, Mesh(pipe=4), with one pipe rank per thread
               (distributed.transport.ThreadRing: four threads on the one
               card, the path of one rank per process: the forward-only
               schedules' transposed tick table) against the in-process
               LocalRing run, one value-and-grad each, under contiguous M 8
               and gpipe D 2: every rank's loss and gradient leaves
               bit-equal (or within 2e-6 of each leaf's largest magnitude,
               the leaves named), each rank holding only its shard of the
               parameters (its stage's rows; embedding, head and final
               norm whole) and returning its blocks' gradients, launches
               exactly 384 / 192 / 192 and 96 / 48 / 48 in each run, ms and
               the peak above the state of each; at contiguous M 8 each
               rank's resident parameters, AdamW moments and batch equal to
               the dry run's per-device state_bytes to the byte, then an
               AdamW step on the four shards (the clip norm summed over
               the ranks, one value on every rank, within 1e-6 of the
               in-process gradient's), a save from the four ranks
               (gathered on rank 0 into the reference's one proc0.npz,
               20.3 GiB) and a restore into one process on the card, every
               leaf holding each rank's blocks bit for bit, the save's and
               restore's GB/s;
  9. times   — each kernel at a main-path shape (CUDA events, median of 30
               after warm-up, L2 flushed before each launch) beside its
               bound, its plain version and one PyTorch library call; the
               forward also at the training shape (train_ms, train_bound_ms,
               train_library_ms); the forward, dQ and dK/dV also at the
               pipelined step's last slice (B 4, l 256, ctx 1792: each
               row's slice_shapes) and every kernel at phase 8b's shapes
               (family_shapes); the tile walk of the forward and dK/dV
               kernels at the training shape (kernels/tile_walk.py);
 10. profiles — one pipelined 1f1b step (M 8) of gpt3-1b and one gspmd
               step each of mamba2-2.7b (40 layers) and whisper-medium (with
               the share of its device time in the encoder's and the
               cross-attention's plain attention cores), the paths no cell
               of perfbench/ traces, under torch.profiler: the 15 device
               kernels that took the most
               time and the repo's own kernels wherever they rank, with
               their share of the step, the device's busy share, and the
               host operators that took the most time.  Last, because a
               profiled region slows the process's later eager launches.

The line before last is one JSON object {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Needs one CUDA GPU and nvcc.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import re
import resource
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.analysis import audit, errors  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, meta_target  # noqa: E402
from repro_torch.configs import (ARCHS, PAPER_ARCHS, SHAPES, ShapeSpec,  # noqa: E402
                                 get_config, input_specs, skip_reason)
from repro_torch.core.cost_model import (H100, AnalyticCostModel,  # noqa: E402
                                         fit_efficiency_and_floor,
                                         measure_kernel_cost_table)
from repro_torch.core.pipeline import (TeraPipeConfig, make_terapipe_loss,  # noqa: E402
                                       make_terapipe_value_and_grad, shard_params,
                                       value_and_grad)
from repro_torch.core.schedules import REGISTRY, get_schedule  # noqa: E402
from repro_torch.data.pipeline import DataPipeline, SyntheticSource  # noqa: E402
from repro_torch.distributed import transport  # noqa: E402
from repro_torch.distributed.sharding import REPLICATED, Block  # noqa: E402
from repro_torch.distributed.collectives import (bf16_compress,  # noqa: E402
                                                 bf16_decompress, int8_ef_compress,
                                                 int8_ef_decompress, int8_ef_init)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_kernel  # noqa: E402
from repro_torch.kernels import ops, tile_walk  # noqa: E402
from repro_torch.kernels.ref import (decode_attention_ref,  # noqa: E402
                                     terapipe_attention_bwd_ref,
                                     terapipe_attention_dkv_ref,
                                     terapipe_attention_dq_ref, terapipe_attention_ref)
from repro_torch.kernels.terapipe_attention import (HEAD_DIMS,  # noqa: E402
                                                     terapipe_attention_fwd)
from repro_torch.kernels.terapipe_attention_bwd import (  # noqa: E402
    terapipe_attention_bwd, terapipe_attention_dkv, terapipe_attention_dq)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.steps import (abstract_caches, abstract_init,  # noqa: E402
                                     abstract_opt_state, make_decode_step,
                                     make_prefill_step, make_train_step)
from repro_torch.models import attention, build_model, lm, moe  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.optim.adamw import (AdamWState, adamw, apply_updates,  # noqa: E402
                                     cosine_schedule, global_norm, world_sq_norm)
from repro_torch.serve import DecodeEngine, EngineConfig  # noqa: E402
from repro_torch.timing import bound_ms, time_ms  # noqa: E402
from repro_torch.tree import (jax_items, jax_leaves, tree_items, tree_leaves,  # noqa: E402
                              tree_map)

TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# f32 with logits scaled x30: rounding of |logits| ~ 100 shows in the
# probabilities; the reference holds that case at 1e-4
# (tests/test_kernels.py::test_kernel_softmax_stability)
TOL_F32_X30 = 1e-4
N_LAYERS = 28                  # qwen3-0.6b
COUNTERS = {"terapipe_attention_fwd": terapipe_attention_fwd,
            "decode_attention": decode_attention_kernel,
            "terapipe_attention_dq": terapipe_attention_dq,
            "terapipe_attention_dkv": terapipe_attention_dkv}


#: the card's steps that phase 8e predicts: per run, the launches of its
#: steps, their number, the peak above the state (bytes) and one step's FLOPs
CARD_STEPS: Dict[str, dict] = {}


@contextlib.contextmanager
def _card_flops():
    """FlopCounterMode over a block on the card, plus each attention
    kernel call's FLOPs by ops.attention_flops (the kernels run outside
    the dispatcher, so the mode does not see them).  Yields a dict whose
    "flops" is set when the block ends."""
    out = {"kernel_flops": 0}
    fwd, bwd = ops.terapipe_attention_fwd, ops.terapipe_attention_bwd

    def fwd_counted(q, k, v, ctx):
        out["kernel_flops"] += ops.attention_flops(q, ctx)["terapipe_attention_fwd"]
        return fwd(q, k, v, ctx)

    def bwd_counted(q, k, v, do, lse, delta, ctx):
        f = ops.attention_flops(q, ctx)
        out["kernel_flops"] += f["terapipe_attention_dq"] + f["terapipe_attention_dkv"]
        return bwd(q, k, v, do, lse, delta, ctx)

    ops.terapipe_attention_fwd, ops.terapipe_attention_bwd = fwd_counted, bwd_counted
    try:
        with FlopCounterMode(display=False) as fc:
            yield out
    finally:
        ops.terapipe_attention_fwd, ops.terapipe_attention_bwd = fwd, bwd
    out["matmul_flops"] = fc.get_total_flops()
    out["flops"] = out["matmul_flops"] + out["kernel_flops"]


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------- 1. build
# the tensor-core kernels: the forward, dQ and dK/dV as wgmma fed by TMA
# (HGMMA, UTMALDG, no HMMA)
WGMMA_KERNELS = ("fwd_kernel_bf16", "dq_kernel_bf16", "dkv_kernel_bf16")
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG")
# decode: one kernel, decode_kernel<dtype, hd, R> (R query heads per cluster:
# the least power of two that holds the GQA group, 8 past that), loading its
# boxes by TMA (UTMALDG)
DECODE_KERNELS = ("decode_kernel",)
DECODE_ROWS = (1, 2, 4, 8)
MAIN_PATH_HD = 128          # gpt3-1b and qwen3-0.6b: these instances must not spill


def _kernel_label(mangled: str) -> str:
    """'fwd_kernel_bf16<128>' or 'decode_kernel<bf16,128,2>' from an
    Itanium-mangled kernel name: its template arguments, types as bf16 or
    f32, integers as they are."""
    m = re.search(r"\d+((?:fwd|dq|dkv|decode)\w*?)I", mangled)
    if not m:
        return mangled
    rest, args = mangled[m.end():], []
    while True:
        t = re.match(r"Li(\d+)E|13__nv_bfloat16|f", rest)
        if not t:
            break
        args.append(t.group(1) or ("f32" if t.group(0) == "f" else "bf16"))
        rest = rest[t.end():]
    return f"{m.group(1)}<{','.join(args)}>"


def _ptxas_report(log_text: str) -> dict:
    """label -> {"regs", "spill_stores", "spill_loads"} from an -Xptxas -v log."""
    out, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            fn = _kernel_label(m.group(1))
            out.setdefault(fn, {})
        elif fn and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[fn].update(spill_stores=int(st), spill_loads=int(ld))
        elif fn and "Used" in line and "registers" in line:
            out[fn]["regs"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def _sass_counts(lib: Path) -> dict:
    """label -> {op: count} of the SASS_OPS, from cuobjdump -sass."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = _kernel_label(m.group(1))
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn:
            m = re.search(r"\b(HGMMA|HMMA|UTMALDG)\b", line)
            if m:
                counts[fn][m.group(1)] += 1
    return counts


def phase_build() -> None:
    """Builds every source; prints each kernel instance's registers, spills
    and its HGMMA / HMMA / UTMALDG counts; asserts that every bf16 instance
    of the forward, dQ and dK/dV kernels runs wgmma fed by TMA and no
    mma.sync, that no bf16 SIMT instance of them remains, that the main
    path's hd-128 instances do not spill, and that decode is the one
    cluster kernel, every instance of it loading by TMA.  The
    warp-specialised kernels' registers are ptxas's entry count (the block's
    384 threads at 168); after setmaxnreg the consumers run at 240, the
    producer at 24, and the spills are the whole kernel's."""
    t0 = time.time()
    libs = _build.build_all()
    log(f"[build] {len(libs)} kernels built in {time.time() - t0:.1f} s")
    report, ops = {}, {}
    for name, path in libs.items():
        rep = _ptxas_report(Path(str(path) + ".log").read_text())
        counts = _sass_counts(path)
        for fn in sorted(set(rep) | set(counts)):
            r, c = rep.get(fn, {}), counts.get(fn, {})
            log(f"[build] {name} {fn}: {r.get('regs', '?')} registers, spill stores "
                f"{r.get('spill_stores', '?')} B, loads {r.get('spill_loads', '?')} B; "
                + ", ".join(f"{c.get(op, '?')} {op}" for op in SASS_OPS))
        report.update(rep)
        ops.update(counts)
    bad = [f"{k}<{hd}>: {ops.get(f'{k}<{hd}>')}" for k in WGMMA_KERNELS for hd in HEAD_DIMS
           if not (ops.get(f"{k}<{hd}>", {}).get("HGMMA") and ops[f"{k}<{hd}>"]["UTMALDG"]
                   and ops[f"{k}<{hd}>"]["HMMA"] == 0)]
    if bad:
        raise AssertionError(f"bf16 instances off their instruction mix: {bad}")
    simt_bf16 = [fn for fn in ops if fn.startswith(("fwd_kernel", "dq_kernel", "dkv_kernel"))
                 and "bf16" in fn and fn.split("<")[0] not in WGMMA_KERNELS]
    if simt_bf16:
        raise AssertionError(f"bf16 SIMT instances remain: {simt_bf16}")
    for kern in WGMMA_KERNELS:
        r = report[f"{kern}<{MAIN_PATH_HD}>"]
        if r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"{kern}<{MAIN_PATH_HD}>, on the main path, spills: {r}")
    log(f"[build] all {len(HEAD_DIMS)} head dims of {', '.join(WGMMA_KERNELS)} run HGMMA "
        f"fed by UTMALDG and no HMMA; no bf16 SIMT instance; hd {MAIN_PATH_HD} spills 0 bytes")
    decode = [fn for fn in ops if fn.startswith("decode")]
    others = sorted({fn.split("<")[0] for fn in decode} - set(DECODE_KERNELS))
    if others:
        raise AssertionError(f"decode kernels besides {DECODE_KERNELS} remain: {others}")
    want = [f"{k}<{dt},{hd},{r}>" for k in DECODE_KERNELS for dt in ("bf16", "f32")
            for hd in HEAD_DIMS for r in DECODE_ROWS]
    bad = [f"{fn}: {ops.get(fn)}" for fn in want
           if not ops.get(fn, {}).get("UTMALDG") or ops[fn]["HMMA"]]
    if bad or len(decode) != len(want):
        raise AssertionError(f"decode instances without a TMA load or with mma.sync, or not "
                             f"{len(want)}: {bad or sorted(decode)}")
    for kern in DECODE_KERNELS:
        for dt in ("bf16", "f32"):
            for r in DECODE_ROWS:
                fn = f"{kern}<{dt},{MAIN_PATH_HD},{r}>"
                log(f"[build] {fn} (decode, one launch over clusters of "
                    f"{tile_walk.DECODE_CLUSTER} CTAs, {r} query heads, "
                    f"{tile_walk.DECODE_BOX}-key TMA boxes): {report[fn]}, {ops[fn]}")
    log(f"[build] decode: {len(want)} instances of {', '.join(DECODE_KERNELS)}, each loading "
        f"by TMA (UTMALDG), none with mma.sync; no merge kernel")
    log(f"[card] {_card()}")


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


# ------------------------------------------------------------- 2. kernels
def _rand(shape, dtype, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _err(got, want, tol, what):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    diff = (got - want).abs()
    bad = diff > tol + tol * want.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements off, max abs err "
                             f"{diff.max().item():.3g} (tol {tol})")
    return diff.max().item()


TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 5, 4, 2048
PIPE_RANKS = train_launch.PIPE_RANKS      # virtual ranks of the pipelined step
# one layer's attention in the gpt3-1b training step (Hq = Hkv = 16, hd 128),
# as the main path calls it (Sk = l) and with a 37-key stale tail
TRAIN_CASES = [(TRAIN_BATCH, TRAIN_SEQ, 0, 16, 16, 128, 1.0, tail) for tail in (0, 37)]
PIPE_SLICES = 8                           # M of the pipelined step
# one layer's attention in the pipelined step (M 8): a 256-token slice at the
# second slice's ctx and at the last one's, over the cache rows [0, ctx + l)
PIPE_CASES = [(TRAIN_BATCH, TRAIN_SEQ // PIPE_SLICES, ctx, 16, 16, 128, 1.0, 0)
              for ctx in (TRAIN_SEQ // PIPE_SLICES, TRAIN_SEQ - TRAIN_SEQ // PIPE_SLICES)]
# the same slices on phase 8d's mesh: one data rank's 2 rows, one tp rank's
# 8 of the 16 heads
PAR_CASES = [(TRAIN_BATCH // 2, l, ctx, 8, 8, 128, 1.0, 0) for (_, l, ctx, *_) in PIPE_CASES]


# one layer's attention in the training steps of phase 8b's families:
# phi-3-vision (Hq = Hkv = 32, hd 96) and whisper-medium's decoder (16, 64)
FAMILY_TRAIN_CASES = [(TRAIN_BATCH, TRAIN_SEQ, 0, 32, 32, 96, 1.0, 0),
                      (TRAIN_BATCH, TRAIN_SEQ, 0, 16, 16, 64, 1.0, 0)]


def _main_path_case(b, l) -> bool:
    """A case at the training or the pipelined step's own shape (logged)."""
    return b == TRAIN_BATCH and l in (TRAIN_SEQ, TRAIN_SEQ // PIPE_SLICES)


def prefill_cases():
    """(B, l, ctx, Hq, Hkv, hd, logit_scale, tail); Sk = ctx + l + tail."""
    cases = [(1, l, ctx, 16, 8, 128, 1.0, 37)
             for l in (1, 96, 100, 128, 1024) for ctx in (0, 256, 700)]
    cases += [(2, 100, 256, 16, 8, hd, 1.0, 37) for hd in (16, 32, 64, 96, 160)]
    cases += [(2, 96, 256, 8, 8, 128, 1.0, 37), (2, 100, 256, 16, 4, 128, 1.0, 37),
              (2, 100, 256, 16, 8, 128, 30.0, 37)]
    cases += [(1, 8, 250, 16, 8, 128, 1.0, 37)]    # an SLO-split serving chunk
    return cases


# GQA rep 16 (qwen3-moe-235b-a22b: Hq 64, Hkv 4, hd 128): its prefill of
# 2 x 1024 tokens, and a training slice at ctx 256 for the backward
MOE_PREFILL_CASE = (2, 1024, 0, 64, 4, 128, 1.0, 0)
MOE_BWD_CASE = (1, 256, 256, 64, 4, 128, 1.0, 37)


def fwd_cases():
    """prefill_cases() plus the training shape, with and without a tail, the
    pipelined step's slices (also at phase 8d's tp-local shape), qwen3-moe's
    GQA-16 prefill and phase 8b's training shapes at hd 96 and 64."""
    return (prefill_cases() + TRAIN_CASES + PIPE_CASES + PAR_CASES + [MOE_PREFILL_CASE]
            + FAMILY_TRAIN_CASES)


def _check_bf16_row_stride() -> None:
    """The wrappers refuse a bf16 row stride that is a multiple of 4 elements
    but not of 8: the tensor-core kernels copy 16-byte row chunks."""
    b, l, h, hd = 1, 4, 2, 128
    row = h * hd + 4
    base = torch.zeros(b * l * row, dtype=torch.bfloat16, device="cuda")
    q = base.as_strided((b, l, h, hd), (l * row, row, hd, 1))
    k = torch.zeros((b, l, h, hd), dtype=torch.bfloat16, device="cuda")
    try:
        terapipe_attention_fwd(q, k, k, 0)
    except ValueError as e:
        log(f"[kernels] bf16 row stride {row} refused: {e}")
        return
    raise AssertionError(f"bf16 row stride {row} (not a multiple of 8) was accepted")


# (B, L, Hq, Hkv, hd, kv_len): the serving round, per-batch mixes, L not a
# multiple of 128, GQA rep 1, 2, 3, 4, 8, 12 and 16 (two query-head groups
# at 12 and 16), every head dim; lengths at the old 128-key chunk edges and
# at the decode cluster's split edges: below C, C, not a multiple of the
# box, BOX*C -+ 1 (a span of one box, of two) and L
C, BOX = tile_walk.DECODE_CLUSTER, tile_walk.DECODE_BOX
SERVE_ROUND = (4, 2048, 16, 8, 128, [1056, 544, 800, 160])
DECODE_CASES = [SERVE_ROUND,
                (6, 2048, 16, 8, 128, [0, 1, 127, 128, 129, 2048]),
                (4, 2048, 16, 8, 128, [1, 2048, 700, 1333]),
                (4, 2048, 16, 8, 128, 1500),
                (4, 2048, 16, 8, 128, 1),
                (2, 256, 16, 8, 128, 0),
                (3, 512, 16, 4, 160, [5, 512, 77]),
                (3, 512, 16, 4, 160, [128, 0, 257]),
                (3, 512, 8, 8, 32, [300, 1, 512]),
                (2, 300, 8, 8, 16, [129, 300]),
                (2, 384, 16, 2, 64, [255, 384]),
                (2, 640, 16, 8, 96, [384, 641]),
                (2, 2048, 64, 4, 128, [1040, 517]),      # qwen3-moe: GQA rep 16
                (8, 2048, 16, 8, 128, [0, 1, C - 1, C, BOX * C - 1, BOX * C + 1, 2048, 999]),
                (3, 300, 64, 4, 128, [C - 1, 300, 2 * BOX + 5]),
                (3, 600, 24, 2, 64, [BOX * C + 1, 600, C - 1]),
                (2, 333, 12, 4, 96, [333, BOX + 1])]
# phase 8b's decodes: phi-3-vision's first step after its 2 x 2048 prefill
# into 2112 rows, whisper's after 2 x 64 tokens into 448
FAMILY_DECODE_CASES = [(2, 2112, 32, 32, 96, 2049), (2, 448, 16, 16, 64, 65)]
DECODE_CASES += FAMILY_DECODE_CASES


def phase_kernels() -> dict:
    _check_bf16_row_stride()
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"terapipe_attention_fwd": 0.0, "decode_attention": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        worst = 0.0
        for (b, l, ctx, hq, hkv, hd, sc, tail) in fwd_cases():
            tol = TOL_F32_X30 if dtype == torch.float32 and sc > 1 else TOL[dtype]
            sk = ctx + l + tail
            q = _rand((b, l, hq, hd), dtype, gen, sc)
            k = _rand((b, sk, hkv, hd), dtype, gen)
            v = _rand((b, sk, hkv, hd), dtype, gen)
            out, lse = terapipe_attention_fwd(q, k, v, ctx)
            ref_out, ref_lse = terapipe_attention_ref(q, k, v, ctx)
            torch.cuda.synchronize()
            what = (f"prefill {dtype} b={b} l={l} ctx={ctx} hq={hq} hkv={hkv} hd={hd} "
                    f"x{sc} tail={tail}")
            e_out = _err(out, ref_out, tol, what + " O")
            e_lse = _err(lse, ref_lse, tol, what + " lse")
            worst = max(worst, e_out, e_lse)
            if _main_path_case(b, l) or hq // hkv == 16:
                log(f"[kernels] {what}: max abs err O {e_out:.3g}, lse {e_lse:.3g} (tol {tol})")
            del out, lse, ref_out, ref_lse
        tol = TOL[dtype]
        log(f"[kernels] terapipe_attention_fwd {dtype}: {len(fwd_cases())} cases, "
            f"max abs err {worst:.3g} (tol {tol}; x30 logits in f32: {TOL_F32_X30})")
        errs["terapipe_attention_fwd"] = max(errs["terapipe_attention_fwd"], worst)

        worst = 0.0
        for (b, L, hq, hkv, hd, kv_len) in DECODE_CASES:
            q = _rand((b, 1, hq, hd), dtype, gen)
            k = _rand((b, L, hkv, hd), dtype, gen)
            v = _rand((b, L, hkv, hd), dtype, gen)
            lens = (torch.tensor(kv_len, dtype=torch.int32, device="cuda")
                    if isinstance(kv_len, list) else kv_len)
            out = decode_attention_kernel(q, k, v, lens)
            ref = decode_attention_ref(q, k, v, lens)
            torch.cuda.synchronize()
            what = f"decode {dtype} b={b} L={L} hq={hq} hkv={hkv} hd={hd} kv_len={kv_len}"
            e = _err(out, ref, tol, what)
            worst = max(worst, e)
            if hq // hkv == 16 or (b, L, hq, hkv, hd, kv_len) in FAMILY_DECODE_CASES:
                log(f"[kernels] {what}: max abs err {e:.3g} (tol {tol})")
            empty = torch.as_tensor(kv_len, device="cuda").reshape(-1).expand(b) == 0
            if torch.count_nonzero(out[empty]).item():
                raise AssertionError(f"decode {dtype} kv_len={kv_len}: kv_len 0 not exactly 0")
        # the spans are merged in a fixed order, with no atomics: two calls
        # on the same inputs agree bit for bit
        b, L, hq, hkv, hd, kv_len = SERVE_ROUND
        q = _rand((b, 1, hq, hd), dtype, gen)
        k = _rand((b, L, hkv, hd), dtype, gen)
        v = _rand((b, L, hkv, hd), dtype, gen)
        lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        if not torch.equal(decode_attention_kernel(q, k, v, lens),
                           decode_attention_kernel(q, k, v, lens)):
            raise AssertionError(f"decode {dtype} kv_len={kv_len}: two launches differ")
        log(f"[kernels] decode_attention {dtype}: {len(DECODE_CASES)} cases, "
            f"max abs err {worst:.3g} (tol {tol}); kv_len 0 gives exactly 0; two "
            f"launches bit-identical at kv_len {kv_len}")
        errs["decode_attention"] = max(errs["decode_attention"], worst)
    return errs


# GQA rep 4, l 200 over two and a half 64-key tiles past a ctx of 100
GQA_CTX_CASE = (2, 200, 100, 16, 4, 128, 1.0, 37)


def bwd_cases():
    """prefill_cases() plus a ragged 33-row slice, a GQA slice whose ctx is
    not a multiple of the dK/dV kernel's 64-key tile, the training shape,
    with and without a tail, the pipelined step's slices (also at phase 8d's
    tp-local shape), a GQA-16 slice and phase 8b's training shapes at hd 96
    and 64."""
    return (prefill_cases() + [(2, 33, 17, 8, 2, 64, 1.0, 37), GQA_CTX_CASE] + TRAIN_CASES
            + PIPE_CASES + PAR_CASES + [MOE_BWD_CASE] + FAMILY_TRAIN_CASES)


def _bwd_inputs(b, l, ctx, hq, hkv, hd, sc, dtype, gen, tail=37):
    """q, k, v, dO, and lse / delta from the forward kernel; Sk = ctx + l + tail."""
    sk = ctx + l + tail
    q = _rand((b, l, hq, hd), dtype, gen, sc)
    k = _rand((b, sk, hkv, hd), dtype, gen)
    v = _rand((b, sk, hkv, hd), dtype, gen)
    do = _rand((b, l, hq, hd), dtype, gen)
    out, lse = terapipe_attention_fwd(q, k, v, ctx)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def phase_kernels_bwd() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs = {"terapipe_attention_dq": 0.0, "terapipe_attention_dkv": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        worst = dict.fromkeys(errs, 0.0)
        for (b, l, ctx, hq, hkv, hd, sc, tail) in bwd_cases():
            # x30 logits in f32: P = exp(s - lse) with |s| ~ 100 carries ~30 times the
            # relative rounding error of the exponent, and dQ, dK, dV are all built
            # from P (dK also linear in the x30 q), so they are held at 30 x 1e-4
            tol = TOL_F32_X30 * sc if dtype == torch.float32 and sc > 1 else TOL[dtype]
            args = _bwd_inputs(b, l, ctx, hq, hkv, hd, sc, dtype, gen, tail) + (ctx,)
            dq, dk, dv = terapipe_attention_bwd(*args)
            rdq, rdk, rdv = terapipe_attention_bwd_ref(*args)
            torch.cuda.synchronize()
            what = (f"bwd {dtype} b={b} l={l} ctx={ctx} hq={hq} hkv={hkv} hd={hd} x{sc} "
                    f"tail={tail}")
            e = [_err(dq, rdq, tol, what + " dQ"), _err(dk, rdk, tol, what + " dK"),
                 _err(dv, rdv, tol, what + " dV")]
            worst["terapipe_attention_dq"] = max(worst["terapipe_attention_dq"], e[0])
            worst["terapipe_attention_dkv"] = max(worst["terapipe_attention_dkv"], *e[1:])
            if sc > 1 or _main_path_case(b, l) or hq // hkv == 16:
                log(f"[kernels] {what}: max abs err dQ {e[0]:.3g}, dK {e[1]:.3g}, "
                    f"dV {e[2]:.3g} (tol {tol})")
            stale = torch.cat([dk[:, ctx + l:], dv[:, ctx + l:]])
            if stale.shape[1] != tail or torch.count_nonzero(stale).item():
                raise AssertionError(f"{what}: dK/dV not exactly zero on the stale tail")
            del args, dq, dk, dv, rdq, rdk, rdv, stale
        log(f"[kernels] terapipe_attention_dq / _dkv {dtype}: {len(bwd_cases())} cases, "
            f"max abs err dQ {worst['terapipe_attention_dq']:.3g}, dK/dV "
            f"{worst['terapipe_attention_dkv']:.3g} (tol {TOL[dtype]}; x30 logits in "
            f"f32: {TOL_F32_X30 * 30:.0e}); stale tails exactly zero")
        errs = {k: max(errs[k], worst[k]) for k in errs}

    # the forward, dQ and dK/dV are deterministic: each output element written
    # once by one block, no atomics, so two launches on the same inputs agree
    # bit for bit
    for (b, l, ctx, hq, hkv, hd, sc, tail) in (TRAIN_CASES[0], GQA_CTX_CASE):
        args = _bwd_inputs(b, l, ctx, hq, hkv, hd, sc, torch.bfloat16, gen, tail) + (ctx,)
        q, k, v, ctx_ = args[0], args[1], args[2], args[-1]
        for name, fn in (("forward", lambda *a: terapipe_attention_fwd(q, k, v, ctx_)),
                         ("dQ", lambda *a: (terapipe_attention_dq(*a),)),
                         ("dK/dV", terapipe_attention_dkv)):
            first, second = fn(*args), fn(*args)
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                raise AssertionError(f"{name} b={b} l={l} ctx={ctx}: two launches differ")
            del first, second
        del args, q, k, v
    log("[kernels] terapipe_attention_fwd, _dq and _dkv bf16: two launches bit-identical "
        "(training shape; GQA l=200 at ctx=100)")

    # the autograd Function (kernels both ways, a strided cotangent) against
    # autograd through the plain forward
    for dtype in (torch.bfloat16, torch.float32):
        b, l, ctx, hq, hkv, hd = 2, 100, 256, 16, 4, 128
        q = _rand((b, l, hq, hd), dtype, gen).requires_grad_(True)
        k = _rand((b, ctx + l + 37, hkv, hd), dtype, gen).requires_grad_(True)
        v = _rand((b, ctx + l + 37, hkv, hd), dtype, gen).requires_grad_(True)
        g = _rand((b, hq, l, hd), dtype, gen).transpose(1, 2)
        got = torch.autograd.grad(ops.terapipe_attention(q, k, v, ctx_len=ctx), (q, k, v), g)
        want = torch.autograd.grad(terapipe_attention_ref(q, k, v, ctx)[0], (q, k, v), g)
        torch.cuda.synchronize()
        worst = max(_err(a, w, TOL[dtype], f"autograd {dtype} {name}")
                    for a, w, name in zip(got, want, "qkv"))
        log(f"[kernels] ops.terapipe_attention under autograd.grad vs autograd of the "
            f"plain op, {dtype}: max abs err {worst:.3g} (tol {TOL[dtype]})")
    return errs


# --------------------------------------------------------------- 3. serve
GEN = 32
GEOM = dict(max_batch=4, max_len=2048, page_size=16, n_pages=4 * 128 + 1)
# chunk-cost units of overhead + l*(ctx+l): every chunk past ~l*(ctx+l)=1068
# is split, so prompts prefill in ~8-token chunks at ctx > 0.  plan_prefill
# walks every distinct cost below slo_tmax with an O(L^2) DP each, so the
# split run keeps its prompts at 128-256 tokens (see PERF.md).
SLO_TMAX = 1100.0


def _serve_run(model, params, prompts, label, slo_tmax=None):
    eng = DecodeEngine(model, params, EngineConfig(**GEOM, slo_tmax=slo_tmax))
    t0 = time.time()
    rids = [eng.submit(p, GEN) for p in prompts]
    plan_s = time.time() - t0
    terapipe_attention_fwd.launches = 0
    decode_attention_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {"terapipe_attention_fwd": terapipe_attention_fwd.launches,
              "decode_attention": decode_attention_kernel.launches}
    chunks = sum(u.kind == "prefill" for u in eng.units)
    rounds = sum(u.kind == "decode" for u in eng.units)
    if counts != {"terapipe_attention_fwd": chunks * N_LAYERS,
                  "decode_attention": rounds * N_LAYERS}:
        raise AssertionError(f"{label}: launches {counts} != {chunks} prefill chunks "
                             f"and {rounds} decode rounds x {N_LAYERS} layers")
    eng.schedule().validate(len(eng.units))
    toks = [eng.finished[r].generated for r in rids]
    vocab = model.cfg.vocab_size
    if any(len(t) != GEN or not all(0 <= x < vocab for x in t) for t in toks):
        raise AssertionError(f"{label}: malformed generations")
    n_tok = sum(len(t) for t in toks)
    log(f"[serve] {label}: {len(prompts)} requests, prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens, {n_tok} tokens in {eng.rounds} rounds "
        f"({chunks} prefill chunks, {rounds} decode rounds, max prefill ctx "
        f"{max(u.ctx[0] for u in eng.units if u.kind == 'prefill')}), wall "
        f"{wall:.3f} s, {n_tok / wall:.2f} tok/s, plan {plan_s:.3f} s; first-token "
        f"rounds {[eng.finished[r].first_token_round for r in rids]}; launches {counts}")
    return toks, counts


def _check_sequential(model, params, prompts, toks, label, slo_tmax=None):
    """The engine's bit-identity contract: the same engine at
    max_concurrency=1 reproduces the continuous run's tokens."""
    eng = DecodeEngine(model, params, EngineConfig(**GEOM, slo_tmax=slo_tmax,
                                                   max_concurrency=1))
    rids = [eng.submit(p, GEN) for p in prompts]
    eng.run()
    for i, r in enumerate(rids):
        if eng.finished[r].generated != toks[i]:
            raise AssertionError(f"{label}: request {i} differs from the sequential run")
    log(f"[serve] {label}: continuous == sequential for {len(rids)} requests")


def _check_against_plain(model, params):
    """Full-width logits through the kernels vs through the plain
    attention path, on one 128-token prompt and one decode step.  The
    bound is loose: over 28 bf16 layers the plain path rounds its
    probabilities to bf16 before PV, the kernels keep them in f32."""
    plain = build_model(model.cfg.replace(use_kernel=False))
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 128), generator=gen, device="cuda")
    nxt = toks[:, :1]
    pos = torch.tensor([128, 77], device="cuda")
    outs = []
    for m in (model, plain):
        logits, caches = m.prefill(params, {"tokens": toks}, 256)
        step, _ = m.decode_step(params, caches, {"tokens": nxt}, pos)
        outs.append((logits, step))
    for name, a, b in (("prefill", outs[0][0], outs[1][0]), ("decode", outs[0][1], outs[1][1])):
        if not torch.isfinite(a).all() or a.shape != b.shape:
            raise AssertionError(f"{name} logits: non-finite or misshapen {tuple(a.shape)}")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"[serve] full-width {name} logits, kernels vs plain attention: "
            f"max abs err / max |logit| = {rel:.3g}")
        if rel > 5e-2:
            raise AssertionError(f"{name} logits: kernels and plain path disagree ({rel:.3g})")


def phase_serve() -> dict:
    cfg = get_config("qwen3-0.6b").replace(use_kernel=True)
    if cfg.n_layers != N_LAYERS or cfg.dtype != torch.bfloat16:
        raise AssertionError(f"qwen3-0.6b FULL changed: {cfg}")
    t0 = time.time()
    model = build_model(cfg)
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[serve] qwen3-0.6b FULL: {n_params / 1e6:.1f} M parameters (f32), "
        f"random init in {time.time() - t0:.1f} s")
    _check_against_plain(model, params)

    rng = np.random.RandomState(1)
    vocab = cfg.vocab_size
    long_prompts = [rng.randint(0, vocab, size=n).tolist()
                    for n in rng.randint(128, 1025, size=8)]
    split_prompts = [rng.randint(0, vocab, size=n).tolist()
                     for n in rng.randint(128, 257, size=8)]
    total = {"terapipe_attention_fwd": 0, "decode_attention": 0}
    toks, counts = _serve_run(model, params, long_prompts, "one chunk per prompt")
    total = {k: total[k] + counts[k] for k in total}
    _check_sequential(model, params, long_prompts[:2], toks, "one chunk per prompt")
    toks, counts = _serve_run(model, params, split_prompts, f"slo_tmax={SLO_TMAX}",
                              slo_tmax=SLO_TMAX)
    total = {k: total[k] + counts[k] for k in total}
    _check_sequential(model, params, split_prompts[:2], toks, f"slo_tmax={SLO_TMAX}",
                      slo_tmax=SLO_TMAX)
    return total


# --------------------------------------------------------------- 4. train
# The kernel path against the plain attention path at full width (bf16, 24
# layers), both held against the plain path in float32.  Everything but the
# attention core is computed alike; the plain bf16 path rounds the
# probabilities to bf16 before P.V and differentiates that, the kernels keep
# P in f32 and rebuild it from lse.  Those ~2^-9 relative differences pass
# through 24 residual layers of bf16 activations and their bf16 gradients,
# which moves every gradient leaf by a few percent (measured, PERF.md) while
# the loss agrees to ~1e-5.  So the kernels must be no farther from the f32
# gradients than the plain bf16 path is (within GRAD_F32_RATIO, for the
# noise of the comparison), and agree with it on the loss; an error of the
# kernels themselves (a dropped term, a wrong mask) moves either by O(1).
LOSS_REL_BOUND = 1e-3
GRAD_F32_RATIO = 1.5


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _routing(entries: list, n_slices: int) -> list:
    """Per MoE layer, in order, ``(topi, keep)`` of one forward pass from a
    ``moe.ROUTING_LOG``: the layer's forward calls (those without autograd
    where there are any, the explicit-backward schedules' forward units;
    else its first ``n_slices``, before any recompute), the groups in token
    order."""
    layers: Dict[int, list] = {}
    for router, topi, keep, grad in entries:
        layers.setdefault(router.data_ptr(), []).append((topi, keep, grad))
    out = []
    for calls in layers.values():
        fwd = [c for c in calls if not c[2]] or calls[:n_slices]
        out.append((torch.cat([c[0] for c in fwd]), torch.cat([c[1] for c in fwd])))
    return out


def _changed(routes: list, ref: list) -> int:
    """(token, choice) pairs whose expert is not among the token's choices
    in ``ref``, over every layer."""
    return sum(int((~(a[..., :, None] == b[..., None, :]).any(-1)).sum())
               for (a, _), (b, _) in zip(routes, ref))


def _drops(routes: list) -> str:
    dropped = sum(int((~keep).sum()) for _, keep in routes)
    total = sum(keep.numel() for _, keep in routes)
    return f"{dropped} of {total} ({dropped / total:.4%})"


def _check_train_against_plain(cfg, pipelined: Optional[Dict[str, TeraPipeConfig]] = None,
                               gspmd: bool = False, seq: int = TRAIN_SEQ,
                               route: str = "kernels", rows: int = 1,
                               versus: Optional[str] = None) -> int:
    """One loss and all its gradients at ``rows`` x ``seq`` from one seeded
    init: through the kernels (the gspmd step if ``gspmd``, and the
    pipelined step of each of ``pipelined``'s configs, one after another:
    a TeraPipeConfig on PIPE_RANKS ranks, or a ``(TeraPipeConfig, Mesh)``
    pair), through the plain
    attention path, and through the plain path in float32; each kernel run
    is held to the bounds.  For the MoE family it also prints each bf16
    path's routing drops and the (token, choice) assignments it changes
    against the float32 path.  ``route`` names the bf16 runs in the lines
    (a family whose attention takes the plain route, or has none, runs the
    same code with ``use_kernel``).  With ``versus`` (a key of
    ``pipelined``), every later pipelined run is also printed against that
    one: loss, worst leaf and, for MoE, the assignments changed.  Returns
    the number of parameters."""
    variants = {"plain": cfg.replace(use_kernel=False),
                "plain f32": cfg.replace(use_kernel=False, dtype=torch.float32),
                "kernel": cfg.replace(use_kernel=True)}
    models = {name: build_model(c) for name, c in variants.items()}
    kernel_vgs = {}
    if gspmd:
        kernel_vgs[route] = value_and_grad(models["kernel"].loss)
    for label, tcfg in (pipelined or {}).items():
        tcfg, mesh = tcfg if isinstance(tcfg, tuple) else (tcfg, PIPE_RANKS)
        kernel_vgs[f"pipelined ({label}) {route}"] = make_terapipe_value_and_grad(
            models["kernel"], tcfg, seq, rows, mesh)
    versus = versus and f"pipelined ({versus}) {route}"
    params = models["kernel"].init(seed=0)
    named = list(tree_items(params))
    for _, p in named:
        p.requires_grad_(True)
    toks = train_launch.make_data(cfg, rows, seq, 1).batch_at(0)
    batch = {k: torch.from_numpy(a).cuda() for k, a in toks.items()}
    is_moe = cfg.family == "moe"

    def run(vg):
        moe.ROUTING_LOG = [] if is_moe else None
        try:
            loss, grads = vg(params, batch)
            routes = (_routing(moe.ROUTING_LOG, vg.plan.M if hasattr(vg, "plan") else 1)
                      if is_moe else None)
        finally:
            moe.ROUTING_LOG = None
        return loss.detach(), list(tree_leaves(grads)), routes

    lp, gp, rp = run(value_and_grad(models["plain"].loss))
    l32, g32, r32 = run(value_and_grad(models["plain f32"].loss))
    p32 = [_rel(a, b) for a, b in zip(gp, g32)]
    wp = max(p32)
    if is_moe:
        log(f"[train] {cfg.name} routing, batch {rows} x seq {seq}, {len(r32)} MoE layers: "
            f"plain bf16 changes {_changed(rp, r32)} (token, choice) assignments of the plain "
            f"f32 path's; drops plain f32 {_drops(r32)}, plain bf16 {_drops(rp)}")
    gv = None
    for label, vg in kernel_vgs.items():
        lk, gk, rk = run(vg)
        if not (torch.isfinite(lk) and all(torch.isfinite(g).all() for g in gk)):
            raise AssertionError(f"train: non-finite loss or gradients, {label}")
        rel_loss = ((lk - lp).abs() / lp.abs()).item()
        vs_plain = [_rel(a, b) for a, b in zip(gk, gp)]
        k32 = [_rel(a, b) for a, b in zip(gk, g32)]
        if label == versus:
            lv, gv, rv = lk, gk, rk
        elif gv is not None:
            vv = [_rel(a, b) for a, b in zip(gk, gv)]
            wv = max(vv)
            log(f"[train] {label} vs {versus}: loss relative "
                f"{((lk - lv).abs() / lv.abs()).item():.3g}, per-leaf worst {wv:.3g} "
                f"({named[vv.index(wv)][0]}), median {statistics.median(vv):.3g}"
                + (f"; changes {_changed(rk, rv)} (token, choice) assignments of that run's"
                   if is_moe else ""))
        del gk
        wk = max(k32)
        if is_moe:
            log(f"[train] {cfg.name} routing, {label}: changes {_changed(rk, r32)} (token, "
                f"choice) assignments of the plain f32 path's ({_changed(rk, rp)} of the plain "
                f"bf16 path's); drops {_drops(rk)}")
        log(f"[train] {cfg.name} FULL width, {cfg.n_layers} layers, batch {rows} x seq {seq}: "
            f"loss {label} {lk.item():.6f}, "
            f"plain {lp.item():.6f}, plain f32 {l32.item():.6f} ({route} vs plain relative "
            f"{rel_loss:.3g}, bound {LOSS_REL_BOUND})")
        log(f"[train] per-leaf |g - g_f32| / |g_f32| over {len(named)} leaves: {label} "
            f"worst {wk:.3g} ({named[k32.index(wk)][0]}), median {statistics.median(k32):.3g}; "
            f"plain bf16 worst {wp:.3g} ({named[p32.index(wp)][0]}), median "
            f"{statistics.median(p32):.3g}; {route} vs plain bf16 worst {max(vs_plain):.3g} "
            f"(bound: {route} worst <= {GRAD_F32_RATIO} x plain worst)")
        if rel_loss > LOSS_REL_BOUND or wk > GRAD_F32_RATIO * wp:
            raise AssertionError(f"train: {label} is off the plain path beyond the bounds")
    return sum(p.numel() for _, p in named)


def _train_run(cfg, argv, label, per_step, steps: int = TRAIN_STEPS) -> tuple:
    """``launch.train.main(argv + --steps steps)`` with every launch counter
    set to 0 just before and read just after: ``steps`` finite losses
    within 1 of ln(vocab), launches equal to ``per_step`` (kernel -> count)
    times the steps.  Returns the counts and the run's metrics."""
    argv = argv + ["--steps", str(steps)]
    log(f"[{label}] python -m repro_torch.launch.train {' '.join(argv)}")
    for fn in COUNTERS.values():
        fn.launches = 0
    base_gb = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    history = []
    # the MoE family: the routing record of each step's calls, split at the
    # steps by a wrapper of train_step (the counts stay on the device)
    step_fn, per_step_routes = train_launch.train_step, []
    if cfg.family == "moe":
        def train_step(*a):
            moe.ROUTING_LOG = []
            try:
                return step_fn(*a)
            finally:
                per_step_routes.append(moe.ROUTING_LOG)
                moe.ROUTING_LOG = None
        train_launch.train_step = train_step
    try:
        final = train_launch.main(argv, history=history)
    finally:
        train_launch.train_step = step_fn
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    losses = [r["loss"] for r in history]
    ln_v = math.log(cfg.vocab_size)
    if len(losses) != steps or not all(abs(x - ln_v) <= 1.0 for x in losses):
        raise AssertionError(f"{label}: losses {losses} not {steps} finite values "
                             f"within 1 of ln V = {ln_v:.4f}")
    if final != losses[-1]:
        raise AssertionError(f"{label}: main returned {final}, last logged {losses[-1]}")
    want = {k: per_step.get(k, 0) * steps for k in COUNTERS}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} != {want}")
    step_ms = statistics.median(r["ms_per_step"] for r in history[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    metrics = {"step_ms": step_ms, "tok_s": tokens / step_ms * 1e3, "peak_gib": peak_gb,
               "base_gib": base_gb}
    if per_step_routes:
        # every evaluation of a routing call, recomputes included, is
        # counted: a recompute repeats its forward's drops, so the share is
        # the forward pass's
        shares = []
        for entries in per_step_routes:
            dropped = sum(int((~keep).sum()) for _, _, keep, _ in entries)
            shares.append(dropped / sum(keep.numel() for _, _, keep, _ in entries))
        metrics["drop_share"] = shares
        log(f"[{label}] routing drops per step (share of the (token, choice) pairs past "
            f"capacity, over every routing call of the step): "
            f"{', '.join(f'{x:.4%}' for x in shares)}")
    log(f"[{label}] {cfg.name} FULL width, {cfg.n_layers} layers, {steps} steps of batch "
        f"{TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ}: losses {losses}; step {step_ms:.1f} ms (median of steps "
        f"2-{steps}), {metrics['tok_s']:.0f} tok/s, peak allocated {peak_gb:.2f} GiB "
        f"({base_gb:.2f} allocated before the run); "
        f"launches {counts}")
    return counts, metrics


def _launches_per_step(cfg, work_items: int, schedule: str = "contiguous",
                       pre_layers: int = 0, tp: int = 1, data: int = 1) -> dict:
    """Kernel launches of one training step that runs every layer but the
    ``pre_layers`` before the pipeline on ``work_items`` (slice,
    microbatch) pieces under ``schedule``, per layer per piece:
    * forward-only schedules (contiguous, interleaved, and the gspmd step):
      autograd over the step, where remat runs each layer's forward again
      in the backward (non-reentrant checkpoint): 1 + remat forward, 1 dQ,
      1 dK/dV;
    * 1f1b and interleaved-1f1b: the forward unit, without autograd, then
      the backward unit's recompute, which is the remat (no checkpoint
      inside it): 2 forward, 1 dQ, 1 dK/dV;
    * zb-h1: the same 2 forward (W takes B's graph, kept one tick), but B
      (the inputs' gradient) and W (the parameters') each run the
      attention backward: 2 dQ, 2 dK/dV.
    A pre-group layer runs once on the whole sequence, differentiated by
    autograd under any schedule: 1 + remat forward, 1 dQ, 1 dK/dV.  On a
    mesh, each data rank runs its own step (``work_items`` are one data
    rank's), and within a stage each tp rank calls each kernel on its own
    heads; the pre-groups run once per data rank, not per tp rank."""
    spec = REGISTRY[schedule]
    n = work_items * (cfg.n_layers - pre_layers) * tp * data
    pre = pre_layers * data
    fwd = 2 if spec.has_backward or cfg.remat else 1
    bwd = 2 if spec.splits_backward else 1
    pre_fwd = 2 if cfg.remat else 1
    return {"terapipe_attention_fwd": fwd * n + pre_fwd * pre,
            "terapipe_attention_dq": bwd * n + pre,
            "terapipe_attention_dkv": bwd * n + pre}


def _gpt3_1b():
    cfg = get_config("gpt3-1b")
    if (cfg.n_layers, cfg.d_model, cfg.hd, cfg.dtype, cfg.remat) != (
            24, 2048, 128, torch.bfloat16, True):
        raise AssertionError(f"gpt3-1b FULL changed: {cfg}")
    return cfg


TRAIN_ARGV = ["--arch", "gpt3-1b", "--use-kernel", "--batch", str(TRAIN_BATCH), "--seq",
              str(TRAIN_SEQ), "--log-every", "1", "--seed", "0"]


def phase_train():
    """gpt3-1b at full width: kernels vs plain, then TRAIN_STEPS steps of
    repro_torch.launch.train.main --use-kernel.  Returns the launches of the
    main run and its metrics."""
    cfg = _gpt3_1b()
    torch.cuda.empty_cache()
    n_params = _check_train_against_plain(cfg, gspmd=True)
    torch.cuda.empty_cache()
    counts, metrics = _train_run(cfg, TRAIN_ARGV, "train", _launches_per_step(cfg, 1))
    log(f"[train] {n_params:,} parameters")
    torch.cuda.empty_cache()
    return counts, metrics


TOP_KERNELS = 15
TOP_HOST_OPS = 12


def _profile_step(cfg, make_vg, label: str) -> dict:
    """One step of the timed run's shape (launch.train.train_step with the
    value-and-grad ``make_vg(model)``, after one unprofiled step) under
    torch.profiler with CUDA activities: prints the device kernels that
    took the most time and the repo's own kernels, each with its rank and
    share of the step's wall time, and the device's busy share.  Returns
    the step's wall and device ms."""
    from torch.profiler import ProfilerActivity, profile

    model = build_model(cfg)
    vg_fn = make_vg(model)
    opt = adamw(cosine_schedule(3e-4, 20, TRAIN_STEPS))
    state = {"params": tree_map(lambda p: p.requires_grad_(True), model.init(seed=0))}
    state["opt_state"] = opt.init(state["params"])
    data = train_launch.make_data(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)
    batches = [{k: torch.from_numpy(a).cuda() for k, a in data.batch_at(i).items()}
               for i in range(2)]
    train_launch.train_step(vg_fn, opt, state, batches[0])
    torch.cuda.synchronize()
    # what besides the step can take the host's time: the allocator's
    # retries (a sync and a cache flush each), page faults, preemption
    mem0 = torch.cuda.memory_stats()
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        train_launch.train_step(vg_fn, opt, state, batches[1])
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    retries = torch.cuda.memory_stats()["num_alloc_retries"] - mem0["num_alloc_retries"]
    log(f"[profile] {label}: before the step {mem0['allocated_bytes.all.current'] / 2**30:.2f} "
        f"GiB allocated, {mem0['reserved_bytes.all.current'] / 2**30:.2f} GiB reserved; during "
        f"it {retries} allocator retries, {use1.ru_minflt - use0.ru_minflt} minor and "
        f"{use1.ru_majflt - use0.ru_majflt} major page faults, "
        f"{use1.ru_nivcsw - use0.ru_nivcsw} involuntary context switches")
    per_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = per_name.get(e.name, (0, 0.0))
            per_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not per_name:
        raise AssertionError("train profile: torch.profiler recorded no device kernels")
    busy = sum(us for _, us in per_name.values())
    log(f"[profile] {cfg.name} FULL width, {cfg.n_layers} layers, {label}, one step of batch "
        f"{TRAIN_BATCH} x seq {TRAIN_SEQ} "
        f"(torch.profiler, CUDA activities): wall {wall_us / 1e3:.1f} ms, device kernels "
        f"{busy / 1e3:.1f} ms ({busy / wall_us:.1%} of the wall time) over "
        f"{sum(n for n, _ in per_name.values())} launches of {len(per_name)} kernels")
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][1])
    for rank, (name, (n, us)) in enumerate(ranked, 1):
        if rank <= TOP_KERNELS or re.search(r"\b(fwd|dq|dkv)_kernel|decode_\w*kernel", name):
            log(f"[profile] {rank:2d}. {us / 1e3:9.3f} ms {us / wall_us:6.1%}  x{n:<5d} "
                f"{name[:150]}")
    # where the host's time goes (self time of each operator on the CPU side,
    # inflated by the profiler's own cost; the shares are what it shows)
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)
    for e in host[:TOP_HOST_OPS]:
        log(f"[profile] host {e.self_cpu_time_total / 1e3:9.3f} ms "
            f"{e.self_cpu_time_total / wall_us:6.1%}  x{e.count:<6d} {e.key[:100]}")
    return {"wall_ms": wall_us / 1e3, "device_ms": busy / 1e3}


# ------------------------------------------------------------ 5. pipeline
# fixed non-uniform slices for the parity check: every slice at its own
# length, ctx offsets off the kernels' 64-row tiles (584)
PIPE_NONUNIFORM = (384, 200, 312, 640, 512)
SWEEP_L = (32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048)
COST_PAIRS = ((256, 0), (256, 1024), (256, 1792), (1024, 0), (2048, 0))


def _loop_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call of ``fn`` over ``iters`` back-to-back calls
    between two CUDA events: the steady state of a loop of such calls, host
    dispatch included wherever it is the slower side."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int = 20) -> float:
    """Device ms per call of ``fn`` replayed from a CUDA graph (captured
    after a warm-up on a side stream): the same work without the host's
    dispatch of each launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _loop_ms(graph.replay, iters)


SWEEP_REPEATS = 5


def _stage_sweep(cfg) -> tuple:
    """The paper's Fig. 3 on the card: one pipeline stage (n_layers /
    PIPE_RANKS blocks, random weights) runs its forward on one slice of l
    tokens of each of the executor's TRAIN_BATCH sequences (D = 1) at ctx 0
    through the kernels, for each l in SWEEP_L: replayed from a CUDA graph
    (the device's own time), and eagerly, as the executor runs it today
    (median of SWEEP_REPEATS loops of 10 calls; the host's dispatch shows
    in it).  Returns the H100 spec's (efficiency, occupancy_floor) fitted
    to the graph times, which repeat from run to run, and prints the fit to
    the eager times beside it."""
    layers = cfg.n_layers // PIPE_RANKS
    model = build_model(cfg.replace(n_layers=layers, use_kernel=True))
    params = model.init(seed=5)
    blocks = [tree_map(lambda a: a[i], params["groups"]["blocks"]) for i in range(layers)]
    block = model.groups[0].sliced_dyn
    gen = torch.Generator(device="cuda").manual_seed(6)
    b = TRAIN_BATCH
    # the model's FLOPs of the stage at l (no floor): its time at peak rate
    ideal = AnalyticCostModel(cfg, dataclasses.replace(H100, efficiency=1.0, occupancy_floor=1),
                              layers_per_stage=layers, batch=b, include_backward=False)
    eager, graphed = [], []
    for l in SWEEP_L:
        x0 = torch.randn((b, l, cfg.d_model), generator=gen, device="cuda").to(cfg.dtype)
        ck, cv = model.init_caches(b, l, cfg.dtype)[0]

        @torch.no_grad()
        def stage():
            x = x0
            for i, bp in enumerate(blocks):
                x, _ = block(bp, x, (ck[i], cv[i]), 0)
            return x

        ms = statistics.median(_loop_ms(stage, iters=10) for _ in range(SWEEP_REPEATS))
        g_ms = _graph_ms(stage)
        eager.append(ms / 1e3)
        graphed.append(g_ms / 1e3)
        flops = ideal.t_fwd(l, 0) * H100.peak_flops
        log(f"[pipeline] stage sweep: {layers} blocks, batch {b}, l {l:5d} at ctx 0: eager "
            f"{ms:.4f} ms ({flops / (ms / 1e3) / 1e12:.1f} TFLOP/s of model FLOPs), CUDA graph "
            f"{g_ms:.4f} ms ({flops / (g_ms / 1e3) / 1e12:.1f} TFLOP/s)")
    eff, floor = fit_efficiency_and_floor(cfg, H100, layers, SWEEP_L, graphed, batch=b)
    e_eff, e_floor = fit_efficiency_and_floor(cfg, H100, layers, SWEEP_L, eager, batch=b)
    log(f"[pipeline] H100 spec fitted to the CUDA-graph sweep (batch {b}): efficiency "
        f"{eff:.4f}, occupancy_floor {floor} (committed: {H100.efficiency}, "
        f"{H100.occupancy_floor}); to the eager sweep: efficiency {e_eff:.4f}, "
        f"occupancy_floor {e_floor}")
    return eff, floor


PIPE_STEPS = 3
# the schedules beyond contiguous, each with its V
PIPE_SCHEDULES = (("1f1b", 1), ("zb-h1", 1), ("interleaved", 2), ("interleaved-1f1b", 2))
FLAT_D = (2, 4)                 # 1F1B's memory check: microbatches of one sequence
FLAT_D_BOUND = 0.10
COST_RATIO = (2.0, 6.0)         # bwd/fwd of every cost-table entry
COST_REPEAT_BOUND = 0.25        # the l 256, ctx 0 backward entry across two tables


def _schedule_argv(schedule: str, V: int) -> list:
    return ["--schedule", schedule] + (["--virtual-stages", str(V)] if V > 1 else [])


def _step_memory(cfg, tcfg: TeraPipeConfig, batch: int) -> tuple:
    """One pipelined step of ``batch`` sequences (kernels) from a seeded
    init: ``(GiB allocated at the step's peak above its pre-step baseline,
    the residual store's peak or None, step ms)``."""
    model = build_model(cfg.replace(use_kernel=True))
    params = tree_map(lambda p: p.requires_grad_(True), model.init(seed=0))
    vg = make_terapipe_value_and_grad(model, tcfg, TRAIN_SEQ, batch, PIPE_RANKS)
    toks = DataPipeline(SyntheticSource(cfg.vocab_size, 2), batch, TRAIN_SEQ).batch_at(0)
    data = {k: torch.from_numpy(a).cuda() for k, a in toks.items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    loss, grads = vg(params, data)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if not torch.isfinite(loss):
        raise AssertionError(f"memory run: non-finite loss {loss}")
    return peak, getattr(vg, "residual_peak", None), ms


def _flat_in_d(cfg) -> None:
    """1F1B's claim: the step's memory does not grow with the microbatch
    count D at a fixed microbatch (one sequence, M PIPE_SLICES), because the
    residual store holds at most peak_live_items = min(D*M, K+M-1) units per
    rank; contiguous, whose autograd keeps every unit to the drain, beside
    it."""
    got = {}
    for schedule in ("1f1b", "contiguous"):
        for d in FLAT_D:
            tcfg = TeraPipeConfig(n_token_slices=PIPE_SLICES, n_microbatches=d, schedule=schedule)
            torch.cuda.empty_cache()
            peak, live, ms = _step_memory(cfg, tcfg, d)
            assign = get_schedule(schedule, n_ranks=PIPE_RANKS, n_layers=cfg.n_layers,
                                  n_microbatches=d)
            want_live = assign.peak_live_items(d * PIPE_SLICES)
            if live is not None and live != want_live:
                raise AssertionError(f"{schedule} D {d}: residual peak {live} != "
                                     f"peak_live_items {want_live}")
            got[schedule, d] = peak
            log(f"[pipeline] memory, {schedule}, D {d} x 1 sequence x seq {TRAIN_SEQ}, M "
                f"{PIPE_SLICES}: step peak {peak:.3f} GiB above its baseline, live units per "
                f"rank {want_live} (executor {live}), step {ms:.1f} ms")
    a, b = (got["1f1b", d] for d in FLAT_D)
    rel = abs(b - a) / a
    log(f"[pipeline] 1f1b step memory D {FLAT_D[1]} vs D {FLAT_D[0]}: {b:.3f} vs {a:.3f} GiB "
        f"({rel:.1%}, bound {FLAT_D_BOUND:.0%}); contiguous {got['contiguous', FLAT_D[1]]:.3f} "
        f"vs {got['contiguous', FLAT_D[0]]:.3f} GiB")
    if rel > FLAT_D_BOUND:
        raise AssertionError(f"1f1b: step memory grows with D beyond {FLAT_D_BOUND:.0%}")


def _cost_tables(cfg) -> None:
    """The kernel cost table twice: each backward entry (dQ + dK/dV on one
    saved forward) against its forward within COST_RATIO, and the l 256,
    ctx 0 backward entry within COST_REPEAT_BOUND across the two."""
    tables = [measure_kernel_cost_table(COST_PAIRS, batch=TRAIN_BATCH, n_heads=cfg.n_heads,
                                        head_dim=cfg.hd, dtype=cfg.dtype, n_iters=10)
              for _ in range(2)]
    for rep, table in enumerate(tables, 1):
        for key in COST_PAIRS:
            f, b = table.t_fwd(*key), table.t_bwd(*key)
            log(f"[pipeline] cost table {rep} (B {TRAIN_BATCH}, H {cfg.n_heads}, hd {cfg.hd}, "
                f"bf16) l {key[0]} ctx {key[1]}: fwd {f * 1e3:.4f} ms, bwd {b * 1e3:.4f} ms, "
                f"bwd/fwd {b / f:.3f}")
            if not COST_RATIO[0] <= b / f <= COST_RATIO[1]:
                raise AssertionError(f"cost table: bwd/fwd {b / f:.3f} at {key} outside "
                                     f"{COST_RATIO}")
    b1, b2 = (t.t_bwd(256, 0) for t in tables)
    rel = abs(b1 - b2) / min(b1, b2)
    log(f"[pipeline] cost table l 256 ctx 0 backward across two tables: {b1 * 1e3:.4f} vs "
        f"{b2 * 1e3:.4f} ms ({rel:.1%}, bound {COST_REPEAT_BOUND:.0%})")
    if rel > COST_REPEAT_BOUND:
        raise AssertionError("cost table: the l 256, ctx 0 backward entry does not repeat")


def phase_pipeline() -> tuple:
    """gpt3-1b at full width through the token-slice pipeline on PIPE_RANKS
    virtual ranks.  Returns the launches of its main runs and, per
    schedule, the metrics of its 3-step run."""
    cfg = _gpt3_1b()
    torch.cuda.empty_cache()
    fit = _stage_sweep(cfg)
    torch.cuda.empty_cache()
    parity = {f"K {PIPE_RANKS}, M {PIPE_SLICES}": TeraPipeConfig(n_token_slices=PIPE_SLICES),
              f"K {PIPE_RANKS}, slices {list(PIPE_NONUNIFORM)}": TeraPipeConfig(
                  slice_lens=PIPE_NONUNIFORM)}
    for schedule, V in PIPE_SCHEDULES:
        parity[f"{schedule}, V {V}, K {PIPE_RANKS}, M {PIPE_SLICES}"] = TeraPipeConfig(
            n_token_slices=PIPE_SLICES, schedule=schedule, virtual_stages=V)
    _check_train_against_plain(cfg, parity)
    torch.cuda.empty_cache()

    counts, runs = {}, {}
    for schedule, V in (("contiguous", 1),) + PIPE_SCHEDULES:
        argv = (TRAIN_ARGV + ["--mode", "terapipe", "--token-slices", str(PIPE_SLICES)]
                + _schedule_argv(schedule, V))
        counts[schedule], runs[schedule] = _train_run(
            cfg, argv, f"pipeline {schedule}", _launches_per_step(cfg, PIPE_SLICES, schedule),
            steps=PIPE_STEPS)
        torch.cuda.empty_cache()
    log("[pipeline] schedules, M " + str(PIPE_SLICES) + ": " + "; ".join(
        f"{s} {m['step_ms']:.1f} ms/step, peak {m['peak_gib']:.2f} GiB"
        for s, m in runs.items()))

    slices, plan = train_launch.plan_slices(cfg, TRAIN_SEQ, PIPE_RANKS, H100,
                                            batch=TRAIN_BATCH)
    counts["dp-plan"], dp_metrics = _train_run(
        cfg, TRAIN_ARGV + ["--mode", "terapipe", "--dp-plan"], "pipeline dp-plan",
        _launches_per_step(cfg, len(slices)), steps=PIPE_STEPS)
    # the model's own estimate of this step on one card: every stage of
    # every slice in turn, the whole batch, forward and backward (the
    # optimizer and the head are not in it)
    one_card = AnalyticCostModel(cfg, H100, layers_per_stage=cfg.n_layers, batch=TRAIN_BATCH)
    ctxs = np.cumsum((0,) + slices[:-1])
    one_card_ms = sum(one_card.t_fwd(l, c) for l, c in zip(slices, ctxs)) * 1e3
    log(f"[pipeline] dp-plan: slices {list(slices)}; predicted {plan.latency * 1e3:.3f} ms "
        f"(Eq. 5: {PIPE_RANKS} cards, batch {TRAIN_BATCH}, fwd+bwd), on one card for batch "
        f"{TRAIN_BATCH} {one_card_ms:.3f} ms (the same model, stages in turn); measured "
        f"step {dp_metrics['step_ms']:.1f} ms vs uniform M {PIPE_SLICES} "
        f"{runs['contiguous']['step_ms']:.1f} ms")
    torch.cuda.empty_cache()

    _flat_in_d(cfg)
    torch.cuda.empty_cache()
    _cost_tables(cfg)
    log(f"[pipeline] summary: H100 fit efficiency {fit[0]:.4f}, occupancy_floor {fit[1]}")
    return {f"terapipe {s}": c for s, c in counts.items()}, runs


# ------------------------------------------------- 6. restart and audit
RESTART_STEPS, RESTART_EVERY, RESTART_FAULT = 6, 3, 4
RESTART_DIR = ROOT / "build" / "restart_ckpt"
# two checkpoints of the full-width state (2 x 20.4 GiB) exist at once: the
# newest while the next one is written, and (b)'s step 3 beside its step 6
RESTART_DISK_FACTOR = 2.2
RESUME_SCHEDULE = "1f1b"
# (b) held to (a) within the run-to-run spread, if (a) does not repeat
SPREAD_FACTOR = 4.0
PEAK_BOUND_GIB = 0.1
AUDIT_RUNS = (("contiguous", TRAIN_BATCH, True), ("contiguous", 1, False),
              (RESUME_SCHEDULE, TRAIN_BATCH, True))


def _state_bytes(cfg) -> int:
    """Bytes of params + AdamW m + v in f32 of a dense model (Hq = Hkv)."""
    d = cfg.d_model
    layer = 4 * d * cfg.n_heads * cfg.hd + 3 * d * cfg.d_ff + 2 * d
    return 12 * (2 * cfg.vocab_size * d + d + cfg.n_layers * layer)


def _host_state(state) -> list:
    """(path, host copy) of every leaf of a checkpoint tree, in the
    checkpoint's order."""
    return [(path, torch.as_tensor(leaf).detach().cpu()) for path, leaf in jax_items(state)]


def _differences(ref: list, state) -> list:
    """(path, max abs difference) of each leaf of ``state`` that is not
    bit-equal to ``ref``'s, compared on the host leaf by leaf."""
    items = jax_items(state)
    if len(items) != len(ref):
        raise AssertionError(f"restart: {len(items)} leaves, want {len(ref)}")
    out = []
    for (path, want), (_, leaf) in zip(ref, items):
        got = torch.as_tensor(leaf).detach().cpu()
        if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
            out.append((path, (got.double() - want.double()).abs().max().item()))
    return out


def _restart_run(cfg, argv, label, per_step, step_runs: int) -> tuple:
    """``launch.train.main(argv)`` with every launch counter set to 0 just
    before and read just after: finite losses within 1 of ln(vocab),
    launches equal to ``per_step`` times ``step_runs`` (the train_step
    calls, a replayed step counted again).  Returns (history, out, counts,
    peak GiB above the memory allocated before the run, seconds)."""
    log(f"[restart] {label}: python -m repro_torch.launch.train {' '.join(argv)}")
    for fn in COUNTERS.values():
        fn.launches = 0
    base = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    history, out = [], {}
    t0 = time.time()
    train_launch.main(argv, history=history, out=out)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30 - base
    ln_v = math.log(cfg.vocab_size)
    if not all(abs(r["loss"] - ln_v) <= 1.0 for r in history):
        raise AssertionError(f"{label}: losses {[r['loss'] for r in history]} not within 1 "
                             f"of ln V = {ln_v:.4f}")
    want = {k: per_step.get(k, 0) * step_runs for k in COUNTERS}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} != {want}")
    for r in out["checkpoints"]:
        log(f"[restart] {label}: {r['op']} step {r['step']}: {r['bytes'] / 2**30:.3f} GiB in "
            f"{r['seconds']:.2f} s ({r['bytes'] / r['seconds'] / 1e9:.2f} GB/s)")
    log(f"[restart] {label}: losses {[(r['step'], r['loss']) for r in history]}; "
        f"{seconds:.1f} s, peak allocated {peak:.2f} GiB above the {base:.2f} GiB allocated "
        f"before the run, launches {counts}")
    return history, out, counts, peak, seconds


def _restart(cfg_full, peaks: dict) -> dict:
    """gpt3-1b (full width; full depth when the disk holds two checkpoints)
    through launch.train.main --use-kernel at batch 4 x seq 2048:
    (a) RESTART_STEPS uninterrupted gspmd steps, twice; (b) the same run
    with --checkpoint-dir, --checkpoint-every RESTART_EVERY and
    --simulate-failure-at RESTART_FAULT, bit-equal to (a) (or, if (a) does
    not repeat, within SPREAD_FACTOR x its run-to-run spread); (c) resumed
    from (b)'s step-3 checkpoint under --mode terapipe --schedule 1f1b, M 8,
    losses within LOSS_REL_BOUND of (a)'s.  At full depth each run's peak
    allocated memory above what was allocated before it stays within
    PEAK_BOUND_GIB of its mode's in phases 4 and 5 (``peaks``: "gspmd",
    RESUME_SCHEDULE): no checkpoint or fault path holds a second copy of
    the state.  Returns the launches of the runs."""
    RESTART_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(RESTART_DIR).free
    depth = cfg_full.n_layers
    while depth > 1 and RESTART_DISK_FACTOR * _state_bytes(
            cfg_full.replace(n_layers=depth)) > free:
        depth -= 1
    cfg = cfg_full.replace(n_layers=depth)
    state_gib = _state_bytes(cfg) / 2**30
    log(f"[restart] disk free {free:,} bytes ({free / 2**30:.1f} GiB) under {RESTART_DIR}; "
        f"state {state_gib:.2f} GiB at {depth} of {cfg_full.n_layers} layers")
    get_config = train_launch.get_config
    if depth < cfg_full.n_layers:
        train_launch.get_config = lambda arch, smoke: get_config(arch, smoke).replace(
            n_layers=depth)
    ckpt_dir = RESTART_DIR / "run"
    steps = ["--steps", str(RESTART_STEPS)]
    gspmd = _launches_per_step(cfg, 1)
    try:
        hist_a, out_a, counts_a, peak_a, sec_a = _restart_run(
            cfg, TRAIN_ARGV + steps, "(a)", gspmd, RESTART_STEPS)
        ref = _host_state(out_a.pop("state"))
        _, out_a2, counts_a2, _, _ = _restart_run(cfg, TRAIN_ARGV + steps, "(a) again", gspmd,
                                                  RESTART_STEPS)
        spread = _differences(ref, out_a2.pop("state"))
        # the fault after step RESTART_FAULT replays RESTART_FAULT - RESTART_EVERY + 1 steps
        replayed = RESTART_FAULT - RESTART_EVERY + 1
        hist_b, out_b, counts_b, peak_b, sec_b = _restart_run(
            cfg, TRAIN_ARGV + steps + ["--checkpoint-dir", str(ckpt_dir), "--checkpoint-every",
                                       str(RESTART_EVERY), "--simulate-failure-at",
                                       str(RESTART_FAULT)],
            "(b)", gspmd, RESTART_STEPS + replayed)
        diff_b = _differences(ref, out_b.pop("state"))
        ops = [(r["op"], r["step"]) for r in out_b["checkpoints"]]
        want_ops = [("save", RESTART_EVERY), ("restore", RESTART_EVERY),
                    ("save", 2 * RESTART_EVERY)]
        if ops != want_ops:
            raise AssertionError(f"(b): checkpoint operations {ops} != {want_ops}")
        worst = lambda d: max((x for _, x in d), default=0.0)
        if spread:
            log(f"[restart] (a) does not repeat: {len(spread)} of {len(ref)} leaves differ "
                f"between two uninterrupted runs, worst {worst(spread):.3g} "
                f"({max(spread, key=lambda x: x[1])[0]})")
            if worst(diff_b) > SPREAD_FACTOR * worst(spread):
                raise AssertionError(f"(b) is off (a) by {worst(diff_b):.3g}, beyond "
                                     f"{SPREAD_FACTOR} x the run-to-run spread")
        elif diff_b:
            raise AssertionError(f"(b) is not bit-equal to (a): {diff_b[:8]}")
        # (c): the step-3 checkpoint of (b) is the latest once its step 6 goes
        shutil.rmtree(ckpt_dir / f"step_{2 * RESTART_EVERY:08d}")
        hist_c, out_c, counts_c, peak_c, sec_c = _restart_run(
            cfg, TRAIN_ARGV + steps + ["--mode", "terapipe", "--token-slices", str(PIPE_SLICES),
                                       "--schedule", RESUME_SCHEDULE, "--checkpoint-dir",
                                       str(ckpt_dir), "--checkpoint-every",
                                       str(RESTART_EVERY), "--resume"],
            f"(c) {RESUME_SCHEDULE}", _launches_per_step(cfg, PIPE_SLICES, RESUME_SCHEDULE),
            RESTART_STEPS - RESTART_EVERY)
        want_c = {r["step"]: r["loss"] for r in hist_a}
        rel_c = [abs(r["loss"] - want_c[r["step"]]) / abs(want_c[r["step"]]) for r in hist_c]
        if [r["step"] for r in hist_c] != list(range(RESTART_EVERY + 1, RESTART_STEPS + 1)) \
                or max(rel_c) > LOSS_REL_BOUND:
            raise AssertionError(f"(c): losses {hist_c} vs (a) {hist_a}: relative {rel_c}")
        out_c.pop("state")
        if depth == cfg_full.n_layers:
            for label, peak, mode in (("(a)", peak_a, "gspmd"), ("(b)", peak_b, "gspmd"),
                                      ("(c)", peak_c, RESUME_SCHEDULE)):
                if abs(peak - peaks[mode]) > PEAK_BOUND_GIB:
                    raise AssertionError(f"{label}: peak {peak:.2f} GiB above its baseline, "
                                         f"{mode}'s run without checkpoints {peaks[mode]:.2f}")
    finally:
        train_launch.get_config = get_config
        shutil.rmtree(RESTART_DIR, ignore_errors=True)
    recs = out_b["checkpoints"] + out_c["checkpoints"]
    rate = lambda op: ", ".join(f"{r['seconds']:.2f} s {r['bytes'] / r['seconds'] / 1e9:.2f} GB/s"
                                for r in recs if r["op"] == op)
    log(f"[checkpoint] {_card()}; gpt3-1b FULL width, {depth} of {cfg_full.n_layers} layers, "
        f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, --use-kernel: checkpoint "
        f"{recs[0]['bytes']:,} bytes ({recs[0]['bytes'] / 2**30:.3f} GiB, params + m + v f32 + "
        f"step), disk free before {free:,} bytes; saves {rate('save')}; restores "
        f"{rate('restore')}; (a) repeats bit for bit: {not spread} "
        f"({len(spread)} leaves differ, worst {worst(spread):.3g}); (b) fault after step "
        f"{RESTART_FAULT}, restored step {RESTART_EVERY}, bit-equal to (a): {not diff_b} "
        f"({len(diff_b)} of {len(ref)} leaves differ, worst {worst(diff_b):.3g}); (c) "
        f"{RESUME_SCHEDULE} M {PIPE_SLICES} resumed at step {RESTART_EVERY}: loss relative to "
        f"(a) {', '.join(f'{x:.3g}' for x in rel_c)} (bound {LOSS_REL_BOUND}); peaks (a) "
        f"{peak_a:.2f}, (b) {peak_b:.2f}, (c) {peak_c:.2f} GiB above their baselines (phases 4 "
        f"and 5: gspmd {peaks['gspmd']:.2f}, {RESUME_SCHEDULE} {peaks[RESUME_SCHEDULE]:.2f}); "
        f"run s (a) {sec_a:.1f}, "
        f"(b) {sec_b:.1f}, (c) {sec_c:.1f}")
    return {"restart (a)": counts_a, "restart (a) again": counts_a2, "restart (b)": counts_b,
            f"restart (c) {RESUME_SCHEDULE}": counts_c}


def _audit(cfg) -> None:
    """One full-width pipelined step (M 8, kernels) under each of
    AUDIT_RUNS through analysis.audit.audit_step: comm.ring-match,
    buffer.score-matrix and buffer.repeated-kv clean; the saved bytes and
    the dtype census printed.  contiguous runs twice: as trained (remat on,
    batch 4: the census of PERF.md's profiled step), and with remat off at
    batch 1, so that the blocks' saved tensors reach the hooks (inside a
    checkpoint region they do not)."""
    lines = []
    for schedule, batch, remat in AUDIT_RUNS:
        model = build_model(cfg.replace(use_kernel=True, remat=remat))
        params = tree_map(lambda p: p.requires_grad_(True), model.init(seed=0))
        vg = make_terapipe_value_and_grad(model, TeraPipeConfig(
            n_token_slices=PIPE_SLICES, schedule=schedule), TRAIN_SEQ, batch, PIPE_RANKS)
        toks = DataPipeline(SyntheticSource(cfg.vocab_size, 0), batch, TRAIN_SEQ).batch_at(0)
        data = {k: torch.from_numpy(a).cuda() for k, a in toks.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        rec = audit.audit_step(vg, params, data, kernel_rules=True)
        torch.cuda.synchronize()
        sec = time.time() - t0
        label = f"{schedule} batch {batch} remat {'on' if remat else 'off'}"
        for f in rec["findings"]:
            log(f"[audit-step] {label}: {f}")
        errs = errors(rec["findings"])
        if errs:
            raise AssertionError(f"audit {label}: {[str(f) for f in errs]}")
        ran = {f.rule for f in rec["findings"]}
        casts = rec["casts"]
        lines.append(f"{label}: ring and score clean, repeated-kv "
                     f"{'clean' if 'buffer.repeated-kv' in ran else 'vacuous (Hq = Hkv)'}; "
                     f"saved peak {rec['saved_peak_bytes'] / 2**30:.3f} GiB over "
                     f"{rec['saved_tensors']} saves; casts f32->bf16 "
                     f"{casts.get('float32->bfloat16', 0)}, bf16->f32 "
                     f"{casts.get('bfloat16->float32', 0)}; loss {rec['loss']:.4f}; {sec:.1f} s, "
                     f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del model, params, vg, data, rec
        torch.cuda.empty_cache()
    log(f"[audit] {_card()}; gpt3-1b FULL, seq {TRAIN_SEQ}, M {PIPE_SLICES}, K {PIPE_RANKS}, "
        f"kernels, one step each through analysis.audit (PERF.md §5: 5,007 f32->bf16 casts "
        f"launched by the profiled contiguous step): " + "; ".join(lines))


def phase_restart(peaks: dict) -> dict:
    """The restart of gpt3-1b (checkpoint manager, supervisor) and the
    audit of the pipelined step.  ``peaks``: the peak allocated GiB above
    the run's baseline of phase 4's gspmd run and phase 5's RESUME_SCHEDULE
    run.  Returns the
    launches of the restart's main runs."""
    cfg = _gpt3_1b()
    torch.cuda.empty_cache()
    counts = _restart(cfg, peaks)
    torch.cuda.empty_cache()
    _audit(cfg)
    return counts


# ------------------------------------------------------------------ 7. moe
MOE_LAYERS = 3                  # deepseek-moe-16b: dense0 + 2 MoE layers
QWEN_MOE_LAYERS = 2
MOE_NONUNIFORM = (384, 256, 128, 640, 640)   # multiples of moe_block (128)
MOE_SCHEDULES = ("contiguous", "1f1b")
MOE_PROMPT = (2, 1024)          # qwen3-moe prefill: batch x tokens
MOE_DECODE_STEPS = 16
MOE_MAX_LEN = 2048
LOGIT_REL_BOUND = 5e-2          # as phase 3: kernels vs plain attention, bf16


def _checked(arch: str, want: dict, layers: int):
    """``arch``'s FULL config, its widths checked, cut to ``layers`` layers."""
    cfg = get_config(arch)
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise AssertionError(f"{arch} FULL changed: {got} != {want}")
    return cfg.replace(n_layers=layers)


def _deepseek():
    return _checked("deepseek-moe-16b", dict(
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, hd=128, d_ff=11264,
        vocab_size=102400, n_experts=64, moe_top_k=6, d_expert=1408, n_shared_experts=2,
        moe_block=128, capacity_factor=1.25, dtype=torch.bfloat16, remat=True), MOE_LAYERS)


def _qwen3_moe():
    return _checked("qwen3-moe-235b-a22b", dict(
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, hd=128, qk_norm=True,
        vocab_size=151936, n_experts=128, moe_top_k=8, d_expert=1536, n_shared_experts=0,
        moe_block=128, capacity_factor=1.25, dtype=torch.bfloat16), QWEN_MOE_LAYERS)


def _repeats(cfg, tag: str) -> None:
    """Two gspmd value-and-grad calls at the training shape from the same
    state: loss and every gradient leaf bit-equal (deepseek: the dispatch's
    backward is a gather, the combine a sum over the k choices, so no
    atomics; mamba2: the chunk scan is a fixed loop of matmuls)."""
    model = build_model(cfg.replace(use_kernel=True))
    params = tree_map(lambda p: p.requires_grad_(True), model.init(seed=0))
    toks = DataPipeline(SyntheticSource(cfg.vocab_size, 0), TRAIN_BATCH, TRAIN_SEQ).batch_at(0)
    batch = {k: torch.from_numpy(a).cuda() for k, a in toks.items()}
    vg = value_and_grad(model.loss)
    first = vg(params, batch)
    first = (first[0], list(tree_leaves(first[1])))
    second = vg(params, batch)
    differ = [name for (name, _), a, b in zip(tree_items(params), first[1],
                                                tree_leaves(second[1])) if not torch.equal(a, b)]
    if not torch.equal(first[0], second[0]) or differ:
        raise AssertionError(f"{cfg.name} gspmd step does not repeat: loss {first[0].item()} vs "
                             f"{second[0].item()}, leaves differing: {differ}")
    log(f"[{tag}] {cfg.name}, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, use_kernel: two gspmd "
        f"value-and-grad calls from one state agree bit for bit (loss and all "
        f"{len(first[1])} gradient leaves)")


def _drop_sources(cfg) -> None:
    """Where the routing drops come from at init: the share of the first
    MoE layer's (token, choice) pairs past capacity at the training batch,
    for its real input, for that input less its mean over every token, and
    for i.i.d. normal input of the same rms."""
    model = build_model(cfg.replace(use_kernel=True))
    params = model.init(seed=0)
    toks = DataPipeline(SyntheticSource(cfg.vocab_size, 0), TRAIN_BATCH, TRAIN_SEQ).batch_at(0)
    shares = {}
    with torch.no_grad():
        x = model.embed(params, {"tokens": torch.from_numpy(toks["tokens"]).cuda()})
        for g in model.groups[:-1]:
            for bp in lm._unstack(params["groups"][g.name]):
                x = g.full(bp, x)
        bp = lm._unstack(params["groups"][model.groups[-1].name])[0]
        x = x + attention.attn_full(bp["attn"], cfg, rms_norm(x, bp["ln_attn"]))
        x = rms_norm(x, bp["ln_ffn"])
        mean = x.float().mean((0, 1), keepdim=True)
        rms = x.float().pow(2).mean().sqrt()
        gen = torch.Generator(device="cuda").manual_seed(5)
        for name, xi in (("input", x), ("input less its token mean", x - mean.to(x.dtype)),
                         ("i.i.d. normal", (torch.randn(x.shape, generator=gen, device="cuda")
                                            * rms).to(x.dtype))):
            moe.ROUTING_LOG = []
            try:
                moe.moe_ffn(bp["moe"], cfg, xi)
                ((_, _, keep, _),) = moe.ROUTING_LOG
            finally:
                moe.ROUTING_LOG = None
            shares[name] = (~keep).float().mean().item()
    log(f"[moe] {cfg.name}, first MoE layer at init, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}: "
        f"drop share " + ", ".join(f"{k} {v:.4%}" for k, v in shares.items())
        + f"; |token mean| / rms of the input {(mean.norm() / (rms * x.shape[-1] ** 0.5)).item():.3f}")


def _row_routes(routes: list, n_layers: int, b: int) -> list:
    """From an inference run's ``moe.ROUTING_LOG`` (prefill, then each
    decode step, ``n_layers`` calls each): per compared step, per row, the
    experts chosen for the row's last token and which of them kept their
    capacity slot, over every layer."""
    out = []
    for i in range(0, len(routes), n_layers):
        rows = []
        for r in range(b):
            sig = []
            for _, topi, keep, _ in routes[i:i + n_layers]:
                g = (r + 1) * (topi.shape[0] // b) - 1     # the row's last group
                sig += [topi[g, -1], keep[g].reshape(topi.shape[1], -1)[-1]]
            rows.append(sig)
        out.append(rows)
    return out


def _moe_inference(cfg) -> dict:
    """qwen3-moe at full width: Model.prefill of MOE_PROMPT tokens, then
    MOE_DECODE_STEPS greedy decode_steps, through the kernels (the counted
    run) and through the plain path on the kernel path's tokens.  Each
    compared row (the prompt's last token, then each decoded one) whose
    routing is the same on both paths in every layer (experts and capacity
    slots) must agree within LOGIT_REL_BOUND; a row whose routing differs
    (routing is discontinuous, and bf16 attention moves near-ties) is
    counted and its error printed.  A greedy token may differ only where
    the plain path's top-2 margin is within twice the row's logit
    difference.  Returns the kernel run's launches."""
    model = build_model(cfg.replace(use_kernel=True))
    plain = build_model(cfg)
    t0 = time.time()
    params32 = model.init(seed=0)
    # the bf16 paths cast every weight to bf16 at each use, so holding them
    # in bf16 gives the same numbers in half the memory
    params = tree_map(lambda a: a.to(torch.bfloat16), params32)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[moe] {cfg.name} FULL width, {cfg.n_layers} of 94 layers: {n_params / 1e9:.3f} B "
        f"parameters, {n_params * 2 / 1e9:.2f} GB in bf16; init {time.time() - t0:.1f} s")
    b, n = MOE_PROMPT
    gen = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (b, n), generator=gen, device="cuda")

    @torch.no_grad()
    def generate(m, forced=None, params=params):
        moe.ROUTING_LOG = []
        times = []
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            logits, caches = m.prefill(params, {"tokens": toks}, MOE_MAX_LEN)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            out, nxt = [logits[:, -1]], []
            for i in range(MOE_DECODE_STEPS):
                nxt.append(forced[i] if forced is not None else out[-1].argmax(-1))
                t0 = time.time()
                step, caches = m.decode_step(params, caches, {"tokens": nxt[-1][:, None]}, n + i)
                torch.cuda.synchronize()
                times.append(time.time() - t0)
                out.append(step[:, -1])
            routes = moe.ROUTING_LOG
        finally:
            moe.ROUTING_LOG = None
        return out, nxt, times, routes

    for fn in COUNTERS.values():
        fn.launches = 0
    out_k, tok_k, times_k, routes_k = generate(model)
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    want = {"terapipe_attention_fwd": cfg.n_layers,
            "decode_attention": cfg.n_layers * MOE_DECODE_STEPS}
    if {k: v for k, v in counts.items() if v} != want:
        raise AssertionError(f"{cfg.name} inference: launches {counts} != {want}")
    out_p, _, times_p, routes_p = generate(plain, forced=tok_k)
    # the anchor: the plain path in float32 on the same tokens
    plain32 = build_model(cfg.replace(dtype=torch.float32))
    out_32, _, _, routes_32 = generate(plain32, forced=tok_k, params=params32)
    del params32
    same_k, same_p, same_32 = (_row_routes(r, cfg.n_layers, b)
                               for r in (routes_k, routes_p, routes_32))
    alike = lambda u, w: all(torch.equal(x, y) for x, y in zip(u, w))
    rel = lambda u, w: ((u - w).abs().max() / w.abs().max()).item()
    worst, worst_rerouted, rerouted, flips = 0.0, 0.0, 0, 0
    k32, p32 = [], []          # rows routed alike on all three paths
    for i, (a, p, f) in enumerate(zip(out_k, out_p, out_32)):
        if not torch.isfinite(a).all() or a.shape != (b, cfg.vocab_size):
            raise AssertionError(f"{cfg.name} step {i}: non-finite or misshapen logits")
        top2 = p.topk(2, dim=-1).values
        for r in range(b):
            diff = (a[r] - p[r]).abs().max()
            if alike(same_k[i][r], same_p[i][r]):
                worst = max(worst, rel(a[r], p[r]))
                if alike(same_k[i][r], same_32[i][r]):
                    k32.append(rel(a[r], f[r]))
                    p32.append(rel(p[r], f[r]))
            else:
                rerouted += 1
                worst_rerouted = max(worst_rerouted, rel(a[r], p[r]))
            if a[r].argmax() != p[r].argmax():
                flips += 1
                if top2[r, 0] - top2[r, 1] > 2 * diff:
                    raise AssertionError(f"{cfg.name} step {i} row {r}: greedy tokens differ "
                                         f"at a top-2 margin {(top2[r, 0] - top2[r, 1]).item():.4g}"
                                         f" beyond twice the logits' difference {diff.item():.4g}")
    dropped = sum(int((~keep).sum()) for _, _, keep, _ in routes_k)
    total = sum(keep.numel() for _, _, keep, _ in routes_k)
    rows = b * len(out_k)
    log(f"[moe] {_card()}; {cfg.name} inference, prefill {b} x {n} then {MOE_DECODE_STEPS} "
        f"greedy decode steps (cache {MOE_MAX_LEN}), kernels vs plain attention on the same "
        f"tokens: max abs logit err / max |logit| per row, worst {worst:.3g} over the "
        f"{rows - rerouted} of {rows} rows routed alike (bound {LOGIT_REL_BOUND}); {rerouted} "
        f"rows routed differently in some layer, worst {worst_rerouted:.3g}; against the "
        f"plain f32 path on the {len(k32)} rows routed alike on all three: kernels worst "
        f"{max(k32, default=0.0):.3g}, plain bf16 worst {max(p32, default=0.0):.3g}; greedy tokens "
        f"differ at {flips} of {rows} (each within a top-2 margin of twice its row's logit "
        f"difference); prefill {times_k[0] * 1e3:.1f} ms (plain {times_p[0] * 1e3:.1f}), "
        f"decode step median {statistics.median(times_k[1:]) * 1e3:.2f} ms (plain "
        f"{statistics.median(times_p[1:]) * 1e3:.2f}); routing drops of the kernel run "
        f"{dropped} of {total}; launches {counts}")
    if worst > LOGIT_REL_BOUND:
        raise AssertionError(f"{cfg.name} inference: kernels and plain path disagree ({worst:.3g})")
    del params
    return counts


def phase_moe() -> dict:
    """The MoE family at full width: deepseek-moe-16b (MOE_LAYERS layers)
    trained through launch.train (gspmd, and the pipelined step with dense0
    as a pre-group under MOE_SCHEDULES), with the parity and determinism
    checks; then qwen3-moe-235b-a22b (QWEN_MOE_LAYERS layers) prefill and
    decode.  Returns the launches of its main runs."""
    cfg = _deepseek()
    get_config_full = train_launch.get_config
    train_launch.get_config = lambda arch, smoke: get_config_full(arch, smoke).replace(
        n_layers=MOE_LAYERS)
    counts, runs = {}, {}
    try:
        torch.cuda.empty_cache()
        parity = {f"{s}, K {PIPE_RANKS}, M {PIPE_SLICES}": TeraPipeConfig(
            n_token_slices=PIPE_SLICES, schedule=s) for s in MOE_SCHEDULES}
        parity[f"contiguous, K {PIPE_RANKS}, slices {list(MOE_NONUNIFORM)}"] = TeraPipeConfig(
            slice_lens=MOE_NONUNIFORM)
        n_params = _check_train_against_plain(cfg, parity, gspmd=True)
        log(f"[moe] {cfg.name} FULL width, {MOE_LAYERS} of 28 layers (dense0 + "
            f"{MOE_LAYERS - 1} MoE): {n_params / 1e9:.3f} B parameters")
        torch.cuda.empty_cache()
        _repeats(cfg, "moe")
        torch.cuda.empty_cache()
        _drop_sources(cfg)
        torch.cuda.empty_cache()
        argv = [a if a != "gpt3-1b" else "deepseek-moe-16b" for a in TRAIN_ARGV]
        counts["deepseek gspmd"], runs["gspmd"] = _train_run(
            cfg, argv, "moe gspmd", _launches_per_step(cfg, 1))
        torch.cuda.empty_cache()
        for schedule in MOE_SCHEDULES:
            model = build_model(cfg)
            plan = make_terapipe_value_and_grad(model, TeraPipeConfig(
                n_token_slices=PIPE_SLICES, schedule=schedule), TRAIN_SEQ, TRAIN_BATCH,
                PIPE_RANKS).plan
            log(f"[moe] {schedule}: pre-groups {[g.name for g in plan.pre]} before the "
                f"pipeline; {plan.main.name} layers per (rank, chunk) " + ", ".join(
                    f"{kv}: [{lo}, {hi})" + (" pad rows only" if lo == hi else "")
                    for kv, (lo, hi) in sorted(plan.rows.items())))
            del model, plan
            counts[f"deepseek {schedule}"], runs[schedule] = _train_run(
                cfg, argv + ["--mode", "terapipe", "--token-slices", str(PIPE_SLICES),
                             "--schedule", schedule],
                f"moe {schedule}", _launches_per_step(cfg, PIPE_SLICES, schedule, pre_layers=1),
                steps=PIPE_STEPS)
            torch.cuda.empty_cache()
    finally:
        train_launch.get_config = get_config_full
    per_step = {k: {n: c // (TRAIN_STEPS if k.endswith("gspmd") else PIPE_STEPS)
                    for n, c in v.items()} for k, v in counts.items()}
    log(f"[moe] {_card()}; {cfg.name} FULL width, {MOE_LAYERS} layers, batch {TRAIN_BATCH} x "
        f"seq {TRAIN_SEQ}, --use-kernel: " + "; ".join(
            f"{s} {m['step_ms']:.1f} ms/step, {m['tok_s']:.0f} tok/s, peak "
            f"{m['peak_gib'] - m['base_gib']:.2f} GiB above the {m['base_gib']:.2f} GiB "
            f"baseline, drops {max(m['drop_share']):.4%} at most, launches per step "
            f"{per_step['deepseek ' + s]}" for s, m in runs.items()))
    torch.cuda.empty_cache()
    counts["qwen3-moe inference"] = _moe_inference(_qwen3_moe())
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------- 8. state
MAMBA_LAYERS = 40               # mamba2-2.7b: 40 of 64 layers (AdamW's 7 f32 copies fit)
RG_LAYERS = 14                  # recurrentgemma-9b: 4 x (rec, rec, attn) + the 2-block tail
RG_BATCH, RG_SEQ = 2, 4096      # above the 2048 window, so that it masks
RG_PROMPT = (2, 3072)           # recurrentgemma prefill: batch x tokens
RG_MAX_LEN = 3200
RG_DECODE_STEPS = 64


def _mamba2():
    return _checked("mamba2-2.7b", dict(
        n_layers=64, d_model=2560, ssm_expand=2, ssm_head_dim=64, ssm_state=128, ssm_conv=4,
        ssm_chunk=256, vocab_size=50280, tie_embeddings=False, dtype=torch.bfloat16,
        remat=True), MAMBA_LAYERS)


def _recurrentgemma():
    return _checked("recurrentgemma-9b", dict(
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, hd=256, d_ff=12288,
        vocab_size=256000, window=2048, block_pattern=("rec", "rec", "attn"), rglru_conv=4,
        tie_embeddings=False, dtype=torch.bfloat16, remat=True), RG_LAYERS)


def _no_launches(what: str) -> dict:
    """The launch counts since they were set to 0, which must all be 0 on a
    path that reaches none of the kernels."""
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    if any(counts.values()):
        raise AssertionError(f"{what}: launched {counts}, a path without the kernels")
    return counts


def _timed_vg(model, make_vg, label: str) -> dict:
    """``make_vg(model)`` at batch RG_BATCH x RG_SEQ from one seeded init:
    one warm-up call, then one timed call with every launch counter set to 0
    just before; its ms, loss and peak allocated memory above the baseline
    before it."""
    vg = make_vg(model)
    params = tree_map(lambda p: p.requires_grad_(True), model.init(seed=0))
    toks = DataPipeline(SyntheticSource(model.cfg.vocab_size, 0), RG_BATCH,
                        RG_SEQ).batch_at(0)
    batch = {k: torch.from_numpy(a).cuda() for k, a in toks.items()}
    vg(params, batch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.time()
    loss, grads = vg(params, batch)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    counts = _no_launches(label)
    if not (torch.isfinite(loss) and all(torch.isfinite(g).all() for g in tree_leaves(grads))):
        raise AssertionError(f"{label}: non-finite loss or gradients")
    out = {"ms": ms, "loss": loss.item(), "base_gib": base / 2**30, "counts": counts,
           "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
    log(f"[state] {model.cfg.name} {label}, batch {RG_BATCH} x seq {RG_SEQ}: loss "
        f"{out['loss']:.6f}, {ms:.1f} ms per value-and-grad call (after one warm-up call), "
        f"peak allocated {out['peak_gib']:.2f} GiB above the {out['base_gib']:.2f} GiB "
        f"baseline; launches {counts}")
    return out


def _rg_inference(cfg) -> dict:
    """Model.prefill of RG_PROMPT tokens into RG_MAX_LEN, then
    RG_DECODE_STEPS greedy decode_steps through the windowed ring (RG_MAX_LEN
    rows, above the window); every decode logit row held to Model.forward of
    the same tokens within LOGIT_REL_BOUND (max abs err / max |logit|)."""
    model = build_model(cfg)
    # the bf16 path casts every weight to bf16 at each use, so holding them
    # in bf16 gives the same numbers in half the memory
    params = tree_map(lambda a: a.to(torch.bfloat16), model.init(seed=0))
    b, n = RG_PROMPT
    gen = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (b, n), generator=gen, device="cuda")
    for fn in COUNTERS.values():
        fn.launches = 0
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.time()
        logits, caches = model.prefill(params, {"tokens": toks}, RG_MAX_LEN)
        torch.cuda.synchronize()
        prefill_ms = (time.time() - t0) * 1e3
        ring_rows = caches[0][1][0].shape[2]
        out, nxt, times = [logits[:, -1]], [], []
        for i in range(RG_DECODE_STEPS):
            nxt.append(out[-1].argmax(-1))
            t0 = time.time()
            step, caches = model.decode_step(params, caches, {"tokens": nxt[-1][:, None]}, n + i)
            torch.cuda.synchronize()
            times.append((time.time() - t0) * 1e3)
            out.append(step[:, -1])
        counts = _no_launches(f"{cfg.name} inference")
        full = model.forward(params, {"tokens": torch.cat([toks, torch.stack(nxt, 1)], 1)})
    worst = 0.0
    for i, a in enumerate(out):
        if not torch.isfinite(a).all() or a.shape != (b, cfg.vocab_size):
            raise AssertionError(f"{cfg.name} step {i}: non-finite or misshapen logits")
        want = full[:, n - 1 + i]
        for r in range(b):
            worst = max(worst, ((a[r] - want[r]).abs().max() / want[r].abs().max()).item())
    flips = sum(int((a.argmax(-1) != full[:, n - 1 + i].argmax(-1)).sum())
                for i, a in enumerate(out))
    log(f"[state] {_card()}; {cfg.name} inference, prefill {b} x {n} into {RG_MAX_LEN} "
        f"(KV ring of {ring_rows} rows, window {cfg.window}) then {RG_DECODE_STEPS} greedy "
        f"decode steps through the ring, against Model.forward of the same {n + RG_DECODE_STEPS}"
        f" tokens: max abs logit err / max |logit| per row, worst {worst:.3g} over "
        f"{b * len(out)} rows (bound {LOGIT_REL_BOUND}); argmax differs at {flips}; prefill "
        f"{prefill_ms:.1f} ms, decode step median {statistics.median(times):.2f} ms; "
        f"launches {counts}")
    if ring_rows != RG_MAX_LEN or worst > LOGIT_REL_BOUND:
        raise AssertionError(f"{cfg.name} inference: the decode does not continue the forward "
                             f"({worst:.3g}) or the ring has {ring_rows} rows")
    del params, caches, full
    return counts


def phase_state() -> dict:
    """The state-carrying families at full width.  mamba2-2.7b (MAMBA_LAYERS
    layers): parity in bf16 against f32 under gspmd and the pipelined step
    (contiguous and interleaved V 2), two gspmd calls bit-equal, then
    TRAIN_STEPS gspmd and PIPE_STEPS contiguous steps through launch.train.
    recurrentgemma-9b (RG_LAYERS layers, the tail a post-group): parity at
    batch 1 x RG_SEQ, the gspmd and contiguous value-and-grad calls timed at
    RG_BATCH x RG_SEQ, then prefill and the ring decode against the forward.
    Neither family reaches the kernels: every count must stay 0.  Returns
    the counts of its main runs."""
    cfg = _mamba2()
    get_config_full = train_launch.get_config
    train_launch.get_config = lambda arch, smoke: get_config_full(arch, smoke).replace(
        n_layers=MAMBA_LAYERS)
    counts, runs = {}, {}
    try:
        torch.cuda.empty_cache()
        parity = {f"contiguous, K {PIPE_RANKS}, M {PIPE_SLICES}": TeraPipeConfig(
            n_token_slices=PIPE_SLICES),
            f"interleaved V 2, K {PIPE_RANKS}, M {PIPE_SLICES}": TeraPipeConfig(
            n_token_slices=PIPE_SLICES, virtual_stages=2)}
        n_params = _check_train_against_plain(cfg, parity, route="bf16")
        log(f"[state] {cfg.name} FULL width, {MAMBA_LAYERS} of 64 layers: "
            f"{n_params / 1e9:.3f} B parameters (the plain bf16 run is the gspmd step)")
        torch.cuda.empty_cache()
        _repeats(cfg, "state")
        torch.cuda.empty_cache()
        argv = [a if a != "gpt3-1b" else "mamba2-2.7b" for a in TRAIN_ARGV]
        counts["mamba2 gspmd"], runs["gspmd"] = _train_run(cfg, argv, "state gspmd", {})
        torch.cuda.empty_cache()
        counts["mamba2 contiguous"], runs["contiguous"] = _train_run(
            cfg, argv + ["--mode", "terapipe", "--token-slices", str(PIPE_SLICES)],
            "state contiguous", {}, steps=PIPE_STEPS)
        torch.cuda.empty_cache()
    finally:
        train_launch.get_config = get_config_full
    log(f"[state] {_card()}; {cfg.name} FULL width, {MAMBA_LAYERS} layers, batch {TRAIN_BATCH}"
        f" x seq {TRAIN_SEQ}: " + "; ".join(
            f"{s} {m['step_ms']:.1f} ms/step, {m['tok_s']:.0f} tok/s, peak "
            f"{m['peak_gib'] - m['base_gib']:.2f} GiB above the {m['base_gib']:.2f} GiB "
            f"baseline, launches per step 0" for s, m in runs.items()))

    cfg = _recurrentgemma()
    torch.cuda.empty_cache()
    contiguous = TeraPipeConfig(n_token_slices=PIPE_SLICES)
    n_params = _check_train_against_plain(
        cfg, {f"contiguous, K {PIPE_RANKS}, M {PIPE_SLICES}, tail as post-group": contiguous},
        seq=RG_SEQ, route="bf16")
    torch.cuda.empty_cache()
    model = build_model(cfg)
    plan = make_terapipe_value_and_grad(model, contiguous, RG_SEQ, RG_BATCH, PIPE_RANKS).plan
    if [g.name for g in plan.post] != ["tail"] or plan.main.name != "super":
        raise AssertionError(f"{cfg.name}: pipeline split {plan.pre}, {plan.main.name}, "
                             f"{[g.name for g in plan.post]}")
    del plan
    gspmd = _timed_vg(model, lambda m: value_and_grad(m.loss), "gspmd")
    torch.cuda.empty_cache()
    piped = _timed_vg(model, lambda m: make_terapipe_value_and_grad(
        m, contiguous, RG_SEQ, RG_BATCH, PIPE_RANKS),
        f"contiguous K {PIPE_RANKS}, M {PIPE_SLICES}, tail as post-group")
    torch.cuda.empty_cache()
    rel_loss = abs(piped["loss"] - gspmd["loss"]) / abs(gspmd["loss"])
    counts["recurrentgemma gspmd"] = gspmd["counts"]
    counts["recurrentgemma contiguous"] = piped["counts"]
    counts["recurrentgemma inference"] = _rg_inference(cfg)
    torch.cuda.empty_cache()
    log(f"[state] {_card()}; {cfg.name} FULL width, {RG_LAYERS} of 38 layers "
        f"({n_params / 1e9:.3f} B parameters), batch {RG_BATCH} x seq {RG_SEQ}: gspmd "
        f"{gspmd['ms']:.1f} ms per value-and-grad call, peak {gspmd['peak_gib']:.2f} GiB; "
        f"contiguous {piped['ms']:.1f} ms, peak {piped['peak_gib']:.2f} GiB; losses relative "
        f"{rel_loss:.3g} (bound {LOSS_REL_BOUND}); no AdamW steps (7 f32 copies of "
        f"{n_params / 1e9:.3f} B parameters would be {7 * 4 * n_params / 1e9:.0f} GB)")
    if rel_loss > LOSS_REL_BOUND:
        raise AssertionError(f"{cfg.name}: pipelined loss off the gspmd loss ({rel_loss:.3g})")
    return counts


# ----------------------------------------------------------- 8b. families
VLM_LAYERS = 12                 # phi-3-vision-4.2b: 12 of 32 layers (AdamW's 7 f32 copies fit)
# fixed non-uniform slices of patches + text for the parity check: slices 0
# and 1 hold only patch rows, slice 2 straddles the last one (row 575), and
# ctx 840 is off the kernels' 64-row tiles
VLM_NONUNIFORM = (256, 256, 328, 504, 704)
VLM_MAX_LEN = 2112              # the prefill's cache: 2048 positions + 64
VLM_DECODE_STEPS = 16
WHISPER_FRAMES = 1500           # whisper's 30 s window: 1500 encoder frames
WHISPER_PROMPT = 64
WHISPER_MAX_LEN = 448           # whisper's text context
WHISPER_DECODE_STEPS = 32


def _phi3_vision():
    return _checked("phi-3-vision-4.2b", dict(
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, hd=96, d_ff=8192,
        vocab_size=32064, n_patches=576, tie_embeddings=False, dtype=torch.bfloat16,
        remat=True), VLM_LAYERS)


def _whisper():
    return _checked("whisper-medium", dict(
        n_layers=24, n_enc_layers=24, n_dec_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=16, hd=64, d_ff=4096, vocab_size=51865, tie_embeddings=False,
        dtype=torch.bfloat16, remat=True), 24)


def _family_inference(cfg, prompt: dict, max_len: int, steps: int, pos0: int,
                      launches: dict) -> dict:
    """Model.prefill of ``prompt`` into ``max_len`` rows, then ``steps``
    greedy decode_steps at positions ``pos0``, ``pos0 + 1``, ... through the
    kernels (once to warm up, then the counted run: ``launches`` exactly),
    then the plain path on the kernel path's tokens.  Every logit row (the prompt's last, then
    each decoded one) within LOGIT_REL_BOUND of the plain path's (max abs
    err / max |logit|); a greedy token may differ only where the plain
    path's top-2 margin is within twice the row's logit difference.
    Returns the kernel run's launches."""
    model = build_model(cfg.replace(use_kernel=True))
    plain = build_model(cfg)
    # the bf16 paths cast every weight to bf16 at each use, so holding them
    # in bf16 gives the same numbers in half the memory
    params = tree_map(lambda a: a.to(torch.bfloat16), model.init(seed=0))
    b = prompt["tokens"].shape[0]

    @torch.no_grad()
    def generate(m, forced=None):
        times = []
        torch.cuda.synchronize()
        t0 = time.time()
        logits, caches = m.prefill(params, prompt, max_len)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        out, nxt = [logits[:, -1]], []
        for i in range(steps):
            nxt.append(forced[i] if forced is not None else out[-1].argmax(-1))
            t0 = time.time()
            step, caches = m.decode_step(params, caches, {"tokens": nxt[-1][:, None]}, pos0 + i)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            out.append(step[:, -1])
        return out, nxt, times

    generate(model)
    for fn in COUNTERS.values():
        fn.launches = 0
    out_k, tok_k, times_k = generate(model)
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    if {k: v for k, v in counts.items() if v} != launches:
        raise AssertionError(f"{cfg.name} inference: launches {counts} != {launches}")
    out_p, _, times_p = generate(plain, forced=tok_k)
    worst, flips = 0.0, 0
    for i, (a, p) in enumerate(zip(out_k, out_p)):
        if not torch.isfinite(a).all() or a.shape != (b, cfg.vocab_size):
            raise AssertionError(f"{cfg.name} step {i}: non-finite or misshapen logits")
        top2 = p.topk(2, dim=-1).values
        for r in range(b):
            diff = (a[r] - p[r]).abs().max()
            worst = max(worst, (diff / p[r].abs().max()).item())
            if a[r].argmax() != p[r].argmax():
                flips += 1
                if top2[r, 0] - top2[r, 1] > 2 * diff:
                    raise AssertionError(f"{cfg.name} step {i} row {r}: greedy tokens differ "
                                         f"at a top-2 margin beyond twice the logits' "
                                         f"difference {diff.item():.4g}")
    shape = " + ".join(f"{k} {tuple(v.shape)}" for k, v in prompt.items())
    log(f"[families] {_card()}; {cfg.name} inference, prefill of {shape} into {max_len} rows "
        f"then {steps} greedy decode steps, kernels vs plain attention on the same tokens: "
        f"max abs logit err / max |logit| per row, worst {worst:.3g} over "
        f"{b * len(out_k)} rows (bound {LOGIT_REL_BOUND}); greedy tokens differ at {flips}; "
        f"prefill {times_k[0] * 1e3:.1f} ms (plain {times_p[0] * 1e3:.1f}), decode step "
        f"median {statistics.median(times_k[1:]) * 1e3:.2f} ms (plain "
        f"{statistics.median(times_p[1:]) * 1e3:.2f}); launches {counts}")
    if worst > LOGIT_REL_BOUND:
        raise AssertionError(f"{cfg.name} inference: kernels and plain path disagree ({worst:.3g})")
    del params
    return counts


def _dots_vs_full(cfg) -> dict:
    """The gspmd value-and-grad at batch 1 and TRAIN_BATCH x TRAIN_SEQ under
    remat_policy "full" and "dots" from one seeded init: one warm-up call,
    then one timed call each (launches exact); the loss and every gradient
    leaf must be bit-equal.  Returns the timed calls' launches."""
    per_call = _launches_per_step(cfg, 1)
    counts = {}
    for b in (1, TRAIN_BATCH):
        toks = train_launch.make_data(cfg, b, TRAIN_SEQ, 1).batch_at(0)
        batch = {k: torch.from_numpy(a).cuda() for k, a in toks.items()}
        runs = {}
        for policy in ("full", "dots"):
            model = build_model(cfg.replace(use_kernel=True, remat_policy=policy))
            params = tree_map(lambda p: p.requires_grad_(True), model.init(seed=0))
            vg = value_and_grad(model.loss)
            vg(params, batch)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for fn in COUNTERS.values():
                fn.launches = 0
            t0 = time.time()
            loss, grads = vg(params, batch)
            torch.cuda.synchronize()
            ms = (time.time() - t0) * 1e3
            counts[f"phi-3-vision remat {policy}, batch {b}"] = got = {
                name: fn.launches for name, fn in COUNTERS.items()}
            if got != {k: per_call.get(k, 0) for k in COUNTERS}:
                raise AssertionError(f"dots: {policy} launches {got} != {per_call}")
            runs[policy] = (loss, list(tree_leaves(grads)), ms,
                            (torch.cuda.max_memory_allocated() - base) / 2**30, base / 2**30)
            del params, grads, model
            torch.cuda.empty_cache()
        (lf, gf, msf, pf, bf), (ld, gd, msd, pd, bd) = runs["full"], runs["dots"]
        differ = sum(not torch.equal(x, y) for x, y in zip(gd, gf))
        log(f"[families] {_card()}; {cfg.name} FULL width, {cfg.n_layers} layers, gspmd "
            f"value-and-grad at batch {b} x seq {TRAIN_SEQ}, remat_policy full vs dots: loss "
            f"{lf.item():.6f} vs {ld.item():.6f}, {differ} of {len(gf)} gradient leaves "
            f"differ; full {msf:.1f} ms, peak {pf:.2f} GiB above the {bf:.2f} GiB baseline; "
            f"dots {msd:.1f} ms, peak {pd:.2f} GiB above {bd:.2f} (the full run's gradients "
            f"held); launches per call {per_call}")
        if not torch.equal(ld, lf) or differ:
            raise AssertionError(f"dots: loss or {differ} gradient leaves not bit-equal to full")
        del runs, gf, gd
        torch.cuda.empty_cache()
    return counts


def phase_families() -> dict:
    """The vlm and enc-dec families at full width.  phi-3-vision-4.2b
    (VLM_LAYERS layers, 576 patch rows + 1472 text tokens): parity at batch
    1 x TRAIN_SEQ under gspmd, contiguous M 8 and VLM_NONUNIFORM, then
    TRAIN_STEPS gspmd and PIPE_STEPS contiguous steps through launch.train,
    prefill and decode against the plain path, and the dots remat policy
    against the full one.  whisper-medium (24 + 24 layers): parity under
    gspmd, TRAIN_STEPS gspmd steps, --mode terapipe refused, prefill of
    WHISPER_FRAMES frames and decode against the plain path; only the
    decoder's self-attention reaches the kernels.  Returns the counts of
    its main runs."""
    counts, runs = {}, {}
    cfg = _phi3_vision()
    get_config_full = train_launch.get_config
    train_launch.get_config = lambda arch, smoke: get_config_full(arch, smoke).replace(
        n_layers=VLM_LAYERS)
    try:
        torch.cuda.empty_cache()
        parity = {f"contiguous, K {PIPE_RANKS}, M {PIPE_SLICES}": TeraPipeConfig(
            n_token_slices=PIPE_SLICES),
            f"contiguous, K {PIPE_RANKS}, slices {list(VLM_NONUNIFORM)}": TeraPipeConfig(
            slice_lens=VLM_NONUNIFORM)}
        n_params = {"phi-3-vision": _check_train_against_plain(cfg, parity, gspmd=True)}
        log(f"[families] {cfg.name} FULL width, {VLM_LAYERS} of 32 layers: "
            f"{n_params['phi-3-vision'] / 1e9:.3f} B parameters; {cfg.n_patches} patch rows + "
            f"{TRAIN_SEQ - cfg.n_patches} text tokens per sequence")
        torch.cuda.empty_cache()
        argv = [a if a != "gpt3-1b" else "phi-3-vision-4.2b" for a in TRAIN_ARGV]
        counts["phi-3-vision gspmd"], runs["phi-3-vision gspmd"] = _train_run(
            cfg, argv, "families gspmd", _launches_per_step(cfg, 1))
        torch.cuda.empty_cache()
        counts["phi-3-vision contiguous"], runs["phi-3-vision contiguous"] = _train_run(
            cfg, argv + ["--mode", "terapipe", "--token-slices", str(PIPE_SLICES)],
            "families contiguous", _launches_per_step(cfg, PIPE_SLICES), steps=PIPE_STEPS)
        torch.cuda.empty_cache()
    finally:
        train_launch.get_config = get_config_full
    gen = torch.Generator(device="cuda").manual_seed(4)
    text = TRAIN_SEQ - cfg.n_patches
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (2, text), generator=gen,
                                      device="cuda"),
              "patch_embeds": torch.randn((2, cfg.n_patches, cfg.d_model), generator=gen,
                                          device="cuda")}
    counts["phi-3-vision inference"] = _family_inference(
        cfg, prompt, VLM_MAX_LEN, VLM_DECODE_STEPS, TRAIN_SEQ,
        {"terapipe_attention_fwd": cfg.n_layers,
         "decode_attention": cfg.n_layers * VLM_DECODE_STEPS})
    torch.cuda.empty_cache()
    counts.update(_dots_vs_full(cfg))
    torch.cuda.empty_cache()

    cfg = _whisper()
    n_params["whisper"] = _check_train_against_plain(cfg, gspmd=True)
    log(f"[families] {cfg.name} FULL width and depth, 24 encoder + 24 decoder layers: "
        f"{n_params['whisper'] / 1e9:.3f} B parameters; {TRAIN_SEQ} frames and {TRAIN_SEQ} "
        f"tokens per "
        f"sequence")
    torch.cuda.empty_cache()
    argv = [a if a != "gpt3-1b" else "whisper-medium" for a in TRAIN_ARGV]
    # the decoder's layers launch the kernels, the encoder and the
    # cross-attention none
    dec = cfg.replace(n_layers=cfg.n_dec_layers)
    counts["whisper gspmd"], runs["whisper gspmd"] = _train_run(
        cfg, argv, "families gspmd", _launches_per_step(dec, 1))
    torch.cuda.empty_cache()
    try:
        train_launch.main(argv + ["--steps", "1", "--mode", "terapipe"])
    except NotImplementedError as e:
        log(f"[families] {cfg.name} --mode terapipe refused, as the reference: {e}")
    else:
        raise AssertionError(f"{cfg.name}: --mode terapipe was not refused")
    torch.cuda.empty_cache()
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (2, WHISPER_PROMPT), generator=gen,
                                      device="cuda"),
              "frames": torch.randn((2, WHISPER_FRAMES, cfg.d_model), generator=gen,
                                    device="cuda")}
    counts["whisper inference"] = _family_inference(
        cfg, prompt, WHISPER_MAX_LEN, WHISPER_DECODE_STEPS, WHISPER_PROMPT,
        {"terapipe_attention_fwd": dec.n_layers,
         "decode_attention": dec.n_layers * WHISPER_DECODE_STEPS})
    torch.cuda.empty_cache()
    log(f"[families] {_card()}; batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, --use-kernel: " + "; ".join(
        f"{s} {m['step_ms']:.1f} ms/step, {m['tok_s']:.0f} positions/s, "
        f"peak {m['peak_gib'] - m['base_gib']:.2f} GiB above the {m['base_gib']:.2f} GiB "
        f"baseline" for s, m in runs.items()))
    return counts


# --------------------------------------------------------------- 8c. layout
#: the parameter counts (billions, 3 decimals) of the reference's
#: abstract_init of these FULL configs
REF_PARAMS_B = {"gpt3-1b": 1.817, "gpt3-175b": 233.166, "qwen3-moe-235b-a22b": 235.094,
                "deepseek-moe-16b": 16.378, "mamba2-2.7b": 2.831, "recurrentgemma-9b": 6.519,
                "whisper-medium": 1.012, "qwen3-0.6b": 0.596}
LAYOUT_STEPS = 3
LAYOUT_PROMPT = (2, 1024)       # qwen3-0.6b prefill: batch x tokens
LAYOUT_MAX_LEN = 2048
LAYOUT_DECODE_STEPS = 16
EF_ROUNDS = 3
#: the leaves whose compression the card and the host must agree on bit for bit
EF_LEAVES = ("/embed", "/groups/blocks/attn/wq", "/final_ln", "/lm_head")


def _gib(tree) -> float:
    return sum(t.numel() * t.element_size() for _, t in jax_items(tree)) / 2**30


def _abstract_structures() -> None:
    """abstract_init, abstract_opt_state, every (arch x SHAPES) cell's
    skip_reason or input_specs, and abstract_caches at the decode cells,
    for every FULL config, from models built on the card: nothing may be
    allocated."""
    before = torch.cuda.memory_allocated()
    t0 = time.time()
    lines, cells, skipped = [], 0, 0
    for arch in ARCHS + PAPER_ARCHS:
        cfg = get_config(arch)
        model = build_model(cfg)
        params, _ = abstract_init(model)
        opt_state = abstract_opt_state(adamw(1e-3), params)
        leaves = [t for _, t in jax_items(params) + jax_items(opt_state)]
        if not all(t.is_meta for t in leaves):
            raise AssertionError(f"{arch}: abstract_init or abstract_opt_state left the meta device")
        n = sum(t.numel() for t in tree_leaves(params))
        if arch in REF_PARAMS_B and round(n / 1e9, 3) != REF_PARAMS_B[arch]:
            raise AssertionError(f"{arch}: {n:,} parameters, the reference has "
                                 f"{REF_PARAMS_B[arch]} B")
        cache_gib = {}
        for name, shape in SHAPES.items():
            if skip_reason(arch, name) is not None:
                skipped += 1
                continue
            cells += 1
            batch = input_specs(cfg, shape)
            if not all(t.is_meta for t in batch.values()):
                raise AssertionError(f"{arch} x {name}: input_specs left the meta device")
            if shape.kind == "decode":
                caches = abstract_caches(model, shape.global_batch, shape.seq_len)
                if not all(t.is_meta for t in tree_leaves(caches)):
                    raise AssertionError(f"{arch} x {name}: abstract_caches left the meta device")
                cache_gib[name] = _gib(caches)
        lines.append(f"{arch} {n / 1e9:.3f} B ({_gib(params):.1f} GiB f32, AdamW state "
                     f"{_gib(opt_state):.1f} GiB; decode caches "
                     + ", ".join(f"{k} {v:.1f} GiB" for k, v in cache_gib.items()) + ")")
    after = torch.cuda.memory_allocated()
    log(f"[layout] abstract structures of {len(lines)} FULL configs, {cells} (arch x shape) "
        f"cells and {skipped} skipped, in {time.time() - t0:.2f} s: " + "; ".join(lines))
    log(f"[layout] memory_allocated {before} B before, {after} B after")
    if after != before:
        raise AssertionError(f"abstract structures allocated {after - before} B on the card")


def _train_step_vs_launcher(cfg) -> tuple:
    """LAYOUT_STEPS steps of make_train_step against launch.train.train_step
    (the gspmd mode) from one seeded init on the same batches, one run after
    the other: losses bit-equal, launches of the make_train_step run exact;
    each run's peak memory above what its state holds.  Returns its counts
    and the gradient tree of one more step at its final parameters (the
    moments freed first)."""
    model = build_model(cfg.replace(use_kernel=True))
    data = train_launch.make_data(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)
    batch = lambda i: {k: torch.from_numpy(a).cuda() for k, a in data.batch_at(i).items()}
    make_opt = lambda: adamw(cosine_schedule(3e-4, 1, LAYOUT_STEPS))
    peaks, peak_bytes = {}, {}

    def peak_above(label, base):
        torch.cuda.synchronize()
        peak_bytes[label] = torch.cuda.max_memory_allocated() - base
        peaks[label] = peak_bytes[label] / 2**30

    opt = make_opt()
    state = {"params": tree_map(lambda p: p.requires_grad_(True), model.init(seed=0))}
    state["opt_state"] = opt.init(state["params"])
    vg = value_and_grad(model.loss)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    want = [train_launch.train_step(vg, opt, state, batch(i)) for i in range(LAYOUT_STEPS)]
    peak_above("launch.train.train_step", base)
    del state
    torch.cuda.empty_cache()

    opt = make_opt()
    params = model.init(seed=0)
    opt_state = opt.init(params)
    step = make_train_step(model, opt)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    got = []
    for i in range(LAYOUT_STEPS):
        params, opt_state, loss = step(params, opt_state, batch(i))
        got.append(loss)
    torch.cuda.synchronize()
    ms = (time.time() - t0) / LAYOUT_STEPS * 1e3
    peak_above("make_train_step", base)
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    per_step = _launches_per_step(cfg, 1)
    want_counts = {k: per_step.get(k, 0) * LAYOUT_STEPS for k in COUNTERS}
    log(f"[layout] {_card()}; {cfg.name} FULL width, {cfg.n_layers} layers, batch "
        f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, bf16, kernels: make_train_step losses "
        f"{[x.item() for x in got]}, launch.train.train_step {[x.item() for x in want]}; "
        f"{ms:.1f} ms/step (host clock, all {LAYOUT_STEPS} steps); peak allocated above "
        f"the state's {base / 2**30:.2f} GiB: "
        + ", ".join(f"{k} {v:.2f} GiB" for k, v in peaks.items())
        + f"; launches {counts} (remat formula: {per_step} per step)")
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("make_train_step's losses are not bit-equal to launch.train's")
    if counts != want_counts:
        raise AssertionError(f"make_train_step launches {counts} != {want_counts}")
    del opt_state
    torch.cuda.empty_cache()
    params = tree_map(lambda p: p.requires_grad_(True), params)
    # one value-and-grad with its FLOPs counted (AdamW adds none), after the
    # peak was read and apart from the gradients compressed below:
    # FlopCounterMode decomposes some ops, which changes their values
    with _card_flops() as flops:
        vg(params, batch(LAYOUT_STEPS))
    CARD_STEPS["gspmd"] = {"counts": counts, "steps": LAYOUT_STEPS,
                           "peak_bytes": peak_bytes["make_train_step"], **flops}
    _, grads = vg(params, batch(LAYOUT_STEPS))
    del params
    torch.cuda.empty_cache()
    return counts, grads


def _compression(grads) -> None:
    """EF_ROUNDS rounds of int8 compression with error feedback over a
    gradient tree on the card: EF_LEAVES' q, scales and residual bit-equal
    to the same rounds on the host; the accumulated sent gradient within
    each leaf's largest residual of the accumulated true one; the bf16
    round trip within bf16's rounding and bit-equal to the host's."""
    n = sum(g.numel() for g in tree_leaves(grads))
    leaves = dict(tree_items(grads))
    host = {p: leaves[p].cpu() for p in EF_LEAVES}
    state, host_state = int8_ef_init(grads), int8_ef_init(host)
    total = tree_map(torch.zeros_like, grads)
    ms = []
    for r in range(EF_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.time()
        q, scales, state = int8_ef_compress(grads, state)
        sent = int8_ef_decompress(q, scales)
        torch.cuda.synchronize()
        ms.append((time.time() - t0) * 1e3)
        for t, s in zip(tree_leaves(total), tree_leaves(sent)):
            t.add_(s)
        del sent
        hq, hs, host_state = int8_ef_compress(host, host_state)
        qd, sd, rd = dict(tree_items(q)), dict(tree_items(scales)), dict(tree_items(state.residual))
        for p in EF_LEAVES:
            for what, card, h in (("q", qd[p], hq[p]), ("scale", sd[p], hs[p]),
                                  ("residual", rd[p], host_state.residual[p])):
                if not torch.equal(card.cpu(), h):
                    raise AssertionError(f"int8 round {r}: {p} {what} differs card vs host")
        del q, scales
    worst = 0.0
    for (p, t), g, res in zip(tree_items(total), tree_leaves(grads),
                              tree_leaves(state.residual)):
        err = (t - EF_ROUNDS * g).abs().max().item()
        bound = res.abs().max().item() + 1e-6
        worst = max(worst, err / bound)
        if err > bound:
            raise AssertionError(f"int8 error feedback: {p} drifts {err:.3g} > {bound:.3g}")
    del total, state
    torch.cuda.synchronize()
    t0 = time.time()
    back = bf16_decompress(bf16_compress(grads))
    torch.cuda.synchronize()
    bf16_ms = (time.time() - t0) * 1e3
    rel = max(((b - g).abs() / g.abs().clamp_min(1e-30)).max().item()
              for b, g in zip(tree_leaves(back), tree_leaves(grads)))
    host_back = bf16_decompress(bf16_compress(host))
    if not all(torch.equal(dict(tree_items(back))[p].cpu(), host_back[p]) for p in EF_LEAVES):
        raise AssertionError("bf16 round trip differs card vs host")
    # bytes per element, each input read once and each output written
    # once: compress reads g and the residual and writes q and the new
    # residual (4 + 4 + 1 + 4), decompress reads q and writes f32 (1 + 4);
    # the bf16 round trip reads 4 and writes 2, then reads 2 and writes 4
    ef_bound, bf16_bound = bound_ms(0.0, 18 * n)[0], bound_ms(0.0, 12 * n)[0]
    log(f"[layout] {_card()}; gradient compression of one gpt3-1b step's gradients ({n:,} "
        f"f32 values, {_gib(grads):.2f} GiB): int8 with error feedback "
        f"{', '.join(f'{x:.1f}' for x in ms)} ms per round (compress + decompress, host "
        f"clock; bound {ef_bound:.2f} ms by bytes); {len(EF_LEAVES)} leaves' q, scales and "
        f"residuals bit-equal to the host's "
        f"over {EF_ROUNDS} rounds; accumulated sent vs true gradient at most {worst:.3f} of "
        f"each leaf's largest residual; bf16 round trip {bf16_ms:.1f} ms (bound "
        f"{bf16_bound:.2f}), largest relative "
        f"error {rel:.3g} (bound 2^-8), bit-equal to the host's")
    if rel > 2 ** -8:
        raise AssertionError(f"bf16 round trip: relative error {rel:.3g}")


def _serve_steps(cfg) -> dict:
    """make_prefill_step of LAYOUT_PROMPT into LAYOUT_MAX_LEN rows, then
    LAYOUT_DECODE_STEPS greedy make_decode_step calls through the kernels:
    the caches' shapes and dtypes those of abstract_caches, launches exact
    (phase 3's formula: one prefill chunk x layers, decode steps x layers),
    every logit row within LOGIT_REL_BOUND of the plain path's on the same
    tokens.  Returns the counts."""
    model = build_model(cfg.replace(use_kernel=True))
    params = tree_map(lambda a: a.to(torch.bfloat16), model.init(seed=0))
    b, s = LAYOUT_PROMPT
    gen = torch.Generator(device="cuda").manual_seed(5)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")}
    want = abstract_caches(model, b, LAYOUT_MAX_LEN, cfg.dtype)

    def run(m, forced=None):
        prefill, decode = make_prefill_step(m, LAYOUT_MAX_LEN), make_decode_step(m)
        logits, caches = prefill(params, prompt)
        structs = [(tuple(t.shape), t.dtype) for t in tree_leaves(caches)]
        rows, toks = [logits[:, -1]], []
        for i in range(LAYOUT_DECODE_STEPS):
            toks.append(forced[i] if forced is not None else rows[-1].argmax(-1))
            logits, caches = decode(params, caches, {"tokens": toks[-1][:, None]}, s + i)
            rows.append(logits[:, -1])
        return rows, toks, structs

    for fn in COUNTERS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    rows, toks, structs = run(model)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    want_counts = {k: 0 for k in COUNTERS}
    want_counts.update(terapipe_attention_fwd=cfg.n_layers,
                       decode_attention=cfg.n_layers * LAYOUT_DECODE_STEPS)
    if counts != want_counts:
        raise AssertionError(f"prefill/decode steps: launches {counts} != {want_counts}")
    if structs != [(tuple(t.shape), t.dtype) for t in tree_leaves(want)]:
        raise AssertionError(f"prefill caches {structs} differ from abstract_caches")
    plain_rows, _, _ = run(build_model(cfg), forced=toks)
    worst = 0.0
    for i, (a, p) in enumerate(zip(rows, plain_rows)):
        if not torch.isfinite(a).all() or a.shape != (b, cfg.vocab_size):
            raise AssertionError(f"step {i}: non-finite or misshapen logits")
        worst = max(worst, ((a - p).abs().amax(-1) / p.abs().amax(-1)).max().item())
    log(f"[layout] {_card()}; {cfg.name} FULL width, {cfg.n_layers} layers: make_prefill_step "
        f"of {b} x {s} tokens into {LAYOUT_MAX_LEN} rows then {LAYOUT_DECODE_STEPS} greedy "
        f"make_decode_step calls in {wall * 1e3:.1f} ms; caches {structs[0]} x "
        f"{len(structs)} as abstract_caches; logits vs the plain path on the same tokens, "
        f"worst max abs err / max |logit| per row {worst:.3g} (bound {LOGIT_REL_BOUND}); "
        f"launches {counts}")
    if worst > LOGIT_REL_BOUND:
        raise AssertionError(f"prefill/decode steps: kernels and plain path disagree ({worst:.3g})")
    return counts


def _serve_example() -> dict:
    """examples/serve_decode_torch.py on the card: launches exact (the
    engine's prefill chunks and decode rounds x its layers, whisper's
    decoder self-attention in its prefill and decode steps)."""
    spec = importlib.util.spec_from_file_location(
        "serve_decode_torch", ROOT / "examples" / "serve_decode_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    for fn in COUNTERS.values():
        fn.launches = 0
    out = example.main(["--device", "cuda"])
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    eng, dec = out["engine"], get_config("whisper-medium", smoke=True).n_dec_layers
    want = {k: 0 for k in COUNTERS}
    want.update(terapipe_attention_fwd=eng["prefill_chunks"] * eng["layers"] + dec,
                decode_attention=eng["decode_rounds"] * eng["layers"]
                + dec * (len(out["whisper-medium"][0]) - 1))
    log(f"[layout] examples/serve_decode_torch.py on the card: engine tokens equal the "
        f"single request's; launches {counts}")
    if counts != want:
        raise AssertionError(f"serve_decode_torch: launches {counts} != {want}")
    return counts


def phase_layout() -> dict:
    """The layout layer (launch/steps.py, configs' SHAPES and input_specs,
    distributed/collectives.py) at full width: the abstract structures of
    every FULL config without allocating, make_train_step on gpt3-1b
    bit-equal to launch.train's step, make_prefill_step and
    make_decode_step on qwen3-0.6b, gradient compression on one gpt3-1b
    step's gradients, and examples/serve_decode_torch.py.  Returns the
    counts of its runs."""
    t0 = time.time()
    torch.cuda.empty_cache()
    _abstract_structures()
    counts = {}
    counts["layout make_train_step"], grads = _train_step_vs_launcher(_gpt3_1b())
    _compression(grads)
    del grads
    torch.cuda.empty_cache()
    cfg = get_config("qwen3-0.6b")
    counts["layout prefill/decode steps"] = _serve_steps(cfg)
    torch.cuda.empty_cache()
    counts["layout serve example"] = _serve_example()
    log(f"[layout] {_card()}; phase 8c took {time.time() - t0:.1f} s")
    return counts


# ------------------------------------------------------ 8d. the parallel layer
PAR_MESH = Mesh(data=2, pipe=2, tp=2)     # 8 virtual ranks
PAR_BASE = Mesh(pipe=PIPE_RANKS)          # today's pipelined step
PAR_PARITY_ROWS = 2                       # one row per data rank
PAR_STEPS = 3
MOE_PAR_MESH = Mesh(pipe=2, tp=2)         # deepseek: 32 of 64 routed experts per rank
MOE_PAR_BASE = Mesh(pipe=2)
# the gloo check, one CPU process per rank: SMOKE configs, f32, batch 4 x
# seq 32, M 4 unless the case says otherwise.  Per case: label, arch, mesh,
# TeraPipeConfig fields, and whether every leaf must be bit-equal to the
# in-process run (else within GLOO_REL of its largest magnitude, the
# leaves that are not bit-equal named in the log)
GLOO_CASES = (
    ("pipe 2, DistRing, 1f1b", "gpt3-1b", Mesh(pipe=2), {"schedule": "1f1b"}, True),
    ("tp 2, DistGroup, contiguous", "gpt3-1b", Mesh(tp=2), {}, True),
    ("data 2, DistGroup, contiguous", "gpt3-1b", Mesh(data=2), {}, True),
    ("pipe 2, DistRing, contiguous", "gpt3-1b", Mesh(pipe=2), {}, False),
    ("pipe 2, DistRing, gpipe D 2", "gpt3-1b", Mesh(pipe=2),
     {"n_token_slices": 1, "n_microbatches": 2}, False),
    ("pipe 2, DistRing, interleaved V 2", "gpt3-1b", Mesh(pipe=2),
     {"schedule": "interleaved", "virtual_stages": 2}, False),
    ("recurrentgemma pipe 2, DistRing, contiguous (post-group tail)", "recurrentgemma-9b",
     Mesh(pipe=2), {}, False),
    ("pipe 2 x tp 2, DistRing + DistGroup, contiguous", "gpt3-1b", Mesh(pipe=2, tp=2), {},
     False),
)
GLOO_BATCH, GLOO_SEQ, GLOO_THREADS = 4, 32, 2
GLOO_REL = 2e-6
# the launcher across four CPU processes against one process, each with a
# checkpoint every LAUNCH_EVERY steps; four processes again with a fault
# at LAUNCH_FAULT, then --resume from the four processes' step
# LAUNCH_EVERY on each of LAUNCH_RESUME processes
LAUNCH_ARGS = ["--arch", "gpt3-1b", "--smoke", "--device", "cpu", "--mode", "terapipe",
               "--token-slices", "4", "--steps", "4", "--batch", "4", "--seq", "64",
               "--log-every", "1"]
LAUNCH_PROCS = 4
LAUNCH_BOUND = 1e-6
LAUNCH_EVERY, LAUNCH_FAULT, LAUNCH_RESUME = 2, 3, (2, 1)
LAUNCH_DIR = ROOT / "build" / "launch_ckpt"


def _mesh_steps(cfg, tcfg: TeraPipeConfig, mesh: Mesh, label: str,
                card: Optional[str] = None) -> tuple:
    """PAR_STEPS AdamW steps of gpt3-1b at batch 4 x seq 2048 through
    launch.train.train_step (the launcher's step) with the pipelined
    value-and-grad on ``mesh``, every launch counter set to 0 just before
    and read just after: finite losses within 1 of ln V, launches exactly
    _launches_per_step's.  Returns the counts and ms/step (median of steps
    2 on, each synchronised) and the peak above the state.  ``card``: a
    CARD_STEPS key for phase 8e, with one more value-and-grad's FLOPs."""
    model = build_model(cfg.replace(use_kernel=True))
    vg = make_terapipe_value_and_grad(model, tcfg, TRAIN_SEQ, TRAIN_BATCH, mesh)
    opt = adamw(cosine_schedule(3e-4, 1, PAR_STEPS))
    data = train_launch.make_data(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)
    state = {"params": tree_map(lambda p: p.requires_grad_(True), model.init(seed=0))}
    state["opt_state"] = opt.init(state["params"])
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    losses, ms = [], []
    for i in range(PAR_STEPS):
        batch = {k: torch.from_numpy(a).cuda() for k, a in data.batch_at(i).items()}
        torch.cuda.synchronize()
        t0 = time.time()
        losses.append(train_launch.train_step(vg, opt, state, batch).item())
        ms.append((time.time() - t0) * 1e3)
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    peak_bytes = torch.cuda.max_memory_allocated() - base
    peak = peak_bytes / 2**30
    if card is not None:
        with _card_flops() as flops:
            vg(state["params"], batch)
        CARD_STEPS[card] = {"counts": counts, "steps": PAR_STEPS, "peak_bytes": peak_bytes,
                            **flops}
    per_step = _launches_per_step(cfg, vg.plan.DM, tp=vg.plan.tp, data=vg.plan.data)
    want = {k: per_step.get(k, 0) * PAR_STEPS for k in COUNTERS}
    step_ms = statistics.median(ms[1:])
    log(f"[parallel] {cfg.name} FULL width, {cfg.n_layers} layers, {mesh}, contiguous M "
        f"{tcfg.n_token_slices}, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, bf16, kernels: losses "
        f"{losses}; steps {[round(x, 1) for x in ms]} ms, {step_ms:.1f} ms/step (median of "
        f"steps 2-{PAR_STEPS}), {TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.0f} tok/s; peak "
        f"allocated {peak:.2f} GiB above the state's {base / 2**30:.2f}; launches {counts} "
        f"({per_step} per step)")
    ln_v = math.log(cfg.vocab_size)
    if not all(abs(x - ln_v) <= 1.0 for x in losses):
        raise AssertionError(f"parallel {label}: losses {losses} not within 1 of ln V")
    if counts != want:
        raise AssertionError(f"parallel {label}: launches {counts} != {want}")
    del state
    torch.cuda.empty_cache()
    return counts, {"step_ms": step_ms, "peak_gib": peak}


def _moe_parallel() -> None:
    """deepseek-moe-16b, MOE_LAYERS layers, batch 1 x seq 2048, contiguous M
    8: expert parallelism on MOE_PAR_MESH against MOE_PAR_BASE in bf16,
    both within phase 4's bounds of the plain paths, and against each
    other (the assignments the TP sums' rounding changes downstream); then
    the whole model's routing on both meshes in f32 (_moe_routing_f32)."""
    cfg = _deepseek()
    tcfg = TeraPipeConfig(n_token_slices=PIPE_SLICES)
    _check_train_against_plain(cfg, {"pipe 2": (tcfg, MOE_PAR_BASE),
                                     "pipe 2 x tp 2": (tcfg, MOE_PAR_MESH)}, versus="pipe 2")
    torch.cuda.empty_cache()
    _moe_routing_f32(cfg, dataclasses.replace(tcfg, cache_dtype=torch.float32))
    torch.cuda.empty_cache()


def _moe_routing_f32(cfg, tcfg: TeraPipeConfig) -> None:
    """The whole model's routing in f32 on MOE_PAR_MESH against
    MOE_PAR_BASE: the pipelined loss without autograd from one seeded init
    and batch, every call of ``moe._route`` recorded with its input (the
    two meshes make the same calls in the same tick order, on the same
    routers).  The TP partial sums round the MoE layers' inputs apart, so
    the routing records may differ; routing is global (the top-k of the
    softmax over all n_experts, the capacity counted over them on every
    tp rank), so a token's choices can change only where its pipe-2 gates
    are a near-tie: the gap between its k-th and (k+1)-th gate at most
    twice the largest change of its gates, and a keep bit only in a
    routing group where a token's choices changed.  Fails otherwise, or
    if the losses differ beyond LOSS_REL_BOUND.  Reports the (token,
    choice) assignments and keep bits changed, and the changed tokens'
    gaps beside every token's median gap."""
    c32 = cfg.replace(dtype=torch.float32, use_kernel=False)
    model = build_model(c32)
    params = model.init(seed=0)
    toks = train_launch.make_data(cfg, 1, TRAIN_SEQ, 1).batch_at(0)
    batch = {k: torch.from_numpy(a).cuda() for k, a in toks.items()}
    route, calls, losses = moe._route, {}, {}
    for label, mesh in (("pipe 2", MOE_PAR_BASE), ("pipe 2 x tp 2", MOE_PAR_MESH)):
        rec = calls[label] = []

        def spy(router, c, xg, rec=rec):
            r = route(router, c, xg)
            rec.append((router, xg, r))
            return r

        moe._route = spy
        try:
            with torch.no_grad():
                losses[label] = make_terapipe_loss(model, tcfg, TRAIN_SEQ, 1, mesh)(
                    params, batch).item()
        finally:
            moe._route = route
    base, par = calls["pipe 2"], calls["pipe 2 x tp 2"]
    if len(base) != len(par) or any(a[0].data_ptr() != b[0].data_ptr()
                                    for a, b in zip(base, par)):
        raise AssertionError("parallel: the two meshes made different routing calls")
    k = c32.moe_top_k
    n_choices = changed = keep_changed = stray_keep = 0
    gaps, flip_gaps, ratios, x_rel = [], [], [], []
    with torch.no_grad():
        for (w, x1, r1), (_, x2, r2) in zip(base, par):
            g1 = torch.softmax((x1 @ w).float(), dim=-1)
            g2 = torch.softmax((x2 @ w).float(), dim=-1)
            t1 = r1.flat_e.reshape(g1.shape[:-1] + (k,))
            t2 = r2.flat_e.reshape(g2.shape[:-1] + (k,))
            moved = ~(t2[..., :, None] == t1[..., None, :]).any(-1)      # (G, S, k)
            flip = moved.any(-1)                                         # (G, S)
            top = torch.topk(g1, k + 1, dim=-1).values
            gap = top[..., k - 1] - top[..., k]
            drift = (g2 - g1).abs().amax(-1)
            keep_diff = r1.keep != r2.keep                               # (G, S*k)
            n_choices += moved.numel()
            changed += int(moved.sum())
            keep_changed += int(keep_diff.sum())
            stray_keep += int((keep_diff.any(-1) & ~flip.any(-1)).sum())
            gaps.append(gap.flatten())
            flip_gaps.append(gap[flip])
            ratios.append(gap[flip] / (2 * drift[flip]))
            x_rel.append(_rel(x2, x1))
    gaps, flip_gaps, ratios = (torch.cat(t) for t in (gaps, flip_gaps, ratios))
    rel_loss = abs(losses["pipe 2 x tp 2"] - losses["pipe 2"]) / abs(losses["pipe 2"])
    worst = float(ratios.max()) if ratios.numel() else 0.0
    log(f"[parallel] {cfg.name} f32 routing, pipe 2 x tp 2 vs pipe 2 ({len(base)} routing "
        f"calls, batch 1 x seq {TRAIN_SEQ}): losses {losses['pipe 2 x tp 2']:.7f} and "
        f"{losses['pipe 2']:.7f} (relative {rel_loss:.3g}); MoE inputs' relative difference "
        f"max {max(x_rel):.3g}; {changed} of {n_choices} (token, choice) assignments changed, "
        f"in {flip_gaps.numel()} tokens, whose pipe-2 top-k gap (k-th minus (k+1)-th gate) is "
        f"at most {float(flip_gaps.max()) if flip_gaps.numel() else 0.0:.3g} against every "
        f"token's median {float(gaps.median()):.3g}; gap / (2 x the token's largest gate "
        f"change) at most {worst:.3g} (bound 1); keep bits changed {keep_changed}, "
        f"{stray_keep} of them in groups where no choice changed (bound 0)")
    if worst > 1.0 or stray_keep:
        raise AssertionError("parallel: the routing at tp 2 is not the global top-k and "
                             "capacity of its own input")
    if rel_loss > LOSS_REL_BOUND:
        raise AssertionError(f"parallel: f32 loss at tp 2 off pipe 2's by {rel_loss:.3g}")
    del model, params, calls, base, par


def _gloo_setup(arch: str, tkw: dict):
    """``arch`` SMOKE in f32 on the CPU, its seeded parameters, a batch and
    the pipelined step's config, the same in every process."""
    torch.set_num_threads(GLOO_THREADS)
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32)
    model = build_model(cfg, "cpu")
    params = tree_map(lambda p: p.requires_grad_(True), model.init(seed=0))
    toks = train_launch.make_data(cfg, GLOO_BATCH, GLOO_SEQ, 0).batch_at(0)
    batch = {k: torch.from_numpy(a) for k, a in toks.items()}
    tcfg = TeraPipeConfig(cache_dtype=torch.float32, **{"n_token_slices": 4, **tkw})
    return model, params, batch, tcfg


def _gloo_worker(rank: int, address: str, world: int, out_dir: str) -> None:
    """One of ``world`` processes: the loss and gradients of each case whose
    mesh has ``world`` ranks, through the transport's groups for its mesh,
    on the process's shard of the parameters (where its ring hosts one
    rank), saved for the parent with the blocks it holds (plain tuples:
    ``Block(*b)``; ``None`` where it holds everything)."""
    transport.init_process_group(address, rank, world, "gloo")
    try:
        for i, (_, arch, mesh, tkw, _) in enumerate(GLOO_CASES):
            if mesh.size != world:
                continue
            model, params, batch, tcfg = _gloo_setup(arch, tkw)
            vg = make_terapipe_value_and_grad(model, tcfg, GLOO_SEQ, GLOO_BATCH, mesh,
                                              transport.mesh_groups(mesh))
            layout = vg.plan.shard_layout(params)
            blocks = (None if layout is None else
                      [ls.mine.astuple() for ls in tree_leaves(layout)])
            loss, grads = vg(shard_params(params, layout), batch)
            torch.save((loss, grads, blocks), Path(out_dir) / f"rank{rank}_case{i}.pt")
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _held_to(got_loss, got: dict, loss, want: dict, exact: bool,
             blocks: Optional[dict] = None) -> tuple:
    """``(verdict, worst, not bit-equal leaves)`` of one rank's loss and
    gradients against the in-process run's: bit-equal, or (unless
    ``exact``) within GLOO_REL of each leaf's largest magnitude; raises
    otherwise.  ``blocks``: per path the rank's :class:`Block` of the
    leaf, which its gradient is held to (cut one leaf at a time)."""
    if got.keys() != want.keys():
        raise AssertionError(f"gradient leaves differ: {sorted(got.keys() ^ want.keys())}")
    differ, worst = [], 0.0
    for path, a in got.items():
        w = want[path] if blocks is None else blocks[path].cut(want[path])
        if a.shape != w.shape:
            raise AssertionError(f"{path}: the rank holds {tuple(a.shape)}, its block is "
                                 f"{tuple(w.shape)}")
        if torch.equal(a, w):
            continue
        differ.append(path)
        rel = float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, rel)
    loss_rel = abs(float(got_loss) - float(loss)) / abs(float(loss))
    if not differ and torch.equal(got_loss, loss):
        return "bit-equal", 0.0, differ
    if exact or worst > GLOO_REL or loss_rel > GLOO_REL:
        raise AssertionError(f"{len(differ)} leaves differ (worst {worst:.3g} of the leaf's "
                             f"largest magnitude), loss relative {loss_rel:.3g}: {differ[:8]}")
    return f"within {GLOO_REL:g} of each leaf's largest magnitude", max(worst, loss_rel), differ


def _gloo_transport() -> None:
    """One CPU process per rank under gloo (torch.multiprocessing, spawned;
    a free localhost port): two processes for the cases of two ranks and,
    at the same time, four for those of four, each against the in-process
    run of its GLOO_CASES mesh; then the launcher under torchrun
    (_launcher_processes)."""
    import torch.multiprocessing as mp
    out_dir = ROOT / "build" / "gloo_check"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.time()
    # every world's processes at once, each world on a port of its own
    running = {world: mp.start_processes(
        _gloo_worker, args=(f"tcp://localhost:{_free_port()}", world, str(out_dir)),
        nprocs=world, start_method="spawn", join=False)
        for world in sorted({mesh.size for _, _, mesh, _, _ in GLOO_CASES})}
    spawned = {}
    for world, ctx in running.items():
        while not ctx.join():
            pass
        spawned[world] = time.time() - t0
    threads = torch.get_num_threads()
    try:
        for i, (label, arch, mesh, tkw, exact) in enumerate(GLOO_CASES):
            model, params, batch, tcfg = _gloo_setup(arch, tkw)
            loss, grads = make_terapipe_value_and_grad(model, tcfg, GLOO_SEQ, GLOO_BATCH,
                                                       mesh)(params, batch)
            want = dict(tree_items(grads))
            for rank in range(mesh.size):
                got_loss, got, blocks = torch.load(out_dir / f"rank{rank}_case{i}.pt")
                if blocks is not None:
                    blocks = {path: Block(*b) for path, b in zip(want, blocks)}
                try:
                    verdict, worst, differ = _held_to(got_loss, dict(tree_items(got)), loss,
                                                      want, exact, blocks)
                except AssertionError as e:
                    raise AssertionError(f"parallel: gloo {label} rank {rank} differs from the "
                                         f"in-process run: {e}") from None
                held = ("" if blocks is None else
                        f", its blocks ({sum(g.numel() for g in tree_leaves(got))} of "
                        f"{sum(w.numel() for w in want.values())} elements)")
                log(f"[parallel] gloo {label}, rank {rank} of {mesh.size}: loss "
                    f"{got_loss.item():.7f} (in process {loss.item():.7f}), {len(want)} "
                    f"gradient leaves{held}, {verdict}"
                    + (f" (worst {worst:.3g}; not bit-equal: {', '.join(differ)})"
                       if differ else ""))
    finally:
        torch.set_num_threads(threads)
    log(f"[parallel] gloo transport: {len(GLOO_CASES)} meshes, "
        + ", ".join(f"{w} processes joined {sec:.1f} s after the spawn" for w, sec in
                    spawned.items())
        + f"; {time.time() - t0:.1f} s with the in-process runs")
    _launcher_processes()


def _printed_losses(text: str) -> list:
    return [float(x) for x in re.findall(r"^step +\d+ loss (\S+)", text, flags=re.M)]


def _launch_all(cmds: dict, env: dict) -> dict:
    """Every command of ``cmds`` (label -> argv) at once; per label its
    ``(stdout, seconds from the start)``; raises on a non-zero exit."""
    t0 = time.time()
    procs = {label: subprocess.Popen(cmd, cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE) for label, cmd in cmds.items()}
    runs = {}
    try:
        for label, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"launcher {label} exited {proc.returncode}: {err[-3000:]}")
            runs[label] = (out, time.time() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return runs


def _npz_leaves(d: Path, step: int) -> dict:
    with np.load(d / f"step_{step:08d}" / "proc0.npz") as data:
        return {k: data[k] for k in data.files}


def _checkpoints_held(got: dict, want: dict, exact: bool) -> str:
    """One final checkpoint against another, leaf by leaf: bit-equal, or
    (unless ``exact``) within GLOO_REL of each leaf's largest magnitude;
    raises otherwise."""
    if got.keys() != want.keys():
        raise AssertionError(f"checkpoint leaves differ: {sorted(got.keys() ^ want.keys())}")
    differ = [k for k in want if not np.array_equal(got[k], want[k])]
    if not differ:
        return "bit-equal"
    worst = max(float(np.abs(got[k].astype(np.float64) - want[k].astype(np.float64)).max())
                / max(float(np.abs(want[k].astype(np.float64)).max()), 1e-30) for k in differ)
    if exact or worst > GLOO_REL:
        raise AssertionError(f"{len(differ)} of {len(want)} leaves differ (worst {worst:.3g})")
    return (f"{len(differ)} of {len(want)} leaves not bit-equal, worst {worst:.3g} "
            f"(bound {GLOO_REL:g})")


def _launcher_processes() -> None:
    """``python -m torch.distributed.run --standalone --nproc-per-node 4 -m
    repro_torch.launch.train`` LAUNCH_ARGS (gloo, Mesh(data=1, pipe=4), one
    rank per process, each holding its stage's shard) with a checkpoint
    every LAUNCH_EVERY steps, against the same launcher in one process (4
    virtual ranks) and, at the same time, four processes with a fault at
    LAUNCH_FAULT: every printed loss of one process and four within
    LAUNCH_BOUND, rank 0 the only one that prints, the launcher's own
    check that every rank ends with the same replicated parameters, the
    faulted run restored at LAUNCH_EVERY on every rank and its final
    checkpoint bit-equal to the run without the fault.  Then ``--resume``
    from the four processes' step LAUNCH_EVERY on each of LAUNCH_RESUME
    processes at once: final checkpoints within GLOO_REL of the four
    processes' (another count of processes sums in another order)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": str(GLOO_THREADS)}
    shutil.rmtree(LAUNCH_DIR, ignore_errors=True)
    LAUNCH_DIR.mkdir(parents=True)
    one = [sys.executable, "-m", "repro_torch.launch.train"]
    torchrun = lambda n: [sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", str(n), "-m", "repro_torch.launch.train"]
    ck = lambda name: ["--checkpoint-dir", str(LAUNCH_DIR / name), "--checkpoint-every",
                       str(LAUNCH_EVERY)]
    many = f"torchrun {LAUNCH_PROCS} processes"
    faulted = f"{many}, fault at step {LAUNCH_FAULT}"
    runs = _launch_all({
        "one process": one + LAUNCH_ARGS + ck("one"),
        many: torchrun(LAUNCH_PROCS) + LAUNCH_ARGS + ck("many"),
        faulted: torchrun(LAUNCH_PROCS) + LAUNCH_ARGS + ck("faulted")
        + ["--simulate-failure-at", str(LAUNCH_FAULT)]}, env)
    (one_out, one_s), (many_out, many_s), (fault_out, fault_s) = runs.values()
    steps = int(LAUNCH_ARGS[LAUNCH_ARGS.index("--steps") + 1])
    want, got = _printed_losses(one_out), _printed_losses(many_out)
    done = [line for line in many_out.splitlines() if line.startswith("done:")]
    worst = max((abs(a - b) for a, b in zip(got, want)), default=float("inf"))
    log(f"[parallel] launcher: torchrun --nproc-per-node {LAUNCH_PROCS} -m repro_torch.launch.train "
        f"{' '.join(LAUNCH_ARGS + ck('many')[2:])}: losses {got} (done {many_s:.1f} s after the "
        f"start), one process at the same time {want} ({one_s:.1f} s), largest difference "
        f"{worst:.3g} (bound {LAUNCH_BOUND:g}); {done[0] if done else 'no done line'}")
    if len(got) != steps or len(want) != steps or worst > LAUNCH_BOUND:
        raise AssertionError("parallel: the launcher across processes printed other losses "
                             "than in one process")
    if len(done) != 1 or f"{LAUNCH_PROCS} processes on Mesh(data=1, pipe={LAUNCH_PROCS})" \
            not in done[0]:
        raise AssertionError(f"parallel: the torchrun launcher's done lines: {done}")
    final = _npz_leaves(LAUNCH_DIR / "many", steps)
    restored = [line for line in fault_out.splitlines() if line.startswith("[fault] restored")]
    ckpt_lines = [line for line in many_out.splitlines() if line.startswith("[ckpt]")]
    verdict = _checkpoints_held(_npz_leaves(LAUNCH_DIR / "faulted", steps), final, exact=True)
    log(f"[parallel] launcher {faulted}: {restored}, final step {steps} checkpoint against "
        f"{many}'s: {verdict} ({fault_s:.1f} s); one process's against it: "
        f"{_checkpoints_held(_npz_leaves(LAUNCH_DIR / 'one', steps), final, exact=False)}; "
        f"{many}'s checkpoint lines: {ckpt_lines}")
    if restored != [f"[fault] restored checkpoint at step {LAUNCH_EVERY}"]:
        raise AssertionError(f"parallel: the faulted launcher restored {restored}")

    src = LAUNCH_DIR / "many" / f"step_{LAUNCH_EVERY:08d}"
    for n in LAUNCH_RESUME:
        shutil.copytree(src, LAUNCH_DIR / f"resume{n}" / src.name)
    resumed = _launch_all({
        n: (torchrun(n) if n > 1 else one) + LAUNCH_ARGS + ck(f"resume{n}") + ["--resume"]
        for n in LAUNCH_RESUME}, env)
    for n, (out, sec) in resumed.items():
        lines = [line for line in out.splitlines()
                 if line.startswith(("[resume]", "[ckpt] restored", "done:"))]
        log(f"[parallel] launcher --resume from {many}'s step {LAUNCH_EVERY} on {n} "
            f"process{'es' if n > 1 else ''} ({sec:.1f} s): {lines}; losses "
            f"{_printed_losses(out)} (the four processes': {got[LAUNCH_EVERY:]}); final "
            f"checkpoint against {many}'s: "
            f"{_checkpoints_held(_npz_leaves(LAUNCH_DIR / f'resume{n}', steps), final, False)}")
        if f"[resume] restored step {LAUNCH_EVERY}" not in lines:
            raise AssertionError(f"parallel: the --resume on {n} processes: {lines}")
    shutil.rmtree(LAUNCH_DIR, ignore_errors=True)


def phase_parallel() -> dict:
    """The parallel layer at full width (gpt3-1b on data 2 x pipe 2 x tp 2
    against pipe 4 and the plain paths, then 3 steps of each;
    deepseek-moe-16b's expert parallelism) and the gloo transport.  Returns
    the counts of its step runs."""
    t0 = time.time()
    cfg = _gpt3_1b()
    torch.cuda.empty_cache()
    tcfg = TeraPipeConfig(n_token_slices=PIPE_SLICES)
    _check_train_against_plain(cfg, {f"pipe {PIPE_RANKS}": (tcfg, PAR_BASE),
                                     "data 2 x pipe 2 x tp 2": (tcfg, PAR_MESH)},
                               rows=PAR_PARITY_ROWS, versus=f"pipe {PIPE_RANKS}")
    torch.cuda.empty_cache()
    counts, runs = {}, {}
    for label, mesh in ((f"pipe {PIPE_RANKS}", PAR_BASE), ("data 2 x pipe 2 x tp 2", PAR_MESH)):
        counts[label], runs[label] = _mesh_steps(cfg, tcfg, mesh, label,
                                                 "pipe" if mesh == PAR_BASE else None)
    log("[parallel] contiguous M " + str(PIPE_SLICES) + ": " + "; ".join(
        f"{k} {m['step_ms']:.1f} ms/step, peak {m['peak_gib']:.2f} GiB above the state"
        for k, m in runs.items()))
    _moe_parallel()
    _gloo_transport()
    log(f"[parallel] {_card()}; phase 8d took {time.time() - t0:.1f} s")
    return {f"parallel {k}": v for k, v in counts.items()}


# ---------------------------------------------------------- 8e. the dry run
#: |predicted - measured| / measured of the peak above the state (PERF.md's
#: prediction, written before the first chip run: the caching allocator
#: rounds each block to 512 B, as the account does)
DRYRUN_PEAK_BOUND = 0.03


def phase_dryrun() -> None:
    """launch/dryrun.py's prediction of the two card steps that phases 8c
    and 8d ran (CARD_STEPS), traced once each on the meta device: kernel
    calls equal to the card's launches per step, FLOPs equal to the card
    step's count, the peak above the state within DRYRUN_PEAK_BOUND of the
    card's, nothing allocated on the card; the peak's breakdown printed."""
    t0 = time.time()
    cfg = _gpt3_1b().replace(use_kernel=True)
    shape = ShapeSpec("card", TRAIN_SEQ, TRAIN_BATCH, "train")
    runs = {"gspmd": ("make_train_step (phase 8c)",
                      lambda: dryrun.trace_gspmd(cfg, shape, Mesh(data=1, model=1))),
            "pipe": (f"contiguous M {PIPE_SLICES} on pipe {PIPE_RANKS}, launch.train.train_step "
                     f"(phase 8d)",
                     lambda: dryrun.trace_terapipe(cfg, shape, PAR_BASE,
                                                   TeraPipeConfig(n_token_slices=PIPE_SLICES),
                                                   per_device=False))}
    gib = lambda x: x / 2**30
    for key, (label, trace) in runs.items():
        card = CARD_STEPS[key]
        before = torch.cuda.memory_allocated()
        t1 = time.time()
        pred = trace()
        trace_s = time.time() - t1
        allocated = torch.cuda.memory_allocated() - before
        calls = {k: pred["kernel_calls"][k] * card["steps"] for k in COUNTERS}
        rel = (pred["peak_above_state"] - card["peak_bytes"]) / card["peak_bytes"]
        log(f"[dryrun] {_card()}; {cfg.name} FULL, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
            f"{label}: traced on meta in {trace_s:.2f} s ({allocated} B allocated on the card, "
            f"largest tensor off meta {pred['largest_off_meta_bytes']} B); peak above the "
            f"state predicted {pred['peak_above_state']:.0f} B ({gib(pred['peak_above_state']):.4f}"
            f" GiB), the card's {card['peak_bytes']} B ({gib(card['peak_bytes']):.4f} GiB): "
            f"{rel:+.5%} (bound {DRYRUN_PEAK_BOUND:.0%}); state {gib(pred['state_bytes']):.4f} "
            f"GiB; FLOPs predicted {pred['flops']:.0f}, the card's {card['flops']} "
            f"(FlopCounterMode {card['matmul_flops']} + kernels {card['kernel_flops']}); kernel "
            f"calls {pred['kernel_calls']} per step x {card['steps']}, launches {card['counts']}")
        log(f"[dryrun] {label}: the peak above the state by category: " + ", ".join(
            f"{k} {gib(v):.4f} GiB" for k, v in pred["by_category"].items())
            + f"; bytes accessed {pred['bytes_accessed']:.4g}")
        if allocated or pred["largest_off_meta_bytes"]:
            raise AssertionError(f"dryrun {label}: the trace allocated off the meta device")
        if calls != card["counts"]:
            raise AssertionError(f"dryrun {label}: kernel calls {calls} != launches "
                                 f"{card['counts']}")
        if int(pred["flops"]) != card["flops"]:
            raise AssertionError(f"dryrun {label}: FLOPs {pred['flops']:.0f} != the card's "
                                 f"{card['flops']}")
        if abs(rel) > DRYRUN_PEAK_BOUND:
            raise AssertionError(f"dryrun {label}: peak {rel:+.3%} off the card's")
    log(f"[dryrun] {_card()}; phase 8e took {time.time() - t0:.1f} s")


# ------------------------------------------- 8f. one pipe rank per thread
RPP_MESH = Mesh(pipe=PIPE_RANKS)
#: gpt3-1b's contiguous M 8 (with the sharded state's AdamW step, save and
#: restore) and gpipe D 2 at batch RPP_BATCH x TRAIN_SEQ
RPP_CASES = (("contiguous M 8", {"n_token_slices": PIPE_SLICES}, PIPE_SLICES, True),
             ("gpipe D 2", {"n_token_slices": 1, "n_microbatches": 2}, 2, False))
RPP_BATCH = TRAIN_BATCH
RPP_REL = 2e-6
RPP_NORM_REL = 1e-6       # the clip norm summed over the shards against one process's
RPP_DIR = ROOT / "build" / "rpp_ckpt"
# the ThreadRing run when every rank held the whole parameters (PERF.md
# section 6): its peak above the state, and each rank's whole parameters
# and AdamW moments
RPP_WHOLE_PEAK_GIB = 30.68
RPP_WHOLE_STATE_GIB = 20.30


def _launch_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in jax_leaves(tree)
               if isinstance(t, torch.Tensor))


def _rpp_state(ring, grads_of: list, shards: list, whole, norm: float) -> None:
    """The sharded state's AdamW step on every rank (the clip norm summed
    over the ranks first, within RPP_NORM_REL of the in-process gradient's
    ``norm``; then one rank's update at a time: one rank's new moments
    above the state), a save of the four ranks' shards (gathered on rank
    0, one leaf at a time) and a restore into one process on the card,
    every leaf of which must hold each rank's block bit for bit; the
    save's and the restore's GB/s."""
    shutil.rmtree(RPP_DIR, ignore_errors=True)
    RPP_DIR.mkdir(parents=True)
    free = shutil.disk_usage(RPP_DIR).free
    file_bytes = 3 * _nbytes(whole)
    if free < 1.2 * file_bytes:
        raise AssertionError(f"rank-per-process: {free / 2**30:.1f} GiB free under {RPP_DIR}, "
                             f"the checkpoint takes {file_bytes / 2**30:.1f}")
    lock = threading.Lock()
    norms = [None] * len(shards)

    def step_and_save(rank):
        k = rank.rank
        layout, params, opt_state = shards[k]
        grads, grads_of[k] = grads_of[k], None
        # the world's squared norm first (a collective), then the updates
        # one rank at a time
        total = world_sq_norm(layout, rank)(
            [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)])
        opt = adamw(cosine_schedule(3e-4, 20, 100), sq_norm_reduce=lambda sq: total)
        norms[k] = float(torch.sqrt(total))
        with lock:
            updates, opt_state = opt.update(grads, opt_state, params)
            del grads
            params = apply_updates(params, updates)
            del updates
            torch.cuda.synchronize()
        shards[k] = (layout, params, opt_state)
        ck = {"params": layout, "opt": AdamWState(REPLICATED, layout, layout), "step": REPLICATED}
        mgr = CheckpointManager(str(RPP_DIR), world=rank)
        mgr.save(1, {"params": params, "opt": opt_state, "step": 1}, layout=ck)
        return mgr.log[-1], ck

    saved = ring.run(step_and_save)
    rec = saved[0][0]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    target = {"params": whole, "opt": adamw(1e-3).init(whole), "step": 0}
    mgr = CheckpointManager(str(RPP_DIR))
    got = mgr.restore(target=target, device=next(tree_leaves(shards[0][1])).device)
    torch.cuda.synchronize()
    back = mgr.log[-1]
    held = (torch.cuda.memory_allocated() - base) / 2**30
    differ = []
    lay_leaves = [jax_leaves(ck) for _, ck in saved]
    rank_trees = [jax_leaves({"params": p, "opt": o, "step": 1}) for _, p, o in shards]
    for i, (path, w) in enumerate(jax_items(got)):
        for k in range(len(shards)):
            a, ls = rank_trees[k][i], lay_leaves[k][i]
            if isinstance(a, torch.Tensor):
                if not torch.equal(a, ls.mine.cut(w)):
                    differ.append(f"rank {k} {path}")
            elif int(w) != a:
                differ.append(f"rank {k} {path}")
    del got, rank_trees
    torch.cuda.empty_cache()
    norm_rel = max(abs(n - norm) for n in norms) / norm
    log(f"[rank-per-process] {_card()}; AdamW step on the {len(shards)} ranks' shards (clip "
        f"norm summed over the ranks: {norms[0]:.9g} on every rank: {len(set(norms)) == 1}; in "
        f"process {norm:.9g}, relative {norm_rel:.3g}, bound {RPP_NORM_REL:g}), then a save from "
        f"the {len(shards)} ranks: rank 0's share "
        f"{rec['bytes'] / 2**30:.3f} GiB of a {rec['file_bytes'] / 2**30:.3f} GiB file in "
        f"{rec['seconds']:.2f} s ({rec['file_bytes'] / rec['seconds'] / 1e9:.2f} GB/s); "
        f"restore into one process on the card: {back['bytes'] / 2**30:.3f} GiB "
        f"({held:.3f} GiB allocated) in {back['seconds']:.2f} s "
        f"({back['bytes'] / back['seconds'] / 1e9:.2f} GB/s, the file warm in the page cache); "
        f"every leaf against each rank's blocks: "
        + ("bit-equal" if not differ else f"{len(differ)} differ: {differ[:8]}"))
    shutil.rmtree(RPP_DIR, ignore_errors=True)
    if differ:
        raise AssertionError("rank-per-process: the restored checkpoint differs from the ranks' "
                             "blocks")
    if len(set(norms)) != 1 or norm_rel > RPP_NORM_REL:
        raise AssertionError(f"rank-per-process: clip norms {norms} against {norm} in process")


def _rank_per_thread(cfg, label: str, tkw: dict, work_items: int, with_state: bool) -> dict:
    """One value-and-grad of ``cfg`` at RPP_BATCH x TRAIN_SEQ on RPP_MESH:
    in process (LocalRing: autograd over the tick loop, the whole
    parameters), then with one pipe rank per thread (transport.ThreadRing,
    four threads on the one card: the transposed tick table, the path of
    one rank per process), each rank on its shard of the parameters
    (shard_params: the rows of its stage, the embedding, head and final
    norm whole).  Every rank's loss and gradient blocks against the
    in-process run's (bit-equal, or within RPP_REL of each leaf's largest
    magnitude, the leaves named), the launches of each run exactly
    _launches_per_step's, the peak above the state of each.  With
    ``with_state``, each rank also holds AdamW moments on its shard before
    the call: its resident state (parameters, moments, the batch) must be
    the dry run's per-device state_bytes (trace_terapipe at each tensor's
    bytes), and _rpp_state follows.  Returns the ThreadRing run's
    launches."""
    model = build_model(cfg.replace(use_kernel=True))
    tcfg = TeraPipeConfig(**tkw)
    params = tree_map(lambda p: p.requires_grad_(True), model.init(seed=0))
    whole = meta_target(params)
    toks = train_launch.make_data(cfg, RPP_BATCH, TRAIN_SEQ, 0).batch_at(0)
    batch = {k: torch.from_numpy(a).cuda() for k, a in toks.items()}
    want_counts = {k: _launches_per_step(cfg, work_items).get(k, 0) for k in COUNTERS}
    runs = {}

    def measured(run):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for fn in COUNTERS.values():
            fn.launches = 0
        t0 = time.time()
        out = run()
        torch.cuda.synchronize()
        sec = time.time() - t0
        counts = _launch_counts()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        return out, {"ms": sec * 1e3, "peak_gib": peak, "counts": counts}

    (loss, grads), runs["in process"] = measured(lambda: make_terapipe_value_and_grad(
        model, tcfg, TRAIN_SEQ, RPP_BATCH, RPP_MESH)(params, batch))
    want = dict(tree_items(grads))
    del grads
    whole_gib = sum(a.numel() * a.element_size() for a in tree_leaves(params)) / 2**30

    def cut(rank):
        layout = make_terapipe_value_and_grad(model, tcfg, TRAIN_SEQ, RPP_BATCH, RPP_MESH,
                                              {"pipe": rank}).plan.shard_layout(params)
        shard = shard_params(params, layout)
        return layout, shard, adamw(1e-3).init(shard) if with_state else None

    ring = transport.ThreadRing(PIPE_RANKS)
    shards = ring.run(cut)
    del params
    torch.cuda.empty_cache()
    resident = [_nbytes({"p": p, "o": o, "batch": batch}) for _, p, o in shards]
    grads_of = [None] * PIPE_RANKS

    def rank_run(rank):
        layout, shard, _ = shards[rank.rank]
        got_loss, got = make_terapipe_value_and_grad(model, tcfg, TRAIN_SEQ, RPP_BATCH, RPP_MESH,
                                                     {"pipe": rank})(shard, batch)
        items = dict(tree_items(got))
        blocks = {path: ls.mine for path, ls in zip(items, tree_leaves(layout))}
        # one rank's verdict at a time: the comparison's temporaries are
        # one leaf's block
        with _RPP_LOCK:
            verdict = _held_to(got_loss, items, loss, want, False, blocks)
        if with_state:
            grads_of[rank.rank] = got
        held = sum(g.numel() * g.element_size() for g in items.values())
        return verdict, float(got_loss), held

    verdicts, runs["ThreadRing"] = measured(lambda: ring.run(rank_run))
    for k, ((verdict, worst, differ), got_loss, held) in enumerate(verdicts):
        log(f"[rank-per-process] {label}, rank {k} of {PIPE_RANKS} (thread): loss "
            f"{got_loss:.7f} (in process {loss.item():.7f}), {len(want)} gradient leaves of its "
            f"blocks ({held / 2**30:.3f} GiB), {verdict}"
            + (f" (worst {worst:.3g}; not bit-equal: {', '.join(differ)})" if differ else ""))
    log(f"[rank-per-process] {_card()}; {cfg.name} FULL width, {cfg.n_layers} layers, "
        f"{RPP_MESH}, {label}, batch {RPP_BATCH} x seq {TRAIN_SEQ}, bf16, kernels, one "
        f"value-and-grad: " + "; ".join(
            f"{k} {r['ms']:.1f} ms, peak {r['peak_gib']:.2f} GiB above the state, launches "
            f"{r['counts']}" for k, r in runs.items())
        + f" (want {want_counts} each); the whole parameters {whole_gib:.2f} GiB, each rank's "
        f"resident state " + ", ".join(f"{r / 2**30:.3f}" for r in resident)
        + f" GiB ({'parameters, AdamW moments' if with_state else 'parameters'} and the batch; "
        f"the ThreadRing peak above the state was {RPP_WHOLE_PEAK_GIB} GiB with every rank "
        f"holding the whole parameters)")
    for k, r in runs.items():
        if {n: r["counts"][n] for n in want_counts} != want_counts:
            raise AssertionError(f"rank-per-process {label} {k}: launches {r['counts']} != "
                                 f"{want_counts}")
    norm = float(global_norm(want))
    del want
    if with_state:
        shape = ShapeSpec("rpp", TRAIN_SEQ, RPP_BATCH, "train")
        predicted = dryrun.trace_terapipe(cfg, shape, RPP_MESH, tcfg, per_device=True,
                                          block=1)["state_bytes"]
        log(f"[rank-per-process] {cfg.name}: resident state per rank "
            + ", ".join(f"{r / 2**30:.4f}" for r in resident)
            + f" GiB against the dry run's per-device state_bytes {predicted / 2**30:.4f} GiB "
            f"(every rank holding the whole state: {RPP_WHOLE_STATE_GIB} GiB)")
        if any(r != predicted for r in resident):
            raise AssertionError(f"rank-per-process: resident state {resident} != the dry run's "
                                 f"{predicted}")
        _rpp_state(ring, grads_of, shards, whole, norm)
    del model, shards, grads_of
    torch.cuda.empty_cache()
    return runs["ThreadRing"]["counts"]


_RPP_LOCK = threading.Lock()


def phase_rank_per_process() -> dict:
    """gpt3-1b at full width with one pipe rank per thread on the one card
    (RPP_CASES), each against the in-process run."""
    t0 = time.time()
    cfg = _gpt3_1b()
    torch.cuda.empty_cache()
    counts = {f"rank-per-process {label}": _rank_per_thread(cfg, label, tkw, items, state)
              for label, tkw, items, state in RPP_CASES}
    log(f"[rank-per-process] {_card()}; phase 8f took {time.time() - t0:.1f} s")
    return counts


# --------------------------------------------------------------- 9. times
def phase_times(errs: dict, launches: dict) -> list:
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(1)
    dt, elt = torch.bfloat16, 2
    rows = []

    # prefill: one whole 1024-token prompt chunk (the slo_tmax=None path)
    b, l, ctx, hq, hkv, hd = 1, 1024, 0, 16, 8, 128
    sk = ctx + l
    q = _rand((b, l, hq, hd), dt, gen)
    k = _rand((b, sk, hkv, hd), dt, gen)
    v = _rand((b, sk, hkv, hd), dt, gen)
    mask = (torch.arange(l, device="cuda")[:, None] + ctx
            >= torch.arange(sk, device="cuda")[None, :])
    keys = sum(ctx + i + 1 for i in range(l))
    flops = 4 * hd * hq * b * keys
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * elt + b * hq * l * 4
    bms, by = bound_ms(flops, nbytes)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rows.append(dict(
        name="terapipe_attention_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/terapipe_attention_fwd.cu",
        replaces="src/repro/kernels/terapipe_attention.py:57",
        launches=launches["terapipe_attention_fwd"],
        max_abs_err=errs["terapipe_attention_fwd"],
        ms=time_ms(lambda: terapipe_attention_fwd(q, k, v, ctx)),
        plain_ms=time_ms(lambda: terapipe_attention_ref(q, k, v, ctx)),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        shape=f"B={b} l={l} ctx={ctx} Hq={hq} Hkv={hkv} hd={hd} bf16"))

    # decode: one round of the serving engine, 4 slots at mixed depths
    b, L, hq, hkv, hd, kv_len = SERVE_ROUND
    q = _rand((b, 1, hq, hd), dt, gen)
    k = _rand((b, L, hkv, hd), dt, gen)
    v = _rand((b, L, hkv, hd), dt, gen)
    lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    dmask = (torch.arange(L, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    flops = 4 * hd * hq * sum(kv_len)
    nbytes = (2 * q.numel() + 2 * sum(kv_len) * hkv * hd) * elt + 4 * b
    bms, by = bound_ms(flops, nbytes)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rows.append(dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:29",
        launches=launches["decode_attention"],
        max_abs_err=errs["decode_attention"],
        ms=time_ms(lambda: decode_attention_kernel(q, k, v, lens)),
        plain_ms=time_ms(lambda: decode_attention_ref(q, k, v, lens)),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: sdpa(qt, kt, vt, attn_mask=dmask, enable_gqa=True)),
        shape=f"B={b} L={L} kv_len={kv_len} Hq={hq} Hkv={hkv} hd={hd} bf16"))
    # backward: one layer of the gpt3-1b training step
    b, l, ctx, hq, hkv, hd = TRAIN_BATCH, TRAIN_SEQ, 0, 16, 16, 128
    q, k, v, do, lse, delta = _bwd_inputs(b, l, ctx, hq, hkv, hd, 1.0, dt, gen, tail=0)
    args = (q, k, v, do, lse, delta, ctx)
    pairs = b * hq * sum(ctx + i + 1 for i in range(l))
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    out = sdpa(qt, kt, vt, is_causal=True)
    gt = do.transpose(1, 2)
    library = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True))
    shape = f"B={b} l={l} ctx={ctx} Hq={hq} Hkv={hkv} hd={hd} bf16"
    for name, fn, ref, flops, written, line in (
            ("terapipe_attention_dq", terapipe_attention_dq, terapipe_attention_dq_ref,
             6 * hd * pairs, (q,), 51),
            ("terapipe_attention_dkv", terapipe_attention_dkv, terapipe_attention_dkv_ref,
             8 * hd * pairs, (k, v), 85)):
        bms, by = bound_ms(flops, nbytes(q, k, v, do, lse, delta, *written))
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/terapipe_attention_bwd.cu",
            replaces=f"src/repro/kernels/terapipe_attention_bwd.py:{line}",
            launches=launches[name], max_abs_err=errs[name],
            ms=time_ms(lambda: fn(*args)), plain_ms=time_ms(lambda: ref(*args)),
            bound_ms=bms, bound_by=by, library_ms=library, shape=shape))
    for r in rows:
        log(f"[times] {r['name']} ({r['shape']}): kernel {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms")
    log(f"[times] backward at the training shape: dQ + dK/dV kernels "
        f"{rows[-2]['ms'] + rows[-1]['ms']:.4f} ms vs SDPA's backward (dQ, dK, dV "
        f"together, is_causal) {library:.4f} ms")
    # the forward at the training shape, where the step launches it 48 times
    with torch.no_grad():
        rows[0].update(
            train_ms=time_ms(lambda: terapipe_attention_fwd(q, k, v, ctx)),
            train_bound_ms=bound_ms(4 * hd * pairs, nbytes(q, k, v, q, lse))[0],
            train_library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True)),
            train_shape=shape)
    log(f"[times] terapipe_attention_fwd at the training shape ({shape}): kernel "
        f"{rows[0]['train_ms']:.4f} ms, bound {rows[0]['train_bound_ms']:.4f} ms, SDPA "
        f"forward {rows[0]['train_library_ms']:.4f} ms")
    del q, k, v, do, lse, delta, args, qt, kt, vt, out
    _slice_times(rows)
    _family_times(rows)
    walk = tile_walk.summary(TRAIN_SEQ, 0, 16, 16, 128, batch=TRAIN_BATCH)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shares = [len(d) for d in tile_walk.deal(walk["fwd_units"], sms)]
    log(f"[times] tile walk at the training shape (kernels/tile_walk.py; forward: "
        f"{tile_walk.FWD_BQ}-row q tiles, {tile_walk.FWD_BK}-key tiles, warpgroups of "
        f"{tile_walk.GROUP} rows; dQ: {tile_walk.DQ_BQ}-row q tiles, {tile_walk.dq_bk(128)}-key "
        f"tiles; dK/dV: {tile_walk.DKV_BK}-key units, "
        f"{tile_walk.dkv_bq(128)}-row q tiles; each dealt to {len(shares)} persistent blocks, "
        f"{min(shares)}-{max(shares)} units each): {walk}")
    log(f"[times] decode spans of the serving round (tile_walk.decode_spans, clusters of "
        f"{tile_walk.DECODE_CLUSTER}, {tile_walk.DECODE_BOX}-key boxes): "
        f"{[tile_walk.decode_spans(n) for n in SERVE_ROUND[-1]]}")
    return rows


def _slice_times(rows: list) -> None:
    """The forward, dQ and dK/dV at the pipelined step's last slice (B
    TRAIN_BATCH, l TRAIN_SEQ / PIPE_SLICES at ctx TRAIN_SEQ - l over the
    cache rows [0, ctx + l), Hq = Hkv = 16, hd 128), where the executor
    launches them most; timed as _family_times does, SDPA with the slice's
    bool mask as the library call; each row gets "slice_shapes"."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(7)
    row = {r["name"]: r for r in rows}
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    b, l, ctx, hq, hkv, hd = PIPE_CASES[-1][:6]
    q, k, v, do, lse, delta = _bwd_inputs(b, l, ctx, hq, hkv, hd, 1.0, torch.bfloat16, gen,
                                          tail=0)
    args = (q, k, v, do, lse, delta, ctx)
    pairs = b * hq * sum(ctx + i + 1 for i in range(l))
    mask = (torch.arange(l, device="cuda")[:, None] + ctx
            >= torch.arange(ctx + l, device="cuda")[None, :])
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    with torch.no_grad():
        fwd_library = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask))
    out = sdpa(qt, kt, vt, attn_mask=mask)
    gt = do.transpose(1, 2)
    bwd_library = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True))
    shape = f"B={b} l={l} ctx={ctx} Sk={ctx + l} Hq={hq} Hkv={hkv} hd={hd} bf16"
    for name, fn, ref, flops, written, library in (
            ("terapipe_attention_fwd", lambda: terapipe_attention_fwd(q, k, v, ctx),
             lambda: terapipe_attention_ref(q, k, v, ctx), 4 * hd * pairs, (q, lse), fwd_library),
            ("terapipe_attention_dq", lambda: terapipe_attention_dq(*args),
             lambda: terapipe_attention_dq_ref(*args), 6 * hd * pairs, (q,), bwd_library),
            ("terapipe_attention_dkv", lambda: terapipe_attention_dkv(*args),
             lambda: terapipe_attention_dkv_ref(*args), 8 * hd * pairs, (k, v), bwd_library)):
        inputs = (q, k, v) if name == "terapipe_attention_fwd" else (q, k, v, do, lse, delta)
        bms, by = bound_ms(flops, nbytes(*inputs, *written))
        e = dict(shape=shape, ms=time_ms(fn), plain_ms=time_ms(ref), bound_ms=bms, bound_by=by,
                 library_ms=library)
        row[name].setdefault("slice_shapes", []).append(e)
        log(f"[times] {name} ({shape}): kernel {e['ms']:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"plain {e['plain_ms']:.4f} ms, library {library:.4f} ms")
    del q, k, v, do, lse, delta, args, qt, kt, vt, out, gt


def _family_times(rows: list) -> None:
    """Each kernel at phase 8b's shapes (the training steps at hd 96 and 64,
    both decodes), timed as above beside its bound, its plain version and
    the library call; each row gets a "family_shapes" list of them."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(5)
    dt = torch.bfloat16
    row = {r["name"]: r for r in rows}
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)

    def add(name, shape, fn, ref, flops, nb, library):
        bms, by = bound_ms(flops, nb)
        e = dict(shape=shape, ms=time_ms(fn), plain_ms=time_ms(ref), bound_ms=bms,
                 bound_by=by, library_ms=library)
        row[name].setdefault("family_shapes", []).append(e)
        log(f"[times] {name} ({shape}): kernel {e['ms']:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"plain {e['plain_ms']:.4f} ms, library {library:.4f} ms")

    for (b, l, ctx, hq, hkv, hd, _, _) in FAMILY_TRAIN_CASES:
        q, k, v, do, lse, delta = _bwd_inputs(b, l, ctx, hq, hkv, hd, 1.0, dt, gen, tail=0)
        args = (q, k, v, do, lse, delta, ctx)
        pairs = b * hq * sum(ctx + i + 1 for i in range(l))
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        with torch.no_grad():
            fwd_library = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
        out = sdpa(qt, kt, vt, is_causal=True)
        gt = do.transpose(1, 2)
        bwd_library = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                                          retain_graph=True))
        shape = f"B={b} l={l} ctx={ctx} Hq={hq} Hkv={hkv} hd={hd} bf16"
        add("terapipe_attention_fwd", shape, lambda: terapipe_attention_fwd(q, k, v, ctx),
            lambda: terapipe_attention_ref(q, k, v, ctx), 4 * hd * pairs,
            nbytes(q, k, v, q, lse), fwd_library)
        add("terapipe_attention_dq", shape, lambda: terapipe_attention_dq(*args),
            lambda: terapipe_attention_dq_ref(*args), 6 * hd * pairs,
            nbytes(q, k, v, do, lse, delta, q), bwd_library)
        add("terapipe_attention_dkv", shape, lambda: terapipe_attention_dkv(*args),
            lambda: terapipe_attention_dkv_ref(*args), 8 * hd * pairs,
            nbytes(q, k, v, do, lse, delta, k, v), bwd_library)
        del q, k, v, do, lse, delta, args, qt, kt, vt, out, gt
    for (b, L, hq, hkv, hd, kv_len) in FAMILY_DECODE_CASES:
        q = _rand((b, 1, hq, hd), dt, gen)
        k = _rand((b, L, hkv, hd), dt, gen)
        v = _rand((b, L, hkv, hd), dt, gen)
        lens = torch.full((b,), kv_len, dtype=torch.int32, device="cuda")
        dmask = (torch.arange(L, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        add("decode_attention", f"B={b} L={L} kv_len={kv_len} Hq={hq} Hkv={hkv} hd={hd} bf16",
            lambda: decode_attention_kernel(q, k, v, lens),
            lambda: decode_attention_ref(q, k, v, lens), 4 * hd * hq * b * kv_len,
            (2 * q.numel() + 2 * b * kv_len * hkv * hd) * 2 + 4 * b,
            time_ms(lambda: sdpa(qt, kt, vt, attn_mask=dmask, enable_gqa=True)))


# ----------------------------------------------------------- 10. profiles
def _plain_attention_share(cfg, profiled: dict) -> None:
    """whisper's plain attention cores (attention_scores_gqa, no mask) at
    the training shape, B TRAIN_BATCH, TRAIN_SEQ queries over TRAIN_SEQ
    keys, Hq = Hkv = 16, hd 64, bf16: the forward and the backward timed
    with CUDA events, and what a step's 24 encoder layers (and as many
    cross-attentions, the same shape) spend in them, 2 forwards (remat)
    and a backward each, as a share of the profiled step's device time."""
    from repro_torch.models.common import attention_scores_gqa

    gen = torch.Generator(device="cuda").manual_seed(6)
    shape = (TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.hd)
    q, k, v = (_rand(shape, torch.bfloat16, gen).requires_grad_(True) for _ in range(3))
    g = _rand(shape, torch.bfloat16, gen)
    with torch.no_grad():
        fwd = time_ms(lambda: attention_scores_gqa(q, k, v, mask=None), iters=10)
    out = attention_scores_gqa(q, k, v, mask=None)
    bwd = time_ms(lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True), iters=10)
    per_stack = cfg.n_enc_layers * (2 * fwd + bwd)
    log(f"[profile] {_card()}; {cfg.name} plain attention core (B={shape[0]} S={shape[1]} "
        f"H={shape[2]} hd={shape[3]} bf16, f32 scores, no mask): forward {fwd:.3f} ms, "
        f"backward {bwd:.3f} ms; the encoder's {cfg.n_enc_layers} layers x (2 forwards + 1 "
        f"backward) {per_stack:.1f} ms = {per_stack / profiled['device_ms']:.1%} of the "
        f"profiled step's {profiled['device_ms']:.1f} device ms, and as much again in the "
        f"cross-attention ({2 * per_stack / profiled['device_ms']:.1%} together)")


def phase_profiles() -> None:
    """One pipelined 1f1b step (M = PIPE_SLICES) of gpt3-1b and one gspmd
    step each of mamba2-2.7b (phase 8's depth) and whisper-medium (with its
    plain attention's share of the device time) under torch.profiler: the
    paths no cell of the benchmark (``perfbench/``) traces.  Last: after a
    profiled region the host's eager launches run slower for the rest of
    the process, which a host-bound run (the pipelined step, the stage
    sweep) shows in its times, so every timed eager run comes before it."""
    cfg = _gpt3_1b().replace(use_kernel=True)
    torch.cuda.empty_cache()
    tcfg = TeraPipeConfig(n_token_slices=PIPE_SLICES, schedule="1f1b")
    _profile_step(cfg, lambda model: make_terapipe_value_and_grad(
        model, tcfg, TRAIN_SEQ, TRAIN_BATCH, PIPE_RANKS), f"terapipe 1f1b M {PIPE_SLICES}")
    torch.cuda.empty_cache()
    _profile_step(_mamba2(), lambda model: value_and_grad(model.loss), "gspmd")
    torch.cuda.empty_cache()
    cfg = _whisper().replace(use_kernel=True)
    _plain_attention_share(cfg, _profile_step(cfg, lambda model: value_and_grad(model.loss),
                                              "gspmd"))
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.time()
    done = lambda phase: log(f"[time] {phase} done at {time.time() - t0:.1f} s")
    phase_build()
    done("build")
    errs = phase_kernels()
    errs.update(phase_kernels_bwd())
    done("kernels")
    paths = {"serve": phase_serve()}
    done("serve")
    paths["train"], train = phase_train()
    done("train")
    pipe_counts, pipe_runs = phase_pipeline()
    paths.update(pipe_counts)
    done("pipeline")
    above = lambda m: m["peak_gib"] - m["base_gib"]
    paths.update(phase_restart({"gspmd": above(train),
                                RESUME_SCHEDULE: above(pipe_runs[RESUME_SCHEDULE])}))
    done("restart")
    paths.update(phase_moe())
    done("moe")
    paths.update(phase_state())
    done("state")
    paths.update(phase_families())
    done("families")
    paths.update(phase_layout())
    done("layout")
    paths.update(phase_parallel())
    done("parallel")
    phase_dryrun()
    done("dryrun")
    paths.update(phase_rank_per_process())
    done("rank per process")
    launches = {k: sum(c.get(k, 0) for c in paths.values()) for k in COUNTERS}
    log(f"[launches] main paths: {paths}")
    rows = phase_times(errs, launches)
    done("times")
    phase_profiles()
    done("profiles")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
