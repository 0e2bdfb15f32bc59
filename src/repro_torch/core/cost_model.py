"""Cost models for the TeraPipe DP scheduler (reference:
``repro/core/cost_model.py``; the port imports nothing of the JAX package).

The DP needs t_fwd(l, ctx): forward (or fwd+bwd) latency of ONE pipeline
stage processing a token slice of length ``l`` whose attention context is
``ctx`` previously-processed tokens (Eq. 4 of the paper).

Three interchangeable models, copied from the reference:

* :class:`AnalyticCostModel` — roofline-style FLOPs/bandwidth model with an
  occupancy floor (the flat region of the paper's Fig. 3: below a minimum
  slice length the device is latency-bound, not throughput-bound).
* :class:`TableCostModel` — measured (l, ctx) -> seconds table (what the
  paper uses on a live cluster).
* :class:`BilinearFitCostModel` — the paper's estimator (Eq. 9):
  t_fwd(i, j) = t_base(i) + a0 + a1·i + a2·j + a3·i·j, least-squares fit on
  a sample of (i, j) pairs from any ground-truth model.

New to the port: :func:`measure_kernel_cost_table` times the port's own
attention kernels, forward and dQ + dK/dV (CUDA events on the card), and
:data:`H100`, a hardware spec whose ``efficiency`` and ``occupancy_floor``
were fitted to a stage sweep on the card.  ``TPU_V5E`` and ``V100_AWS``
are the reference's targets, kept so that plans can be compared with the
reference's exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.timing import PEAK_BF16_FLOPS, PEAK_BYTES, time_ms

from .schedules import KIND_BWD, KIND_BWD_INPUT, KIND_BWD_WEIGHT, KIND_FWD


# ---------------------------------------------------------------------------
# Hardware specifications
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # FLOP/s (bf16/fp16 tensor)
    hbm_bw: float              # bytes/s
    link_bw: float             # bytes/s stage-to-stage (ICI link / x-node net)
    link_latency: float        # seconds per transfer
    occupancy_floor: int       # tokens: below this, time is flat (Fig. 3)
    efficiency: float          # achievable fraction of peak on large matmuls


# The reference's targets, copied: the parity tests and the CPU --dp-plan
# price with them.  No field of them describes the H100.
TPU_V5E = HardwareSpec("tpu-v5e", 197e12, 819e9, 50e9, 1e-6, 256, 0.55)
# AWS p3.16xlarge: V100 (125 TF/s fp16), 25 Gbit/s x-node => ~3 GB/s usable
V100_AWS = HardwareSpec("v100-aws", 125e12, 900e9, 3e9, 20e-6, 256, 0.45)

# One H100 SXM: peak bf16 rate and HBM bandwidth from NVIDIA's data sheet
# (the bounds of repro_torch/timing.py).  The executor's K ranks are virtual,
# in one process on one card, so no byte crosses a link: zero latency and
# infinite link bandwidth make the transfer term 0 (and every unit's time
# linear in the batch, so a plan does not depend on the batch it is priced
# at).  ``efficiency`` and ``occupancy_floor`` are fitted
# (fit_efficiency_and_floor) to chip_smoke.py's stage sweep: one stage of 6
# gpt3-1b blocks, forward at ctx 0 over l = 32..2048 at the executor's batch
# of 4 sequences per slice, replayed from CUDA graphs (the device's own
# time), on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit.  The eager
# executor pays the host's dispatch on top of it (PERF.md).
H100 = HardwareSpec("h100", PEAK_BF16_FLOPS, PEAK_BYTES, float("inf"), 0.0,
                    222, 0.3017)


# ---------------------------------------------------------------------------
# FLOPs accounting (per layer, per token)
# ---------------------------------------------------------------------------
def layer_matmul_flops(cfg: ModelConfig) -> float:
    """Context-independent matmul FLOPs per token per layer (fwd)."""
    d, hd = cfg.d_model, cfg.hd
    qo = 2 * d * cfg.n_heads * hd * 2          # wq + wo
    kv = 2 * d * cfg.n_kv_heads * hd * 2       # wk + wv
    if cfg.family == "moe" or cfg.n_experts:
        ff = 2 * d * cfg.d_expert * 3 * cfg.moe_top_k
        ff += 2 * d * (cfg.n_shared_experts * cfg.d_expert) * 3
        ff += 2 * d * cfg.n_experts            # router
    elif cfg.family == "ssm":
        d_inner = cfg.ssm_expand * d
        h = d_inner // cfg.ssm_head_dim
        proj = 2 * d * (2 * d_inner + 2 * cfg.ssm_state + h)
        out = 2 * d_inner * d
        ssd = 2 * d_inner * cfg.ssm_state * 4  # B x̄, C S terms (state flops)
        return proj + out + ssd
    elif cfg.family == "hybrid":
        # average over pattern: 2 rec blocks + 1 local-attn block per 3
        rec = 2 * d * d * 5 + 2 * d * d        # w_x,w_y,w_a,w_i,w_out (+conv~small)
        att = qo + kv + 2 * d * cfg.d_ff * 3
        return (2 * rec + att) / 3.0
    else:
        ff = 2 * d * cfg.d_ff * 3              # SwiGLU: gate, up, down
    return qo + kv + ff


#: Fused flash backward cost relative to the forward's 2 block matmuls
#: (QKᵀ, PV).  The two-sweep kernel in ``repro.kernels`` runs 7: the dQ pass
#: rebuilds QKᵀ and computes dO·Vᵀ and dS·K; the dK/dV pass rebuilds QKᵀ and
#: dO·Vᵀ again and computes dSᵀ·Q and Pᵀ·dO.
FLASH_BWD_ATTN_MULT = 3.5

#: The ZB-H1 B/W split of that structure: the dQ pass (3 block matmuls,
#: 1.5× fwd) prices with the input-grad B unit — dQ is on the input-
#: cotangent path the reverse ring is waiting for — and the dK/dV pass
#: (4 block matmuls, 2× fwd) with the deferred weight-grad W unit.  The two
#: sum to FLASH_BWD_ATTN_MULT exactly, so B + W == the fused bwd.
FLASH_BWD_DQ_MULT = 1.5
FLASH_BWD_DKV_MULT = 2.0

#: Parameter-matmul backward: dX and dW per forward matmul.
MATMUL_BWD_MULT = 2.0
#: ... split one-each between the B unit (dX: the input cotangent) and the
#: W unit (dW: the parameter grad).
MATMUL_BWD_INPUT_MULT = 1.0
MATMUL_BWD_WEIGHT_MULT = 1.0


def attention_context_flops(cfg: ModelConfig, l: int, ctx: int) -> float:
    """Attention score+value FLOPs for a slice of l tokens at context ctx.
    ufunc-friendly: l/ctx may be scalars or broadcastable arrays."""
    if cfg.family == "ssm":
        return 0.0
    d_attn = cfg.n_heads * cfg.hd
    eff_ctx = ctx
    avg_span = eff_ctx + (l + 1) / 2.0
    if cfg.window:
        avg_span = np.minimum(avg_span, float(cfg.window))
    per_layer = 4.0 * d_attn * l * avg_span     # QK^T + PV, fwd
    if cfg.family == "hybrid":
        per_layer /= len(cfg.block_pattern)     # only 1/3 of layers attend
    return per_layer


# ---------------------------------------------------------------------------
# Cost model interface
# ---------------------------------------------------------------------------
class CostModel:
    """t(l, ctx) in seconds for one stage; batch b sequences per slice."""

    def t_fwd(self, l: int, ctx: int) -> float:
        raise NotImplementedError

    def t_bwd(self, l: int, ctx: int) -> float:
        """FUSED backward-unit latency (the explicit-bwd 1F1B-family
        schedules pay one inside every steady-state tick).  Default: the
        simulator's bwd ≈ 2·fwd convention; models with real kernel
        knowledge override."""
        return 2.0 * self.t_fwd(l, ctx)

    def t_bwd_input(self, l: int, ctx: int) -> float:
        """B (input-cotangent) unit latency for split-backward schedules
        (ZB-H1).  Default: ≈ the forward (the dX transposes mirror the
        forward matmuls); always pairs with :meth:`t_bwd_weight` so that
        B + W == the fused :meth:`t_bwd`."""
        return self.t_fwd(l, ctx)

    def t_bwd_weight(self, l: int, ctx: int) -> float:
        """W (weight-grad) unit latency: the rest of the fused backward
        after the B unit, by construction ``t_bwd - t_bwd_input`` so split
        schedules pay exactly what fused ones do, just rearranged."""
        return self.t_bwd(l, ctx) - self.t_bwd_input(l, ctx)

    def unit_cost(self, l: int, ctx: int, kind: int = KIND_FWD) -> float:
        """Duration of one scheduled UNIT by its typed kind — the schedule
        IR tick tables' third column, and the form the simulator's table
        pricer consumes: KIND_FWD -> :meth:`t_fwd`, fused KIND_BWD ->
        :meth:`t_bwd`, split KIND_BWD_INPUT / KIND_BWD_WEIGHT ->
        :meth:`t_bwd_input` / :meth:`t_bwd_weight` (which sum to t_bwd)."""
        if kind == KIND_FWD:
            return self.t_fwd(l, ctx)
        if kind == KIND_BWD:
            return self.t_bwd(l, ctx)
        if kind == KIND_BWD_INPUT:
            return self.t_bwd_input(l, ctx)
        if kind == KIND_BWD_WEIGHT:
            return self.t_bwd_weight(l, ctx)
        raise ValueError(f"unit_cost: unpriceable unit kind {kind!r}")

    def __call__(self, l: int, ctx: int) -> float:
        return self.t_fwd(l, ctx)


class AnalyticCostModel(CostModel):
    def __init__(self, cfg: ModelConfig, hw: HardwareSpec, *,
                 layers_per_stage: int, batch: int = 1, tp_degree: int = 1,
                 include_backward: bool = True, stage_slowdown: float = 1.0):
        self.cfg, self.hw = cfg, hw
        self.layers = layers_per_stage
        self.batch = batch
        self.tp = tp_degree
        self.include_backward = include_backward
        self.bwd_mult = 3.0 if include_backward else 1.0   # bwd ≈ 2x fwd
        self.slowdown = stage_slowdown
        # float: keeps the array path in t_fwd out of int64 accumulation
        self._matmul_per_tok = float(layer_matmul_flops(cfg) * layers_per_stage)

    def _t(self, l, ctx, matmul_mult: float, attn_mult: float,
           comm: float = 1.0):
        """``comm`` scales the stage-boundary transfer term: 1 for units
        that put a value on a ring (fwd activations, fused-bwd / B-unit
        cotangents), 0 for W units (weight grads stay rank-local) — so
        t_bwd_input + t_bwd_weight == t_bwd without double-counting the
        wire."""
        hw = self.hw
        l_eff = np.maximum(l, hw.occupancy_floor)   # Fig. 3 flat region
        flops = (self.batch * l_eff * self._matmul_per_tok * matmul_mult
                 + self.batch * attention_context_flops(self.cfg, l_eff, ctx)
                 * self.layers * attn_mult)
        t_compute = flops / (self.tp * hw.peak_flops * hw.efficiency)
        # stage boundary transfer: activations of the slice (bf16)
        bytes_x = self.batch * l * self.cfg.d_model * 2
        t_comm = comm * (hw.link_latency + bytes_x / hw.link_bw)
        return self.slowdown * (t_compute + t_comm)

    def t_fwd(self, l: int, ctx: int) -> float:
        """Scalar or elementwise-array evaluation (the DP's cost-matrix fill
        calls this once with the whole (l, ctx) grid).  NB: with the default
        ``include_backward=True`` this prices the COMBINED fwd+bwd unit
        (bwd ≈ 2·fwd, the symmetric-pipeline convention the DP objective
        uses); construct with ``include_backward=False`` for the forward
        alone."""
        return self._t(l, ctx, self.bwd_mult, self.bwd_mult)

    def t_bwd(self, l: int, ctx: int) -> float:
        """Backward unit ALONE, priced from the FUSED flash-backward kernel:
        parameter matmuls transpose at 2× forward, but attention pays
        ``FLASH_BWD_ATTN_MULT`` (the two-sweep dQ / dK-dV recompute — see
        repro.kernels.terapipe_attention_bwd), not the dense-reference 2×.
        The cotangent rides the reverse ring: same wire bytes.

        Only meaningful on an ``include_backward=False`` instance, where
        t_fwd is the forward alone and 1F1B consumers sum t_fwd + t_bwd per
        separately-scheduled unit — on the combined-unit default, summing
        the two would double-count the backward, so this guards."""
        assert not self.include_backward, (
            "t_bwd prices the backward unit alone; this model was built "
            "with include_backward=True, whose t_fwd already contains the "
            "backward (fwd+bwd combined unit).  Build with "
            "include_backward=False to price fwd and bwd units separately "
            "(1F1B-style schedules).")
        return self._t(l, ctx, MATMUL_BWD_MULT, FLASH_BWD_ATTN_MULT)

    def t_bwd_input(self, l: int, ctx: int) -> float:
        """B unit: dX parameter-matmul transposes (1× fwd) + the flash dQ
        pass (1.5× fwd attention); the cotangent pays the reverse-ring
        wire.  Same include_backward guard as :meth:`t_bwd`."""
        assert not self.include_backward, (
            "t_bwd_input prices the B unit alone; build with "
            "include_backward=False (see t_bwd)")
        return self._t(l, ctx, MATMUL_BWD_INPUT_MULT, FLASH_BWD_DQ_MULT)

    def t_bwd_weight(self, l: int, ctx: int) -> float:
        """W unit: dW parameter matmuls (1× fwd) + the flash dK/dV pass
        (2× fwd attention); weight grads stay rank-local, so no wire term —
        t_bwd_input + t_bwd_weight == t_bwd exactly."""
        assert not self.include_backward, (
            "t_bwd_weight prices the W unit alone; build with "
            "include_backward=False (see t_bwd)")
        return self._t(l, ctx, MATMUL_BWD_WEIGHT_MULT, FLASH_BWD_DKV_MULT,
                       comm=0.0)


class TableCostModel(CostModel):
    """Measured (l, ctx) -> seconds tables.  ``bwd_table`` holds measured
    backward-unit durations (e.g. from the fused flash-backward kernel via
    :func:`measure_kernel_cost_table`); absent, t_bwd falls back to the
    2·fwd convention."""

    def __init__(self, table: Dict[Tuple[int, int], float],
                 granularity: int = 1,
                 bwd_table: Optional[Dict[Tuple[int, int], float]] = None):
        self.table = dict(table)
        self.bwd_table = dict(bwd_table) if bwd_table else None
        self.g = granularity

    def _key(self, l: int, ctx: int) -> Tuple[int, int]:
        return (self.g * int(round(l / self.g)),
                self.g * int(round(ctx / self.g)))

    def t_fwd(self, l: int, ctx: int) -> float:
        return self.table[self._key(l, ctx)]

    def t_bwd(self, l: int, ctx: int) -> float:
        if self.bwd_table is None:
            return 2.0 * self.t_fwd(l, ctx)
        return self.bwd_table[self._key(l, ctx)]


def measure_kernel_cost_table(pairs, *, batch: int = 1, n_heads: int = 8,
                              n_kv_heads: Optional[int] = None,
                              head_dim: int = 64, dtype=None,
                              granularity: int = 1, n_iters: int = 5,
                              device="cuda") -> TableCostModel:
    """Measured t_fwd/t_bwd entries from the port's attention kernels.

    On each ``(l, ctx)`` pair, times the forward kernel and, on one saved
    forward's ``(O, lse)`` and ``delta = rowsum(dO·O)``, the dQ and dK/dV
    kernels the executor's backward runs, and returns a
    :class:`TableCostModel` with both tables (the paper's live-cluster
    measurement loop, §4.1).  The backward entry is the two kernels alone,
    with none of the host's autograd dispatch around them.  On ``cuda`` each
    entry is the median device time of ``n_iters`` calls by CUDA events
    (:func:`repro_torch.timing.time_ms`); on the CPU it is the mean wall
    clock of the plain versions, good for the table's shape only.
    """
    import time

    from repro_torch.kernels.ref import terapipe_attention_bwd_ref, terapipe_attention_ref
    from repro_torch.kernels.terapipe_attention import terapipe_attention_fwd
    from repro_torch.kernels.terapipe_attention_bwd import terapipe_attention_bwd

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    fwd = terapipe_attention_fwd if on_card else terapipe_attention_ref
    bwd = terapipe_attention_bwd if on_card else terapipe_attention_bwd_ref
    hkv = n_kv_heads or n_heads
    dtype = dtype or torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    fwd_tab: Dict[Tuple[int, int], float] = {}
    bwd_tab: Dict[Tuple[int, int], float] = {}
    for l, ctx in pairs:
        sk = ctx + l
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((batch, l, n_heads, head_dim), (batch, sk, hkv, head_dim),
                                     (batch, sk, hkv, head_dim), (batch, l, n_heads, head_dim)))
        out, lse = fwd(q, k, v, ctx)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        run_fwd = lambda: fwd(q, k, v, ctx)
        run_bwd = lambda: bwd(q, k, v, do, lse, delta, ctx)
        if on_card:
            t_f = time_ms(run_fwd, iters=n_iters) / 1e3
            t_b = time_ms(run_bwd, iters=n_iters) / 1e3
        else:
            def wall(fn):
                fn()
                t0 = time.perf_counter()
                for _ in range(n_iters):
                    fn()
                return (time.perf_counter() - t0) / n_iters
            t_f, t_b = wall(run_fwd), wall(run_bwd)
        key = (granularity * int(round(l / granularity)),
               granularity * int(round(ctx / granularity)))
        fwd_tab[key] = t_f
        bwd_tab[key] = max(t_b, t_f)            # floored at the forward
    return TableCostModel(fwd_tab, granularity=granularity, bwd_table=bwd_tab)


class BilinearFitCostModel(CostModel):
    """The paper's Eq. 9 estimator.

    t(i, j) = t_base(i) + a0 + a1 i + a2 j + a3 i j, where t_base(i) = t(i, 0)
    is measured for every i and the context overhead is a bilinear fit on a
    subset of (i, j) samples.
    """

    def __init__(self, t_base: Callable[[int], float], coeffs: np.ndarray):
        self.t_base = t_base
        self.a = np.asarray(coeffs, dtype=np.float64)

    @classmethod
    def fit(cls, truth: CostModel, L: int, *, n_samples: int = 256,
            seed: int = 0) -> "BilinearFitCostModel":
        rng = np.random.default_rng(seed)
        ii = rng.integers(1, L + 1, n_samples)
        jj = rng.integers(0, L, n_samples)
        y = np.array([truth(int(i), int(j)) - truth(int(i), 0)
                      for i, j in zip(ii, jj)])
        X = np.stack([np.ones_like(ii), ii, jj, ii * jj], axis=1).astype(np.float64)
        coeffs, *_ = np.linalg.lstsq(X, y, rcond=None)
        base = {i: truth(i, 0) for i in range(1, L + 1)}
        return cls(lambda i: base[i], coeffs)

    def t_fwd(self, l: int, ctx: int) -> float:
        a0, a1, a2, a3 = self.a
        return self.t_base(l) + a0 + a1 * l + a2 * ctx + a3 * l * ctx

    def relative_error(self, truth: CostModel, L: int, n: int = 512,
                       seed: int = 1) -> float:
        rng = np.random.default_rng(seed)
        errs = []
        for _ in range(n):
            i = int(rng.integers(1, L + 1))
            j = int(rng.integers(0, L))
            t_true, t_est = truth(i, j), self.t_fwd(i, j)
            errs.append(abs(t_est - t_true) / max(t_true, 1e-12))
        return float(np.mean(errs))


def fit_efficiency_and_floor(cfg: ModelConfig, hw: HardwareSpec, layers_per_stage: int,
                             lengths, seconds, *, batch: int = 1) -> Tuple[float, int]:
    """``(efficiency, occupancy_floor)`` of :class:`AnalyticCostModel` on
    ``hw`` fitted to measured forward times of one stage at ctx 0 (the
    paper's Fig. 3): for every integer floor f the model predicts
    ``t(l) = flops(max(l, f)) / (peak · efficiency)``; the floor and the
    efficiency that minimise the squared log error win.  Only ``hw``'s
    peak rate is read: the fit is of one stage's compute, with no link."""
    ideal = AnalyticCostModel(
        cfg, dataclasses.replace(hw, efficiency=1.0, occupancy_floor=1, link_latency=0.0,
                                 link_bw=float("inf")),
        layers_per_stage=layers_per_stage, batch=batch, include_backward=False)
    lengths = np.asarray(lengths, np.float64)
    log_t = np.log(np.asarray(seconds, np.float64))
    floors = np.arange(1, int(lengths.max()) + 1, dtype=np.float64)
    # (floors, points): log of the ideal time at max(l, f)
    log_ideal = np.log(ideal.t_fwd(np.maximum(lengths[None, :], floors[:, None]), 0))
    log_scale = (log_t[None, :] - log_ideal).mean(axis=1)
    err = ((log_t[None, :] - log_ideal - log_scale[:, None]) ** 2).sum(axis=1)
    best = int(np.argmin(err))
    return float(np.exp(-log_scale[best])), int(floors[best])
