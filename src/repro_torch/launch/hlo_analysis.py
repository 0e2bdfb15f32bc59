"""Roofline terms and model arithmetic of the dry run (reference:
``repro/launch/hlo_analysis.py``), with the same formulas.

The reference reads its collective bytes from optimized HLO text
(``collective_bytes``); the port has no HLO and counts them on its own
traced step (``launch/instruments.py``), weighting each collective by the
same ring multipliers (:data:`COLLECTIVE_MULT`, the wire bytes per chip of
one op's payload):

    all-reduce         2 (N-1)/N  ~ 2x payload
    all-gather         (N-1)/N    (payload = gathered output)
    reduce-scatter     (N-1)/N    (payload = scattered input)
    all-to-all         (N-1)/N
    collective-permute 1          (point-to-point)

The hardware constants are an H100 SXM's and are arguments everywhere
(a test passes the reference's v5e values and compares):

* ``PEAK_FLOPS`` 989 TFLOP/s dense bf16 and ``HBM_BW`` 3.35 TB/s, the
  NVIDIA data sheet's, as ``repro_torch/timing.py`` uses them for the
  kernels' bounds;
* ``LINK_BW`` 450 GB/s: NVLink 4, 18 links of 25 GB/s each way, the data
  sheet's "900 GB/s" counted in both directions halved to one (a ring
  step sends and receives at once).  ``core/cost_model.py``'s ``H100`` has
  no link term (one card); this is the figure for the four-card host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.timing import PEAK_BF16_FLOPS, PEAK_BYTES

PEAK_FLOPS = PEAK_BF16_FLOPS
HBM_BW = PEAK_BYTES
LINK_BW = 450e9

#: the reference's ring multipliers (``hlo_analysis.py:39-45``)
COLLECTIVE_MULT = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


@dataclasses.dataclass
class Roofline:
    """All inputs are PER-DEVICE quantities (the dry run's per-device
    program); ``model_flops`` is global.  The constants default to the
    card's."""
    flops: float                 # traced FLOPs (per device, per step)
    bytes_accessed: float        # traced bytes (per device)
    coll_bytes: float            # wire bytes (per device, ring-weighted)
    n_chips: int
    model_flops: Optional[float] = None   # 6*N*D useful flops (GLOBAL)
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / global traced flops (remat/redundancy waste <=> <1)."""
        if self.model_flops:
            return self.model_flops / (self.flops * self.n_chips)
        return None

    def to_dict(self):
        return {
            "flops": self.flops, "bytes_accessed": self.bytes_accessed,
            "coll_bytes": self.coll_bytes, "n_chips": self.n_chips,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "model_flops": self.model_flops, "useful_ratio": self.useful_ratio,
        }


def analytic_memory_per_device(cfg, seq_len: int, global_batch: int,
                               kind: str, n_chips: int, *,
                               model_shard: int = 16, fsdp: bool = True
                               ) -> Dict[str, float]:
    """Deterministic per-device HBM estimate (bytes), the reference's:
    params (fp32, TP×FSDP-sharded) + adam m,v (fp32) + grads + activation
    checkpoints (1 bf16 (B,S,d) stack per layer under full remat) + peak
    per-layer transient + KV cache for decode shapes."""
    total = total_param_count(cfg)
    shard = n_chips if fsdp else model_shard
    p_bytes = 4 * total / shard
    if kind == "train":
        opt_bytes = 8 * total / shard
        grad_bytes = 4 * total / shard
        b_loc = max(1, global_batch // (n_chips // model_shard))
        act_ckpt = 2 * b_loc * seq_len * cfg.d_model * _eff_layers(cfg)
        transient = 4 * b_loc * 1024 * seq_len  # one f32 attn-logit chunk
        transient += 2 * b_loc * seq_len * max(cfg.d_ff, 3 * cfg.d_model) / model_shard
        kv = 0.0
    else:
        opt_bytes = grad_bytes = 0.0
        p_bytes = 2 * total / shard              # serving: bf16 weights
        b_loc = max(1, global_batch // (n_chips // model_shard))
        act_ckpt = 0.0
        tokens = seq_len if kind == "prefill" else 1
        transient = 2 * b_loc * tokens * cfg.d_model * 4
        kv_len = min(seq_len, cfg.window) if cfg.window else seq_len
        if cfg.family == "ssm":
            d_inner = cfg.ssm_expand * cfg.d_model
            kv = 4 * cfg.n_layers * b_loc * (d_inner // cfg.ssm_head_dim) * \
                cfg.ssm_head_dim * cfg.ssm_state
        else:
            kv_heads = max(1, cfg.n_kv_heads // model_shard)
            n_attn = _attn_layers(cfg)
            kv = 2 * 2 * n_attn * b_loc * kv_len * kv_heads * cfg.hd
            if cfg.family == "hybrid":
                kv += 4 * cfg.n_layers * b_loc * cfg.d_model  # LRU states
    out = {"params": p_bytes, "opt": opt_bytes, "grads": grad_bytes,
           "act_ckpt": act_ckpt, "transient": transient, "kv": kv}
    out["total"] = sum(out.values())
    return out


def analytic_min_bytes(cfg, seq_len: int, global_batch: int, kind: str,
                       n_chips: int, model_shard: int = 16) -> float:
    """Per-device HBM traffic LOWER BOUND (bytes/step), the reference's:
    perfect fusion, weights read once per pass (fwd+bwd+remat = 3 for
    train), the residual stream read+written twice per layer per pass,
    plus KV/attention traffic."""
    p_local = 4 * total_param_count(cfg) / n_chips     # fsdp-sharded fp32
    d = cfg.d_model
    if kind == "train":
        b_loc = max(1, global_batch // (n_chips // model_shard))
        passes = 3.0
        weights = passes * p_local * model_shard       # gathered per pass
        stream = passes * 4 * b_loc * seq_len * d * _eff_layers(cfg) * 2
        grads = 3 * p_local                            # grad write + opt r/w
        return weights + stream + grads
    b_loc = max(1, global_batch // (n_chips // model_shard))
    tokens = seq_len if kind == "prefill" else 1
    weights = 2 * total_param_count(cfg) / n_chips * model_shard
    stream = 2 * 2 * b_loc * tokens * d * _eff_layers(cfg)
    kv = 0.0
    if kind == "decode" and cfg.family not in ("ssm",):
        kv_len = min(seq_len, cfg.window) if cfg.window else seq_len
        kv_heads = max(1, cfg.n_kv_heads // model_shard)
        kv = 2 * 2 * _attn_layers(cfg) * b_loc * kv_len * kv_heads * cfg.hd
    return weights + stream + kv


def _eff_layers(cfg) -> int:
    if cfg.family == "encdec":
        return (cfg.n_enc_layers or cfg.n_layers) + (cfg.n_dec_layers or cfg.n_layers)
    return cfg.n_layers


def _attn_layers(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // len(cfg.block_pattern)
    if cfg.family == "encdec":
        return 2 * (cfg.n_dec_layers or cfg.n_layers)   # self + cross
    return cfg.n_layers


def _params(cfg, n_ff_experts) -> float:
    """The reference's count, with ``n_ff_experts`` experts of the MoE FFN
    touched (all of them for the total, top-k for the active count)."""
    d, hd = cfg.d_model, cfg.hd
    attn = d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
    if cfg.family == "moe" or cfg.n_experts:
        ff = 3 * d * cfg.d_expert * (n_ff_experts + cfg.n_shared_experts)
        ff += d * cfg.n_experts
        n = cfg.n_layers * (attn + ff)
    elif cfg.family == "ssm":
        d_inner = cfg.ssm_expand * d
        h = d_inner // cfg.ssm_head_dim
        n = cfg.n_layers * (d * (2 * d_inner + 2 * cfg.ssm_state + h) + d_inner * d)
    elif cfg.family == "hybrid":
        rec = 6 * d * d
        att = attn + 3 * d * cfg.d_ff
        pat = len(cfg.block_pattern) or 3
        n = cfg.n_layers * ((pat - 1) * rec + att) / pat
    elif cfg.family == "encdec":
        n = ((cfg.n_enc_layers or cfg.n_layers) * (attn + 3 * d * cfg.d_ff)
             + (cfg.n_dec_layers or cfg.n_layers) * (2 * attn + 3 * d * cfg.d_ff))
    else:
        n = cfg.n_layers * (attn + 3 * d * cfg.d_ff)
    n += cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return float(n)


def total_param_count(cfg) -> float:
    return _params(cfg, cfg.n_experts)


def active_param_count(cfg) -> float:
    """Parameters touched per token (MoE: top-k + shared experts only)."""
    return _params(cfg, cfg.moe_top_k)


def model_flops_train(cfg, seq_len: int, global_batch: int) -> float:
    """6·N_active·D useful train flops (fwd+bwd)."""
    return 6.0 * active_param_count(cfg) * seq_len * global_batch


def model_flops_forward(cfg, tokens: float) -> float:
    return 2.0 * active_param_count(cfg) * tokens
