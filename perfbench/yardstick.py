"""The benchmark's arithmetic, from the configuration's shapes alone: the
chip's peaks, a step's model FLOPs, and the least time of the attention
work.

Model FLOPs of a training step: 6 per parameter and token over the
parameters that products use (each routed expert layer counted at
``moe_top_k`` of its experts; the embedding's gather not counted, the
head counted), plus causal attention at 12·hd per unmasked (query, key)
pair and head (4·hd forward, 8·hd backward).  Recomputation is not
counted.

Attention bounds (the arithmetic of ``repro_torch/timing.py::bound_ms``
and PERF.md's kernel table): the forward at 4·hd, dQ at 6·hd and dK/dV at
8·hd per pair and head, each kernel's inputs read and outputs written once
(bfloat16 tensors, float32 row statistics), at the larger of the FLOPs at
the bf16 peak and the bytes at the HBM rate.
"""
from __future__ import annotations

#: NVIDIA H100 SXM (data sheet): dense bf16 tensor-core FLOP/s, HBM3 bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def matmul_params(cfg: dict) -> int:
    """Parameters that one token's products use."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    attn = d * hd * (2 * cfg["n_heads"] + 2 * cfg["n_kv_heads"])
    dense_ffn = 3 * d * cfg["d_ff"]
    if cfg["family"] == "dense":
        layers = cfg["n_layers"] * (attn + dense_ffn)
    else:
        fe, first = cfg["d_expert"], cfg["first_dense_layers"]
        moe_ffn = (d * cfg["n_experts"] + cfg["moe_top_k"] * 3 * d * fe
                   + 3 * d * cfg["n_shared_experts"] * fe)
        layers = first * (attn + dense_ffn) + (cfg["n_layers"] - first) * (attn + moe_ffn)
    return layers + d * cfg["vocab_size"]


def attention_pairs(batch: int, seq: int, heads: int) -> int:
    """Unmasked causal (query, key) pairs times heads over a batch."""
    return batch * heads * seq * (seq + 1) // 2


def model_flops_per_step(cfg: dict, batch: int, seq: int) -> float:
    pairs = attention_pairs(batch, seq, cfg["n_heads"])
    return (6 * matmul_params(cfg) * batch * seq
            + 12 * cfg["head_dim"] * pairs * cfg["n_layers"])


def bound_s(flops: float, nbytes: float) -> float:
    """The least time of ``flops`` and ``nbytes`` on the chip."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def attention_bounds_s(cfg: dict, batch: int, seq: int) -> dict:
    """One layer's least time per kernel: ``fwd``, ``dq``, ``dkv``."""
    hd, h, hkv = cfg["head_dim"], cfg["n_heads"], cfg["n_kv_heads"]
    pairs = attention_pairs(batch, seq, h)
    q = batch * seq * h * hd * 2                 # bf16 q, O, dO, dQ
    kv = batch * seq * hkv * hd * 2              # bf16 k, v, dK, dV
    rows = batch * h * seq * 4                   # f32 lse, delta
    return {"fwd": bound_s(4 * hd * pairs, q + 2 * kv + q + rows),
            "dq": bound_s(6 * hd * pairs, 2 * q + 2 * kv + 2 * rows + q),
            "dkv": bound_s(8 * hd * pairs, 2 * q + 2 * kv + 2 * rows + 2 * kv)}


def attention_bound_per_step_s(cfg: dict, batch: int, seq: int) -> float:
    """Every layer's forward and backward attention at their bounds."""
    return cfg["n_layers"] * sum(attention_bounds_s(cfg, batch, seq).values())
