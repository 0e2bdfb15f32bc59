"""qwen3-moe-235b-a22b [moe] (reference: ``repro/configs/qwen3_moe.py``),
hf:Qwen/Qwen3-235B-A22B family.
94L d_model=4096 64H (GQA kv=4) d_ff=1536(expert) vocab=151936, MoE 128e top-8.
No shared experts (Qwen3-MoE convention); head_dim=128, qk_norm."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=128, qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128, moe_top_k=8, d_expert=1536,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab_size=256, head_dim=32, qk_norm=True,
    n_experts=8, moe_top_k=2, d_expert=96, moe_block=8, remat=False,
)
