"""deepseek-moe-16b [moe] (reference: ``repro/configs/deepseek_moe.py``),
arXiv:2401.06066.
28L d_model=2048 16H (kv=16) d_ff=1408(expert) vocab=102400, MoE 64e top-6,
2 shared + 64 routed, fine-grained.  The first layer is a dense FFN (DeepSeek
convention) of width cfg.d_ff = 11264 = 8 x 1408, near the published 10944
and a multiple of 128."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=11264, vocab_size=102400,
    n_experts=64, moe_top_k=6, d_expert=1408, n_shared_experts=2,
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=192, vocab_size=256,
    n_experts=8, moe_top_k=2, d_expert=48, n_shared_experts=2, moe_block=8, remat=False,
)
