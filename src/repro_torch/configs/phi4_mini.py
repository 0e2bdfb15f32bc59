"""phi4-mini-3.8b [dense] (reference: ``repro/configs/phi4_mini.py``),
arXiv:2412.08905.
32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 — RoPE SwiGLU GQA."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=200064,
)

SMOKE = ModelConfig(
    name="phi4-mini-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=192, vocab_size=256, remat=False,
)
