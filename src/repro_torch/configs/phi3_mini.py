"""phi3-mini-3.8b [dense] (reference: ``repro/configs/phi3_mini.py``),
arXiv:2404.14219.
32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064 — RoPE SwiGLU GQA."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064,
)

SMOKE = ModelConfig(
    name="phi3-mini-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, remat=False,
)
