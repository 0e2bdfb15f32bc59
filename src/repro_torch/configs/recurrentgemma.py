"""recurrentgemma-9b [hybrid] (reference: ``repro/configs/recurrentgemma.py``),
arXiv:2402.19427 (Griffin).
38L d_model=4096 16H (GQA kv=1, i.e. MQA) d_ff=12288 vocab=256000 —
RG-LRU + local attention, pattern (rec, rec, attn), window 2048.
38 = 12 × (rec,rec,attn) super-blocks + 2 tail rec blocks."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab_size=256000,
    window=2048, block_pattern=("rec", "rec", "attn"),
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab_size=256,
    window=16, block_pattern=("rec", "rec", "attn"), remat=False,
)
