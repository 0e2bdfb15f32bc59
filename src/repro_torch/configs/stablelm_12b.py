"""stablelm-12b [dense] (reference: ``repro/configs/stablelm_12b.py``),
hf:stabilityai/stablelm-2-12b family.
40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab_size=100352,
)

SMOKE = ModelConfig(
    name="stablelm-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=192, vocab_size=256, remat=False,
)
