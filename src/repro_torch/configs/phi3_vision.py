"""phi-3-vision-4.2b [vlm] (reference: ``repro/configs/phi3_vision.py``),
hf:microsoft/Phi-3-vision-128k-instruct.
32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064 — the phi3-mini
backbone; the CLIP frontend is stubbed: the batch carries precomputed patch
embeddings (B, n_patches=576, d_model), prepended to the token stream."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064, n_patches=576,
)

SMOKE = ModelConfig(
    name="phi3-vision-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, n_patches=4, remat=False,
)
