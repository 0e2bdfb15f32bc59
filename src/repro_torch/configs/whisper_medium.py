"""whisper-medium [audio, enc-dec backbone] (reference:
``repro/configs/whisper_medium.py``), arXiv:2212.04356.
24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865 — encoder-decoder; the
conv frontend is stubbed: the batch carries precomputed frame embeddings
(B, S, d_model).  24 encoder + 24 decoder layers (whisper-medium's layout);
positions by RoPE, as in the reference's backbone config."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, n_dec_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, n_dec_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, remat=False,
)
