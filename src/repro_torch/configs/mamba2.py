"""mamba2-2.7b [ssm] (reference: ``repro/configs/mamba2.py``), arXiv:2405.21060
(SSD / state-space duality).
64L d_model=2560 (attn-free) vocab=50280, ssm_state=128.
expand=2 -> d_inner=5120, head_dim=64 -> 80 SSD heads."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=80, n_kv_heads=80,  # SSD heads (informational)
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=256,
    ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_conv=4, ssm_chunk=16,
    remat=False,
)
