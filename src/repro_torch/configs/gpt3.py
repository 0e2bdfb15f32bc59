"""GPT-3 family, the paper's own evaluation models (Table 1) (reference:
``repro/configs/gpt3.py``).
GPT3-1B (24L, H=2048), GPT3-13B (40L, 5120), GPT3-44B (96L, 6144),
GPT3-175B (96L, 12288); L=2048, vocab 50257 (GPT-2 BPE).  Head dim 128,
no GQA, untied head, RoPE theta 1e4, remat on, bf16 activations."""
from repro_torch.models.common import ModelConfig


def _gpt3(name, n_layers, d_model):
    return ModelConfig(
        name=name, family="dense",
        n_layers=n_layers, d_model=d_model,
        n_heads=d_model // 128, n_kv_heads=d_model // 128,
        d_ff=4 * d_model, vocab_size=50257,
    )


FULL = {
    "gpt3-1b": _gpt3("gpt3-1b", 24, 2048),
    "gpt3-13b": _gpt3("gpt3-13b", 40, 5120),
    "gpt3-44b": _gpt3("gpt3-44b", 96, 6144),
    "gpt3-175b": _gpt3("gpt3-175b", 96, 12288),
}

_smoke = ModelConfig(
    name="gpt3-smoke", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=256, remat=False,
)
SMOKE = {k: _smoke.replace(name=f"{k}-smoke") for k in FULL}
