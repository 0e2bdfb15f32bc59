"""Architecture registry (reference: ``repro/configs/__init__.py``,
``get_config``).  Only the architectures the port runs are importable; the
others raise ``NotImplementedError`` until their family is ported.  The
dry-run shapes (``SHAPES``, ``input_specs``) wait for the planning slice.
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCHS = [
    "phi3-mini-3.8b", "qwen3-0.6b", "phi4-mini-3.8b", "stablelm-12b",
    "whisper-medium", "qwen3-moe-235b-a22b", "deepseek-moe-16b",
    "mamba2-2.7b", "recurrentgemma-9b", "phi-3-vision-4.2b",
]
PAPER_ARCHS = ["gpt3-1b", "gpt3-13b", "gpt3-44b", "gpt3-175b"]

_PORTED = {"phi3-mini-3.8b": "phi3_mini", "qwen3-0.6b": "qwen3_0_6b",
           "phi4-mini-3.8b": "phi4_mini", "stablelm-12b": "stablelm_12b",
           "qwen3-moe-235b-a22b": "qwen3_moe", "deepseek-moe-16b": "deepseek_moe",
           "mamba2-2.7b": "mamba2", "recurrentgemma-9b": "recurrentgemma",
           "gpt3-1b": "gpt3", "gpt3-13b": "gpt3", "gpt3-44b": "gpt3", "gpt3-175b": "gpt3"}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS and arch not in PAPER_ARCHS:
        raise KeyError(f"unknown arch {arch!r}")
    if arch not in _PORTED:
        raise NotImplementedError(f"{arch}: not yet ported")
    mod = importlib.import_module(f"repro_torch.configs.{_PORTED[arch]}")
    if arch.startswith("gpt3"):
        return (mod.SMOKE if smoke else mod.FULL)[arch]
    return mod.SMOKE if smoke else mod.FULL
