"""Architecture registry (reference: ``repro/configs/__init__.py``,
``get_config``): every architecture of ``ARCHS`` and ``PAPER_ARCHS``, each
in its own module with ``FULL`` (the published config) and ``SMOKE`` (a
reduced config of the same family for CPU tests).  The dry-run shapes
(``SHAPES``, ``input_specs``) wait for the meta-device dryrun (ROADMAP
Queue 1 item 10).
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

_MODULES = {"phi3-mini-3.8b": "phi3_mini", "qwen3-0.6b": "qwen3_0_6b",
            "phi4-mini-3.8b": "phi4_mini", "stablelm-12b": "stablelm_12b",
            "whisper-medium": "whisper_medium", "qwen3-moe-235b-a22b": "qwen3_moe",
            "deepseek-moe-16b": "deepseek_moe", "mamba2-2.7b": "mamba2",
            "recurrentgemma-9b": "recurrentgemma", "phi-3-vision-4.2b": "phi3_vision",
            "gpt3-1b": "gpt3", "gpt3-13b": "gpt3", "gpt3-44b": "gpt3", "gpt3-175b": "gpt3"}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    if arch.startswith("gpt3"):
        return (mod.SMOKE if smoke else mod.FULL)[arch]
    return mod.SMOKE if smoke else mod.FULL
