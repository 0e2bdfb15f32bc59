"""Architecture registry and assigned input shapes (reference:
``repro/configs/__init__.py``): every architecture of ``ARCHS`` and
``PAPER_ARCHS``, each in its own module with ``FULL`` (the published
config) and ``SMOKE`` (a reduced config of the same family for CPU tests);
the dry-run shapes ``SHAPES``, the cells they exclude (``skip_reason``)
and ``input_specs``, a cell's batch as tensors on the ``meta`` device
(shapes and dtypes, no storage).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

import torch

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

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


def skip_reason(arch: str, shape: str) -> Optional[str]:
    """Why a cell is excluded from the dry-run grid, or ``None``."""
    cfg = get_config(arch)
    if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return ("pure full-attention arch: 524k dense decode KV cache exceeds any "
                "HBM budget; shape reserved for sub-quadratic families (DESIGN.md §5)")
    return None


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """One (arch x shape) cell's batch on the ``meta`` device: int32
    tokens and labels, bf16 ``patch_embeds`` (vlm, whose text is the
    sequence less its ``n_patches`` patch rows) and ``frames`` (enc-dec).

    train   -> the batch of ``train_step(params, opt_state, batch)``
    prefill -> the batch of ``prefill_step(params, batch)``
    decode  -> the batch of ``decode_step(params, caches, batch, pos)``:
               one new token against a ``seq_len``-deep cache
    """
    B, S = shape.global_batch, shape.seq_len
    meta = lambda shp, dtype=torch.int32: torch.empty(shp, dtype=dtype, device="meta")
    patches = lambda: meta((B, cfg.n_patches, cfg.d_model), torch.bfloat16)
    frames = lambda: meta((B, S, cfg.d_model), torch.bfloat16)

    if shape.kind == "train":
        if cfg.family == "vlm":
            t = S - cfg.n_patches
            return {"tokens": meta((B, t)), "labels": meta((B, t)), "patch_embeds": patches()}
        if cfg.family == "encdec":
            return {"frames": frames(), "tokens": meta((B, S)), "labels": meta((B, S))}
        return {"tokens": meta((B, S)), "labels": meta((B, S))}
    if shape.kind == "prefill":
        if cfg.family == "vlm":
            return {"tokens": meta((B, S - cfg.n_patches)), "patch_embeds": patches()}
        batch = {"tokens": meta((B, S))}
        if cfg.family == "encdec":
            batch["frames"] = frames()
        return batch
    return {"tokens": meta((B, 1))}
