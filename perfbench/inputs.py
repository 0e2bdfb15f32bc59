"""What the benchmark makes from ``--seed`` and hands to the program and to
the reference alike: the weights and the batches.

Weights: one ``torch.Generator`` on the device per leaf, seeded from the
seed and the leaf's index, one draw per leaf (each layer stack is one
leaf), float32 as the program stores them: the embedding and the head
normal with std 0.02, every other matrix normal over its fan-in, norm
scales zero.  Any leaf can be made again alone, bit for bit.

Batches: step ``i``'s tokens drawn uniformly over the vocabulary by a
generator seeded from the seed and ``i``, ``(B, S + 1)`` of them; the
labels are the tokens shifted by one.  Every step's rows differ.
"""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference.model import param_shapes

_MASK63 = (1 << 63) - 1


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for ``stream`` of ``seed`` (any integer)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (stream + 1) * 0xBF58476D1CE4E5B9) & _MASK63
    x ^= x >> 31
    return (x * 0x94D049BB133111EB) & _MASK63


class Weights:
    """The weights of configuration ``cfg`` for ``seed`` on ``device``."""

    def __init__(self, cfg: dict, seed: int, device):
        self.shapes = param_shapes(cfg)
        self.index = {p: i for i, (p, _, _) in enumerate(self.shapes)}
        self.seed, self.device = seed, torch.device(device)

    def leaf(self, path: str) -> torch.Tensor:
        i = self.index[path]
        _, shape, init = self.shapes[i]
        if init == "zeros":
            return torch.zeros(shape, dtype=torch.float32, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(stream_seed(self.seed, i))
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=self.device)
        return x.mul_(0.02 if init == "embed" else shape[-2] ** -0.5)

    def all(self) -> Dict[str, torch.Tensor]:
        return {p: self.leaf(p) for p, _, _ in self.shapes}


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """``{"a/b": t}`` as ``{"a": {"b": t}}``, in the same order."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    return out


def make_batch(vocab: int, batch: int, seq: int, seed: int, step: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 1_000_000 + step))
    toks = torch.randint(0, vocab, (batch, seq + 1), generator=gen, device=device)
    return {"tokens": toks[:, :-1].to(torch.int32).contiguous(),
            "labels": toks[:, 1:].to(torch.int32).contiguous()}
