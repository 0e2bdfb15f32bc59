"""The plain reference model: a pre-norm decoder with RoPE attention and a
SwiGLU FFN, or DeepSeekMoE's FFN (shared experts beside top-k routed
experts, routed in fixed groups of ``moe_block`` tokens with a capacity
per expert and group), and the mean next-token cross-entropy.

Plain PyTorch on flat parameter dicts (``path -> tensor``), written from
the configuration files under ``perfbench/configs``.  It imports nothing
of the program.  Every product goes through ``mm`` (``torch.matmul`` by
default), so a caller can compute the same model in a lower precision.

Parameter layout (the program's, checked by the harness against the
program's own tree): weights ``(d_in, d_out)`` applied as ``x @ w``;
per-layer leaves stacked on a leading layer axis; norm scales ``s``
applied as ``(1 + s)``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]


def _attn_shapes(cfg: dict, n: int) -> List[Tuple[str, tuple, str]]:
    d, hd = cfg["d_model"], cfg["head_dim"]
    return [("attn/wq", (n, d, cfg["n_heads"] * hd), "dense"),
            ("attn/wk", (n, d, cfg["n_kv_heads"] * hd), "dense"),
            ("attn/wv", (n, d, cfg["n_kv_heads"] * hd), "dense"),
            ("attn/wo", (n, cfg["n_heads"] * hd, d), "dense")]


def _ffn_shapes(prefix: str, n: int, d: int, f: int) -> List[Tuple[str, tuple, str]]:
    return [(f"{prefix}/w_gate", (n, d, f), "dense"), (f"{prefix}/w_up", (n, d, f), "dense"),
            (f"{prefix}/w_down", (n, f, d), "dense")]


def groups(cfg: dict) -> List[Tuple[str, int, str]]:
    """``[(group, layers, kind)]`` in stack order: the dense stack, or
    ``first_dense_layers`` dense layers before the MoE layers."""
    if cfg["family"] == "dense":
        return [("blocks", cfg["n_layers"], "dense")]
    first = cfg["first_dense_layers"]
    return [("dense0", first, "dense"), ("moe", cfg["n_layers"] - first, "moe")]


def param_shapes(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """Every leaf as ``(path, shape, init)`` in the order the program's
    tree holds them; ``init`` is ``embed`` (normal, std 0.02), ``dense``
    (normal over fan-in) or ``zeros``."""
    d, v = cfg["d_model"], cfg["vocab_size"]
    out = [("embed", (v, d), "embed")]
    for name, n, kind in groups(cfg):
        leaves = _attn_shapes(cfg, n)
        if kind == "dense":
            leaves += _ffn_shapes("ffn", n, d, cfg["d_ff"])
        else:
            e, fe = cfg["n_experts"], cfg["d_expert"]
            leaves += [("moe/router", (n, d, e), "dense"),
                       ("moe/w_gate", (n, e, d, fe), "dense"),
                       ("moe/w_up", (n, e, d, fe), "dense"),
                       ("moe/w_down", (n, e, fe, d), "dense")]
            leaves += _ffn_shapes("moe/shared", n, d, cfg["n_shared_experts"] * fe)
        leaves += [("ln_attn", (n, d), "zeros"), ("ln_ffn", (n, d), "zeros")]
        out += [(f"groups/{name}/{p}", s, i) for p, s, i in leaves]
    out.append(("final_ln", (d,), "zeros"))
    out.append(("lm_head", (d, v), "embed"))
    return out


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, split halves: x (B, S, H, hd) at positions 0..S-1."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: Params, cfg: dict, x: torch.Tensor, mm: Callable) -> torch.Tensor:
    """Causal softmax attention over the whole sequence."""
    b, s, _ = x.shape
    h, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = rope(mm(x, p["wq"]).view(b, s, h, hd), cfg["rope_theta"]) / math.sqrt(hd)
    k = rope(mm(x, p["wk"]).view(b, s, hkv, hd), cfg["rope_theta"])
    v = mm(x, p["wv"]).view(b, s, hkv, hd)
    k, v = (t.repeat_interleave(h // hkv, dim=2) for t in (k, v))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))                 # (B, H, S, hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    # in place: the product's backward does not read its output
    scores = mm(q, k.transpose(-1, -2)).masked_fill_(~causal, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = mm(probs, v).transpose(1, 2).reshape(b, s, h * hd)
    return mm(out, p["wo"])


def swiglu_ffn(p: Params, x: torch.Tensor, mm: Callable) -> torch.Tensor:
    return mm(F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"]), p["w_down"])


def moe_ffn(p: Params, cfg: dict, x: torch.Tensor, mm: Callable) -> torch.Tensor:
    """DeepSeekMoE's FFN as the program runs it: each group of
    ``moe_block`` consecutive tokens of a row is routed on its own; the
    router's softmax picks the top ``moe_top_k`` experts, whose weights are
    renormalised to sum to 1; a group's choices queue for each expert in
    token-major order, and an expert takes the first
    ``ceil(capacity_factor * moe_block * k / n_experts)`` of them; a choice
    past that adds nothing.  The shared experts see every token."""
    b, s, d = x.shape
    e, k = cfg["n_experts"], cfg["moe_top_k"]
    blk = min(cfg["moe_block"], s)
    xg = x.reshape(-1, blk, d)                                        # (G, blk, D)
    gates = torch.softmax(mm(xg, p["router"]), dim=-1)
    topw, topi = torch.topk(gates, k, dim=-1)                         # (G, blk, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    capacity = max(1, math.ceil(cfg["capacity_factor"] * blk * k / e))
    flat_e = topi.reshape(topi.shape[0], blk * k)                     # token-major choices
    queue = torch.cumsum(F.one_hot(flat_e, e), dim=1)
    pos = torch.gather(queue, 2, flat_e[..., None])[..., 0] - 1
    keep = (pos < capacity).reshape(-1)
    chosen = flat_e.reshape(-1)
    weight = topw.reshape(-1)
    tokens = x.reshape(-1, d)
    vals, rows = [], []
    for j in range(e):
        sel = torch.nonzero(keep & (chosen == j))[:, 0]             # flat (token, choice)
        xe = tokens[sel // k]
        ye = mm(F.silu(mm(xe, p["w_gate"][j])) * mm(xe, p["w_up"][j]), p["w_down"][j])
        vals.append(ye * weight[sel, None])
        rows.append(sel)
    per_choice = tokens.new_zeros(tokens.shape[0] * k, d).index_copy(
        0, torch.cat(rows), torch.cat(vals))
    routed = per_choice.view(-1, k, d).sum(1).view(b, s, d)
    shared = {n: p[f"shared/{n}"] for n in ("w_gate", "w_up", "w_down")}
    return routed + swiglu_ffn(shared, x, mm)


def layer(p: Params, cfg: dict, kind: str, x: torch.Tensor, mm: Callable) -> torch.Tensor:
    eps = cfg["norm_eps"]
    x = x + attention({n: p[f"attn/{n}"] for n in ("wq", "wk", "wv", "wo")}, cfg,
                      rms_norm(x, p["ln_attn"], eps), mm)
    h = rms_norm(x, p["ln_ffn"], eps)
    if kind == "dense":
        return x + swiglu_ffn({n: p[f"ffn/{n}"] for n in ("w_gate", "w_up", "w_down")}, h, mm)
    return x + moe_ffn({n[4:]: t for n, t in p.items() if n.startswith("moe/")}, cfg, h, mm)


def layer_params(params: Params, group: str, i: int) -> Params:
    head = f"groups/{group}/"
    return {n[len(head):]: t[i] for n, t in params.items() if n.startswith(head)}


def head_loss_sum(params: Params, cfg: dict, x: torch.Tensor, labels: torch.Tensor,
                  mm: Callable) -> torch.Tensor:
    """The summed cross-entropy of the rows ``x`` against ``labels``."""
    logits = mm(rms_norm(x, params["final_ln"], cfg["norm_eps"]), params["lm_head"])
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


def loss_sum(params: Params, cfg: dict, tokens: torch.Tensor, labels: torch.Tensor,
             mm: Callable = torch.matmul, remat: bool = True) -> torch.Tensor:
    """The summed next-token cross-entropy of a block of rows; each layer
    and the head under ``checkpoint`` when ``remat`` (only the layers'
    inputs are kept for the backward pass)."""
    x = params["embed"][tokens.long()]
    for group, n, kind in groups(cfg):
        for i in range(n):
            fn = lambda lp, x, kind=kind: layer(lp, cfg, kind, x, mm)
            lp = layer_params(params, group, i)
            x = checkpoint(fn, lp, x, use_reentrant=False) if remat else fn(lp, x)
    fn = lambda x, labels: head_loss_sum(params, cfg, x, labels, mm)
    return checkpoint(fn, x, labels, use_reentrant=False) if remat else fn(x, labels)
