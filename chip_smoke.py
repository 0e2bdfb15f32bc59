"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line):
  1. build   — compile every CUDA kernel of the serving path from
               src/repro_torch/kernels/csrc with nvcc (sm_90a);
  2. kernels — hold each kernel against its plain PyTorch version on the
               card, bf16 (atol/rtol 2e-2) and f32 (2e-5), O and lse;
  3. serve   — qwen3-0.6b at full width (28 layers, random weights from a
               seeded generator, bf16, use_kernel=True) behind the
               continuous-batching DecodeEngine: 8 requests, once with one
               prefill chunk per prompt and once with SLO-split chunks;
               launch counts must equal (prefill chunks x 28) and
               (decode rounds x 28); continuous batching must reproduce the
               sequential engine's tokens;
  4. times   — each kernel at a main-path shape (CUDA events, median of 30
               after warm-up, L2 flushed before each launch) beside its
               bound, its plain version and one PyTorch library call.

The line before last is one JSON object {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Needs one CUDA GPU and nvcc.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_kernel  # noqa: E402
from repro_torch.kernels.ref import (decode_attention_ref,  # noqa: E402
                                     terapipe_attention_ref)
from repro_torch.kernels.terapipe_attention import terapipe_attention_fwd  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import DecodeEngine, EngineConfig  # noqa: E402

TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# f32 with logits scaled x30: rounding of |logits| ~ 100 shows in the
# probabilities; the reference holds that case at 1e-4
# (tests/test_kernels.py::test_kernel_softmax_stability)
TOL_F32_X30 = 1e-4
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12           # H100 SXM HBM3
N_LAYERS = 28                  # qwen3-0.6b


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------- 1. build
def phase_build() -> None:
    t0 = time.time()
    libs = _build.build_all()
    log(f"[build] {len(libs)} kernels built in {time.time() - t0:.1f} s")
    for path in libs.values():
        logf = Path(str(path) + ".log")
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {path.name}: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    log(f"[card] {smi.stdout.strip()}")


# ------------------------------------------------------------- 2. kernels
def _rand(shape, dtype, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _err(got, want, tol, what):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    diff = (got - want).abs()
    bad = diff > tol + tol * want.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements off, max abs err "
                             f"{diff.max().item():.3g} (tol {tol})")
    return diff.max().item()


def prefill_cases():
    """(B, l, ctx, Hq, Hkv, hd, logit_scale); Sk = ctx + l + 37 (stale tail)."""
    cases = [(1, l, ctx, 16, 8, 128, 1.0)
             for l in (1, 96, 100, 128, 1024) for ctx in (0, 256, 700)]
    cases += [(2, 100, 256, 16, 8, hd, 1.0) for hd in (32, 96, 160)]
    cases += [(2, 96, 256, 8, 8, 128, 1.0), (2, 100, 256, 16, 4, 128, 1.0),
              (2, 100, 256, 16, 8, 128, 30.0)]
    return cases


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"terapipe_attention_fwd": 0.0, "decode_attention": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        worst = 0.0
        for (b, l, ctx, hq, hkv, hd, sc) in prefill_cases():
            tol = TOL_F32_X30 if dtype == torch.float32 and sc > 1 else TOL[dtype]
            sk = ctx + l + 37
            q = _rand((b, l, hq, hd), dtype, gen, sc)
            k = _rand((b, sk, hkv, hd), dtype, gen)
            v = _rand((b, sk, hkv, hd), dtype, gen)
            out, lse = terapipe_attention_fwd(q, k, v, ctx)
            ref_out, ref_lse = terapipe_attention_ref(q, k, v, ctx)
            torch.cuda.synchronize()
            what = f"prefill {dtype} b={b} l={l} ctx={ctx} hq={hq} hkv={hkv} hd={hd} x{sc}"
            worst = max(worst, _err(out, ref_out, tol, what + " O"),
                        _err(lse, ref_lse, tol, what + " lse"))
        tol = TOL[dtype]
        log(f"[kernels] terapipe_attention_fwd {dtype}: {len(prefill_cases())} cases, "
            f"max abs err {worst:.3g} (tol {tol}; x30 logits in f32: {TOL_F32_X30})")
        errs["terapipe_attention_fwd"] = max(errs["terapipe_attention_fwd"], worst)

        worst = 0.0
        dec_cases = [(4, 2048, 16, 8, 128, [1, 2048, 700, 1333]),
                     (4, 2048, 16, 8, 128, 1500),
                     (4, 2048, 16, 8, 128, 1),
                     (3, 512, 16, 4, 160, [5, 512, 77]),
                     (3, 512, 8, 8, 32, [300, 1, 512])]
        for (b, L, hq, hkv, hd, kv_len) in dec_cases:
            q = _rand((b, 1, hq, hd), dtype, gen)
            k = _rand((b, L, hkv, hd), dtype, gen)
            v = _rand((b, L, hkv, hd), dtype, gen)
            lens = (torch.tensor(kv_len, dtype=torch.int32, device="cuda")
                    if isinstance(kv_len, list) else kv_len)
            out = decode_attention_kernel(q, k, v, lens)
            ref = decode_attention_ref(q, k, v, lens)
            torch.cuda.synchronize()
            worst = max(worst, _err(out, ref, tol, f"decode {dtype} b={b} L={L} "
                                    f"hq={hq} hkv={hkv} hd={hd} kv_len={kv_len}"))
        log(f"[kernels] decode_attention {dtype}: {len(dec_cases)} cases, "
            f"max abs err {worst:.3g} (tol {tol})")
        errs["decode_attention"] = max(errs["decode_attention"], worst)
    return errs


# --------------------------------------------------------------- 3. serve
GEN = 32
GEOM = dict(max_batch=4, max_len=2048, page_size=16, n_pages=4 * 128 + 1)
# chunk-cost units of overhead + l*(ctx+l): every chunk past ~l*(ctx+l)=1068
# is split, so prompts prefill in ~8-token chunks at ctx > 0.  plan_prefill
# walks every distinct cost below slo_tmax with an O(L^2) DP each, so the
# split run keeps its prompts at 128-256 tokens (see PERF.md).
SLO_TMAX = 1100.0


def _serve_run(model, params, prompts, label, slo_tmax=None):
    eng = DecodeEngine(model, params, EngineConfig(**GEOM, slo_tmax=slo_tmax))
    t0 = time.time()
    rids = [eng.submit(p, GEN) for p in prompts]
    plan_s = time.time() - t0
    terapipe_attention_fwd.launches = 0
    decode_attention_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {"terapipe_attention_fwd": terapipe_attention_fwd.launches,
              "decode_attention": decode_attention_kernel.launches}
    chunks = sum(u.kind == "prefill" for u in eng.units)
    rounds = sum(u.kind == "decode" for u in eng.units)
    if counts != {"terapipe_attention_fwd": chunks * N_LAYERS,
                  "decode_attention": rounds * N_LAYERS}:
        raise AssertionError(f"{label}: launches {counts} != {chunks} prefill chunks "
                             f"and {rounds} decode rounds x {N_LAYERS} layers")
    eng.schedule().validate(len(eng.units))
    toks = [eng.finished[r].generated for r in rids]
    vocab = model.cfg.vocab_size
    if any(len(t) != GEN or not all(0 <= x < vocab for x in t) for t in toks):
        raise AssertionError(f"{label}: malformed generations")
    n_tok = sum(len(t) for t in toks)
    log(f"[serve] {label}: {len(prompts)} requests, prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens, {n_tok} tokens in {eng.rounds} rounds "
        f"({chunks} prefill chunks, {rounds} decode rounds, max prefill ctx "
        f"{max(u.ctx[0] for u in eng.units if u.kind == 'prefill')}), wall "
        f"{wall:.3f} s, {n_tok / wall:.2f} tok/s, plan {plan_s:.3f} s; first-token "
        f"rounds {[eng.finished[r].first_token_round for r in rids]}; launches {counts}")
    return toks, counts


def _check_sequential(model, params, prompts, toks, label, slo_tmax=None):
    """The engine's bit-identity contract: the same engine at
    max_concurrency=1 reproduces the continuous run's tokens."""
    eng = DecodeEngine(model, params, EngineConfig(**GEOM, slo_tmax=slo_tmax,
                                                   max_concurrency=1))
    rids = [eng.submit(p, GEN) for p in prompts]
    eng.run()
    for i, r in enumerate(rids):
        if eng.finished[r].generated != toks[i]:
            raise AssertionError(f"{label}: request {i} differs from the sequential run")
    log(f"[serve] {label}: continuous == sequential for {len(rids)} requests")


def _check_against_plain(model, params):
    """Full-width logits through the kernels vs through the plain
    attention path, on one 128-token prompt and one decode step.  The
    bound is loose: over 28 bf16 layers the plain path rounds its
    probabilities to bf16 before PV, the kernels keep them in f32."""
    plain = build_model(model.cfg.replace(use_kernel=False))
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 128), generator=gen, device="cuda")
    nxt = toks[:, :1]
    pos = torch.tensor([128, 77], device="cuda")
    outs = []
    for m in (model, plain):
        logits, caches = m.prefill(params, {"tokens": toks}, 256)
        step, _ = m.decode_step(params, caches, {"tokens": nxt}, pos)
        outs.append((logits, step))
    for name, a, b in (("prefill", outs[0][0], outs[1][0]), ("decode", outs[0][1], outs[1][1])):
        if not torch.isfinite(a).all() or a.shape != b.shape:
            raise AssertionError(f"{name} logits: non-finite or misshapen {tuple(a.shape)}")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"[serve] full-width {name} logits, kernels vs plain attention: "
            f"max abs err / max |logit| = {rel:.3g}")
        if rel > 5e-2:
            raise AssertionError(f"{name} logits: kernels and plain path disagree ({rel:.3g})")


def phase_serve() -> dict:
    cfg = get_config("qwen3-0.6b").replace(use_kernel=True)
    if cfg.n_layers != N_LAYERS or cfg.dtype != torch.bfloat16:
        raise AssertionError(f"qwen3-0.6b FULL changed: {cfg}")
    t0 = time.time()
    model = build_model(cfg)
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] qwen3-0.6b FULL: {n_params / 1e6:.1f} M parameters (f32), "
        f"random init in {time.time() - t0:.1f} s")
    _check_against_plain(model, params)

    rng = np.random.RandomState(1)
    vocab = cfg.vocab_size
    long_prompts = [rng.randint(0, vocab, size=n).tolist()
                    for n in rng.randint(128, 1025, size=8)]
    split_prompts = [rng.randint(0, vocab, size=n).tolist()
                     for n in rng.randint(128, 257, size=8)]
    total = {"terapipe_attention_fwd": 0, "decode_attention": 0}
    toks, counts = _serve_run(model, params, long_prompts, "one chunk per prompt")
    total = {k: total[k] + counts[k] for k in total}
    _check_sequential(model, params, long_prompts[:2], toks, "one chunk per prompt")
    toks, counts = _serve_run(model, params, split_prompts, f"slo_tmax={SLO_TMAX}",
                              slo_tmax=SLO_TMAX)
    total = {k: total[k] + counts[k] for k in total}
    _check_sequential(model, params, split_prompts[:2], toks, f"slo_tmax={SLO_TMAX}",
                      slo_tmax=SLO_TMAX)
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------------------------------------- 4. times
def time_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn`` in ms, L2 flushed before each launch
    (the serving path finds K/V cold: the pool gather ran between uses)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def phase_times(errs: dict, launches: dict) -> list:
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(1)
    dt, elt = torch.bfloat16, 2
    rows = []

    # prefill: one whole 1024-token prompt chunk (the slo_tmax=None path)
    b, l, ctx, hq, hkv, hd = 1, 1024, 0, 16, 8, 128
    sk = ctx + l
    q = _rand((b, l, hq, hd), dt, gen)
    k = _rand((b, sk, hkv, hd), dt, gen)
    v = _rand((b, sk, hkv, hd), dt, gen)
    mask = (torch.arange(l, device="cuda")[:, None] + ctx
            >= torch.arange(sk, device="cuda")[None, :])
    keys = sum(ctx + i + 1 for i in range(l))
    flops = 4 * hd * hq * b * keys
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * elt + b * hq * l * 4
    bms, by = bound_ms(flops, nbytes)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rows.append(dict(
        name="terapipe_attention_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/terapipe_attention_fwd.cu",
        replaces="src/repro/kernels/terapipe_attention.py:57",
        launches=launches["terapipe_attention_fwd"],
        max_abs_err=errs["terapipe_attention_fwd"],
        ms=time_ms(lambda: terapipe_attention_fwd(q, k, v, ctx)),
        plain_ms=time_ms(lambda: terapipe_attention_ref(q, k, v, ctx)),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        shape=f"B={b} l={l} ctx={ctx} Hq={hq} Hkv={hkv} hd={hd} bf16"))

    # decode: one round of the serving engine, 4 slots at mixed depths
    b, L = 4, 2048
    kv_len = [1056, 544, 800, 160]
    q = _rand((b, 1, hq, hd), dt, gen)
    k = _rand((b, L, hkv, hd), dt, gen)
    v = _rand((b, L, hkv, hd), dt, gen)
    lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    dmask = (torch.arange(L, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    flops = 4 * hd * hq * sum(kv_len)
    nbytes = (2 * q.numel() + 2 * sum(kv_len) * hkv * hd) * elt + 4 * b
    bms, by = bound_ms(flops, nbytes)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rows.append(dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:29",
        launches=launches["decode_attention"],
        max_abs_err=errs["decode_attention"],
        ms=time_ms(lambda: decode_attention_kernel(q, k, v, lens)),
        plain_ms=time_ms(lambda: decode_attention_ref(q, k, v, lens)),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: sdpa(qt, kt, vt, attn_mask=dmask, enable_gqa=True)),
        shape=f"B={b} L={L} kv_len={kv_len} Hq={hq} Hkv={hkv} hd={hd} bf16"))
    for r in rows:
        log(f"[times] {r['name']} ({r['shape']}): kernel {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    phase_build()
    errs = phase_kernels()
    launches = phase_serve()
    rows = phase_times(errs, launches)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
