"""Serving example of the PyTorch port: the continuous-batching engine
(repro_torch.serve) on the dense family, whose single-request decode is
the engine's degenerate case, plus a hand-rolled prefill and decode loop
(``launch/steps.py``) for the families whose caches are not paged (SSM,
hybrid, enc-dec), which the engine refuses.  Attention goes through the
CUDA kernels on the GPU (``use_kernel``) and their plain versions on the
CPU.

    PYTHONPATH=src python examples/serve_decode_torch.py               # on the GPU
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu  # plain path
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import DecodeEngine, EngineConfig  # noqa: E402


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def serve_engine(arch: str, device, prompt_len=24, gen_len=16, batch=4, max_len=64) -> dict:
    """Dense-family serving through the engine: ``batch`` requests with
    staggered prompt lengths, admitted together, decoded in
    token-synchronous rounds off the paged KV cache; then the first
    request alone through the same engine, which must give the same
    tokens.  Returns both runs' tokens and the engines' prefill chunks and
    decode rounds."""
    model = build_model(get_config(arch, smoke=True).replace(use_kernel=True), device=device)
    params = model.init(seed=0)
    rng = np.random.RandomState(42)
    prompts = [rng.randint(0, model.cfg.vocab_size, size=prompt_len - 2 * i).tolist()
               for i in range(batch)]
    geom = dict(max_batch=batch, max_len=max_len, page_size=8,
                n_pages=batch * (max_len // 8) + 1)

    engine = DecodeEngine(model, params, EngineConfig(**geom), device=device)
    rids = [engine.submit(p, gen_len) for p in prompts]
    t0 = time.time()
    engine.run()
    _sync(model.device)
    dt = time.time() - t0
    toks = sum(len(engine.finished[r].generated) for r in rids)
    gen0 = engine.finished[rids[0]].generated
    print(f"{arch:24s} engine  {engine.rounds:3d} rounds | "
          f"{toks / dt:8.1f} tok/s | sample {gen0[:8]}")

    # the degenerate case: one request through the same engine is the
    # classic prefill + decode loop, and must give the same tokens
    solo = DecodeEngine(model, params, EngineConfig(**geom, max_concurrency=1), device=device)
    rid = solo.submit(prompts[0], gen_len)
    solo.run()
    if solo.finished[rid].generated != gen0:
        raise AssertionError(f"{arch}: the single request's tokens differ from the "
                             f"batched run's")
    engine.schedule().validate(len(engine.units))
    print(f"{'':24s} single-request degenerate case matches; "
          f"trace of {len(engine.units)} units validates")
    units = engine.units + solo.units
    return {"tokens": gen0, "solo": solo.finished[rid].generated,
            "prefill_chunks": sum(u.kind == "prefill" for u in units),
            "decode_rounds": sum(u.kind == "decode" for u in units),
            "layers": model.cfg.n_layers}


def serve_legacy(arch: str, device, prompt_len=24, gen_len=16, batch=4, max_len=64) -> list:
    """A batched prefill, then greedy decode steps, through
    ``make_prefill_step`` and ``make_decode_step`` (caches that are not
    paged).  Returns the generated tokens, one list per row."""
    model = build_model(get_config(arch, smoke=True).replace(use_kernel=True), device=device)
    cfg, dev = model.cfg, model.device
    params = model.init(seed=0)
    rng = np.random.RandomState(42)
    batch_in = {"tokens": torch.from_numpy(
        rng.randint(0, cfg.vocab_size, size=(batch, prompt_len))).to(dev)}
    if cfg.family == "encdec":
        frames = rng.normal(size=(batch, prompt_len, cfg.d_model)).astype(np.float32)
        batch_in["frames"] = torch.from_numpy(frames).to(dev, torch.bfloat16)
    prefill, decode = make_prefill_step(model, max_len), make_decode_step(model)

    t0 = time.time()
    logits, caches = prefill(params, batch_in)
    next_tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    _sync(dev)
    t_prefill = time.time() - t0
    out = [next_tok]
    t0 = time.time()
    for t in range(prompt_len, prompt_len + gen_len - 1):
        logits, caches = decode(params, caches, {"tokens": next_tok}, t)
        next_tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(next_tok)
    _sync(dev)
    t_decode = (time.time() - t0) / (gen_len - 1)
    gen = torch.cat(out, dim=1).tolist()
    print(f"{arch:24s} prefill {t_prefill * 1e3:7.1f} ms | "
          f"decode {t_decode * 1e3:6.1f} ms/tok | sample {gen[0][:8]}")
    return gen


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = {"engine": serve_engine("qwen3-0.6b", args.device)}
    for arch in ("mamba2-2.7b", "recurrentgemma-9b", "whisper-medium"):
        out[arch] = serve_legacy(arch, args.device)
    print("serving OK")
    return out


if __name__ == "__main__":
    main()
