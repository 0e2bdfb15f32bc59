"""Serving launcher: drive the continuous-batching engine from the CLI
(reference: ``repro/launch/serve.py``).

Feeds a synthetic request mix (random prompts, staggered lengths) through
``repro_torch.serve.DecodeEngine``, prints per-request first-token and
finish rounds, and audits the ``streaming``-schedule trace.  Runs on the
GPU unless ``--device cpu``; ``--use-kernel`` routes attention through the
CUDA kernels (as ``repro.launch.train --use-kernel`` does for training).

Usage:
  python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke \\
      --requests 8 --gen 16 [--slo-tmax 600] [--sequential] [--use-kernel] \\
      [--simulate]

``--simulate`` prices the served trace with ``core/simulator.py``'s
``simulate_stream`` at ``--pipe`` stages (total, median TTFT and tokens per
unit, in the chunk-cost units of ``--slo-tmax``).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.simulator import simulate_stream
from repro_torch.models import build_model
from repro_torch.serve import DecodeEngine, EngineConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=24,
                    help="max prompt length (mix is staggered below it)")
    ap.add_argument("--gen", type=int, default=16, help="tokens per request")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--pages", type=int, default=0,
                    help="KV pool pages (0 = enough for max-batch slots)")
    ap.add_argument("--pipe", type=int, default=1,
                    help="notional pipeline depth for the DP plan + trace")
    ap.add_argument("--slo-tmax", type=float, default=None,
                    help="SLO knob: max per-prefill-chunk stall, in units "
                         "of the chunk cost model (overhead + l*(ctx+l)); "
                         "unset = one chunk per prompt")
    ap.add_argument("--sequential", action="store_true",
                    help="baseline: cap concurrency at 1 request")
    ap.add_argument("--simulate", action="store_true",
                    help="price the trace with the simulator's simulate_stream")
    ap.add_argument("--use-kernel", action="store_true",
                    help="attention through the hand-written CUDA kernels")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke).replace(use_kernel=args.use_kernel)
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    rng = np.random.RandomState(args.seed + 1)

    pages = args.pages or args.max_batch * (args.max_len // args.page_size) + 1
    engine = DecodeEngine(model, params, EngineConfig(
        max_batch=args.max_batch, max_len=args.max_len,
        page_size=args.page_size, n_pages=pages, n_ranks=args.pipe,
        slo_tmax=args.slo_tmax,
        max_concurrency=1 if args.sequential else None), device=args.device)

    rids = []
    for _ in range(args.requests):
        plen = int(rng.randint(max(1, args.prompt // 2), args.prompt + 1))
        prompt = rng.randint(0, cfg.vocab_size, size=plen).tolist()
        rids.append(engine.submit(prompt, args.gen))
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    engine.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0

    total_tokens = 0
    for rid in rids:
        r = engine.finished[rid]
        total_tokens += len(r.generated)
        print(f"[serve] rid={rid} prompt={len(r.prompt)} "
              f"first_token_round={r.first_token_round} "
              f"finish_round={r.finish_round} sample={r.generated[:6]}")
    sched = engine.schedule()
    sched.validate(len(engine.units))
    print(f"[serve] {len(rids)} requests, {total_tokens} tokens in "
          f"{engine.rounds} rounds ({dt:.2f}s wall on {model.device}, "
          f"{total_tokens / dt:.1f} tok/s); trace of {len(engine.units)} "
          f"units validates")

    if args.simulate:
        # the trace priced in the chunk-cost units of --slo-tmax, not seconds
        rep = simulate_stream(
            sched, lambda u: 1.0 + 0.001 * u.tokens * (1 + max(u.ctx)))
        ttfts = sorted(rep.ttft.values())
        print(f"[serve] simulated @K={args.pipe}: total={rep.total:.1f} "
              f"ttft_p50={ttfts[len(ttfts) // 2]:.1f} "
              f"tok/s={rep.tokens_per_s:.2f}")


if __name__ == "__main__":
    main()
