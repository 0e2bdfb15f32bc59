"""End-to-end TeraPipe training on the PyTorch port: a GPT-style LM trained
with the token-level pipeline (K = 4 virtual ranks on one device, M token
slices, D = 2 microbatches), with checkpoints in the reference's format.

Default is a small run (~20M params, 200 steps); --full trains a ~110M
model.  --resume continues from the newest checkpoint in --ckpt.

    PYTHONPATH=src python examples/terapipe_train_torch.py [--full] [--steps 200]
    PYTHONPATH=src python examples/terapipe_train_torch.py --device cpu --steps 20
"""
import argparse
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import CheckpointManager, meta_target  # noqa: E402
from repro_torch.core.pipeline import TeraPipeConfig, make_terapipe_value_and_grad  # noqa: E402
from repro_torch.data.pipeline import DataPipeline, SyntheticSource  # noqa: E402
from repro_torch.launch.train import PIPE_RANKS, train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.optim.adamw import adamw, cosine_schedule  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--slices", type=int, default=4)
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "terapipe_example_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.full:
        cfg = ModelConfig(name="gpt-110m", family="dense", n_layers=12, d_model=768,
                          n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=32000, remat=False)
    else:
        cfg = ModelConfig(name="gpt-20m", family="dense", n_layers=8, d_model=384,
                          n_heads=6, n_kv_heads=6, d_ff=1536, vocab_size=8192, remat=False)
    model = build_model(cfg, device=args.device)
    params = tree_map(lambda p: p.requires_grad_(True), model.init(seed=0))
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"{cfg.name}: {n / 1e6:.1f}M params on {model.device}, {PIPE_RANKS} pipeline ranks")

    tcfg = TeraPipeConfig(n_token_slices=args.slices, n_microbatches=2)
    vg = make_terapipe_value_and_grad(model, tcfg, args.seq, args.batch, PIPE_RANKS)
    opt = adamw(cosine_schedule(3e-4, 20, args.steps))
    state = {"params": params, "opt_state": opt.init(params)}
    ckpt = CheckpointManager(args.ckpt, keep=2)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        got = ckpt.restore(target={"params": meta_target(state["params"]),
                                   "opt": meta_target(state["opt_state"]), "step": 0},
                           device=model.device)
        state = {"params": tree_map(lambda p: p.requires_grad_(True), got["params"]),
                 "opt_state": got["opt"]}
        start = int(got["step"])
        print(f"resumed at step {start} from {args.ckpt}")

    data = DataPipeline(SyntheticSource(cfg.vocab_size), args.batch, args.seq)
    t0, loss = time.time(), None
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(a).to(model.device) for k, a in data.batch_at(i).items()}
        loss = train_step(vg, opt, state, batch)
        if i % 20 == 0:
            tps = args.batch * args.seq * (i + 1 - start) / (time.time() - t0)
            print(f"step {i:4d} loss {float(loss):.4f} ({tps:,.0f} tok/s)")
        if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
            ckpt.save(i + 1, {"params": state["params"], "opt": state["opt_state"],
                              "step": i + 1})
    if loss is not None:
        print(f"final loss {float(loss):.4f} (started ~{math.log(cfg.vocab_size):.2f})")
    return None if loss is None else float(loss)


if __name__ == "__main__":
    main()
