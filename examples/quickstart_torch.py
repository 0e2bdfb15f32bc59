"""Quickstart of the PyTorch port: build a model, plan a TeraPipe slicing
with the DP, and run a few training steps.

    PYTHONPATH=src python examples/quickstart_torch.py               # on the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain path
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cost_model import H100, TPU_V5E, AnalyticCostModel  # noqa: E402
from repro_torch.core.dp import optimal_slicing  # noqa: E402
from repro_torch.core.pipeline import value_and_grad  # noqa: E402
from repro_torch.core.simulator import eq5_latency  # noqa: E402
from repro_torch.data.pipeline import DataPipeline, SyntheticSource  # noqa: E402
from repro_torch.launch.train import train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.adamw import adamw, cosine_schedule  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)

    # 1. a model (reduced qwen3 config, same family as the full 0.6B)
    cfg = get_config("qwen3-0.6b", smoke=True)
    model = build_model(cfg, device=args.device)
    params = tree_map(lambda p: p.requires_grad_(True), model.init(seed=0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"model: {cfg.name}, {n_params / 1e6:.2f}M params on {model.device}")

    # 2. plan the token slicing the paper's way: cost model -> DP, priced on
    # the card's fitted spec on the GPU, on the reference's TPU spec otherwise
    full = get_config("qwen3-0.6b")
    hw = H100 if model.device.type == "cuda" else TPU_V5E
    cm = AnalyticCostModel(full, hw, layers_per_stage=full.n_layers // 4)
    dp = optimal_slicing(cm, 4096, K=4, granularity=128)
    uniform = eq5_latency([4096], 4, cm)
    print(f"DP slicing for L=4096, K=4 stages on {hw.name}: {dp.slices}")
    print(f"  predicted iteration latency {dp.latency * 1e3:.1f} ms "
          f"(vs {uniform * 1e3:.1f} ms unsliced -> {uniform / dp.latency:.2f}x)")

    # 3. train a few steps
    opt = adamw(cosine_schedule(3e-4, 5, 50))
    state = {"params": params, "opt_state": opt.init(params)}
    vg = value_and_grad(model.loss)
    data = DataPipeline(SyntheticSource(cfg.vocab_size), 4, 64)
    for i in range(args.steps):
        batch = {k: torch.from_numpy(a).to(model.device) for k, a in data.batch_at(i).items()}
        loss = train_step(vg, opt, state, batch)
        if i % 3 == 0:
            print(f"step {i}: loss {float(loss):.4f}")
    print("quickstart OK")
    return float(loss)


if __name__ == "__main__":
    main()
