"""The paper's planning pipeline on the port's planning layer (numpy): fit
the bilinear context model (Eq. 9), run the DP (Alg. 1), compare schedules
in the simulator, re-plan for a straggler.  On the GPU it also measures
the attention kernels' cost table (forward, and dQ + dK/dV) at a few
(l, ctx) at gpt3-13b's heads.

    PYTHONPATH=src python examples/dp_planner_demo_torch.py
    PYTHONPATH=src python examples/dp_planner_demo_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cost_model import (V100_AWS, AnalyticCostModel,  # noqa: E402
                                         BilinearFitCostModel, measure_kernel_cost_table)
from repro_torch.core.dp import joint_batch_token, optimal_slicing  # noqa: E402
from repro_torch.core.schedule import SlicingScheme  # noqa: E402
from repro_torch.core.simulator import eq5_latency, simulate  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("gpt3-13b")
    K, L, B = 40, 2048, 32
    truth = AnalyticCostModel(cfg, V100_AWS, layers_per_stage=cfg.n_layers // K, tp_degree=8)

    # 1. Eq. 9 estimator: fit t_ctx on a sample, check error (paper: <2%)
    fit = BilinearFitCostModel.fit(truth, L, n_samples=128)
    err = fit.relative_error(truth, L)
    print(f"bilinear t_ctx fit: {err * 100:.2f}% relative error (paper <2%)")
    if device.type == "cuda":
        pairs = ((256, 0), (256, 1792), (2048, 0))
        table = measure_kernel_cost_table(pairs, batch=1, n_heads=cfg.n_heads,
                                          head_dim=cfg.hd)
        for l, ctx in pairs:
            print(f"  attention kernels on the card, l {l} ctx {ctx}: fwd "
                  f"{table.t_fwd(l, ctx) * 1e3:.4f} ms, bwd {table.t_bwd(l, ctx) * 1e3:.4f} ms")

    # 2. token DP (Alg. 1) against uniform slicings
    dp = optimal_slicing(fit, L, K, granularity=8)
    print(f"DP scheme ({len(dp.slices)} slices): {dp.slices}")
    for m in (1, 4, 8, 16):
        uni = eq5_latency([L // m] * m, K, truth)
        print(f"  uniform {m:3d} slices: {uni * 1e3:8.1f} ms ({uni / dp.latency:.2f}x vs DP)")

    # 3. joint batch x token (§3.4, pipeline objective)
    res = joint_batch_token(
        lambda b: AnalyticCostModel(cfg, V100_AWS, layers_per_stage=cfg.n_layers // K,
                                    tp_degree=8, batch=b),
        L, B, K, granularity=64, batch_candidates=[1, 2, 4, 8])
    sch = SlicingScheme.from_dp(L, B, res.scheme)
    print(f"joint scheme: {sch.describe()[:100]}")

    # 4. straggler re-planning: one stage 40% slow.  Every slice crosses
    # every stage, so re-slicing cannot remove the slow stage's serial work;
    # it shrinks the bubble term by preferring more, smaller slices.
    slow = np.ones(K)
    slow[K // 2] = 1.4
    t = lambda b, l, c: truth(l, c)
    naive = optimal_slicing(truth, L, K, granularity=64)
    replanned = optimal_slicing(
        AnalyticCostModel(cfg, V100_AWS, layers_per_stage=cfg.n_layers // K, tp_degree=8,
                          stage_slowdown=1.4), L, K, granularity=64)
    out = {}
    for name, plan in (("naive", naive), ("replanned", replanned)):
        sch_x = SlicingScheme.from_dp(L, 1, [(1, plan.slices)])
        out[name] = simulate(sch_x, K, t, stage_slowdown=slow)
        print(f"straggler (1 stage 1.4x slow), {name:9s}: {out[name] * 1e3:8.1f} ms  "
              f"({len(plan.slices)} slices)")
    return {"fit_error": err, "dp_latency": dp.latency, **out}


if __name__ == "__main__":
    main()
