"""The benchmark's cells at sizes a CPU test can hold: every width and count
of a configuration cut to the port's SMOKE sizes, the batch to 2 x 64, the
limits to these sizes' own, everything else (the path, the schedule, the
optimizer) as the cell states it."""
from __future__ import annotations

import copy
import dataclasses

from perfbench import cells

SIZES = {
    "dense": {"n_layers": 4, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
              "d_ff": 256, "vocab_size": 256},
    "moe": {"n_layers": 3, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
            "d_ff": 192, "vocab_size": 256, "n_experts": 8, "moe_top_k": 2, "d_expert": 48,
            "n_shared_experts": 2, "moe_block": 8},
}
_PORT_KEYS = {"head_dim": None}
#: The limits at these sizes, which read higher than the cells' own: set
#: between a sound run's readings on the CPU (dense loss 2.1e-4, grad 2.0e-3,
#: change 7.4e-4; MoE 1.0e-3, 9.5e-3, 2.2e-3) and the fp8 control's (dense
#: 3.9e-3, 1.5e-2, 4.5e-3; MoE 7.9e-3, 5.7e-2, 1.1e-2).
LIMITS = {"dense": {"loss_gap": 1e-3, "grad_gap": 6e-3, "change_gap": 2e-3},
          "moe": {"loss_gap": 3e-3, "grad_gap": 2.5e-2, "change_gap": 5e-3}}


def smoke_config(config: dict) -> dict:
    config = copy.deepcopy(config)
    sizes = SIZES[config["family"]]
    config.update(sizes)
    config["port"]["replace"] = {k: v for k, v in sizes.items() if k not in _PORT_KEYS}
    config["reference"]["row_block"] = 1
    return config


def smoke_cell(name: str, batch: int = 2, seq: int = 64, **traffic) -> cells.Cell:
    cell = cells.load_cell(name)
    t = dict(cell.traffic, batch=batch, seq=seq, **traffic)
    if "token_slices" in t:
        t["token_slices"] = min(t["token_slices"], 4)
    return dataclasses.replace(cell, config=smoke_config(cell.config), traffic=t,
                               limits=LIMITS[cell.config["family"]])
