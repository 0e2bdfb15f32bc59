"""The cells of ``BENCHMARK.json`` and the files each one is made of, found
by name: ``configs/<config>.json`` (the entry's ``file``),
``traffic/<traffic>.json``, ``limits/<workload>.json`` and one reader
``metrics/<metric>.py`` per per-layer metric.  Adding a cell is adding
those files and the entries that name them."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: the keys of a configuration file that the port's ``ModelConfig`` must
#: hold as they are: (file key, ModelConfig attribute)
_SIZES = [("n_layers", "n_layers"), ("d_model", "d_model"), ("n_heads", "n_heads"),
          ("n_kv_heads", "n_kv_heads"), ("head_dim", "hd"), ("d_ff", "d_ff"),
          ("vocab_size", "vocab_size"), ("rope_theta", "rope_theta"),
          ("tie_embeddings", "tie_embeddings")]
_MOE_SIZES = [("n_experts", "n_experts"), ("n_shared_experts", "n_shared_experts"),
              ("moe_top_k", "moe_top_k"), ("d_expert", "d_expert"),
              ("capacity_factor", "capacity_factor"), ("moe_block", "moe_block")]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "perfbench" / "limits" / f"{name}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _applies(m, name) and m["moves"] in moved]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per_layer)


def load_reader(metric: str, root: Path = ROOT) -> Callable[[dict], Optional[float]]:
    """The ``read(run)`` of ``metrics/<metric>.py``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def port_config(config: dict):
    """The port's ``ModelConfig`` of a configuration file: the port's own
    configuration ``port.arch`` with ``port.replace`` and the kernels on,
    checked against every size the file states."""
    from repro_torch.configs import get_config

    port = config["port"]
    cfg = get_config(port["arch"]).replace(**port.get("replace", {}), use_kernel=True)
    keys = _SIZES + (_MOE_SIZES if config["family"] == "moe" else [])
    wrong = {k: (config[k], getattr(cfg, a)) for k, a in keys if config[k] != getattr(cfg, a)}
    if config["family"] == "moe" and cfg.n_shared_experts and config["first_dense_layers"] != 1:
        wrong["first_dense_layers"] = (config["first_dense_layers"], 1)
    if str(cfg.dtype) != f"torch.{config['activation_dtype']}" or not cfg.remat:
        wrong["activation_dtype, remat"] = ((config["activation_dtype"], True),
                                            (str(cfg.dtype), cfg.remat))
    if wrong:
        raise ValueError(f"the port's {port['arch']} differs from {config['name']}'s file "
                         f"(file, port): {wrong}")
    return cfg
