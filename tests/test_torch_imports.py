"""The PyTorch port stands alone and never falls back silently.

* no module of ``src/repro_torch`` (nor ``chip_smoke.py`` or the port's
  examples, ``examples/*_torch.py``) imports jax, jaxlib or the JAX
  package, and none calls a finished attention op;
* every entry point (serving, the training modes, the kernel cost table,
  the audit command, the examples) raises when no GPU is present and the
  caller did not ask for ``device="cpu"``; the kernel wrappers refuse CPU
  tensors; a model is on ``meta`` only when its caller names it;
* CPU tensors take the plain path and leave both launch counters at 0.
"""
import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.core import pipeline
from repro_torch.core.cost_model import measure_kernel_cost_table
from repro_torch.kernels import _build, ops
from repro_torch.kernels.decode_attention import decode_attention_kernel
from repro_torch.kernels.terapipe_attention import terapipe_attention_fwd
from repro_torch.kernels.terapipe_attention_bwd import (terapipe_attention_bwd,
                                                        terapipe_attention_dkv,
                                                        terapipe_attention_dq)
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.launch.steps import abstract_init
from repro_torch.models import build_model
from repro_torch.serve import DecodeEngine, EngineConfig
from repro_torch.timing import PEAK_BF16_FLOPS, PEAK_BYTES, bound_ms

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
PORT_EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
FORBIDDEN_MODULES = {"jax", "jaxlib", "repro"}
FORBIDDEN_CALLS = {"scaled_dot_product_attention", "flex_attention", "compile"}


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    assert len(PORT_FILES) > 20 and len(PORT_EXAMPLES) == 4
    assert {"checkpoint", "analysis", "distributed"} <= {p.parent.name for p in PORT_FILES}
    assert {"moe.py", "qwen3_moe.py", "deepseek_moe.py", "ssm.py", "rglru.py", "mamba2.py",
            "recurrentgemma.py", "phi3_mini.py", "phi4_mini.py", "stablelm_12b.py",
            "phi3_vision.py", "whisper_medium.py", "steps.py",
            "collectives.py", "dryrun.py", "hlo_analysis.py",
            "instruments.py"} <= {p.name for p in PORT_FILES}
    assert "serve_decode_torch.py" in {p.name for p in PORT_EXAMPLES}
    bad = []
    for path in PORT_FILES + PORT_EXAMPLES + [ROOT / "chip_smoke.py", ROOT / "chip_compare.py"]:
        for mod in _imports(ast.parse(path.read_text())):
            if mod.split(".")[0] in FORBIDDEN_MODULES:
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_port_calls_no_finished_attention_op():
    """scaled_dot_product_attention / flex_attention / torch.compile are
    not kernels of this repository (chip_smoke times SDPA only as a
    yardstick, so it is not scanned here)."""
    bad = []
    for path in PORT_FILES + PORT_EXAMPLES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute) and node.attr in FORBIDDEN_CALLS:
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno}: {node.attr}")
    assert not bad, bad


def test_bound_ms_is_the_slower_of_operations_and_bytes():
    assert bound_ms(PEAK_BF16_FLOPS, 1.0) == (1e3, "operations")
    assert bound_ms(1.0, 2 * PEAK_BYTES) == (2e3, "bytes")


def _cpu_tensors(hd=32):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 4, hd, generator=g)
    k = torch.randn(1, 8, 2, hd, generator=g)
    return q, k, k.clone()


def test_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device is valid here")
    cfg = get_config("qwen3-0.6b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        DecodeEngine(model, model.init(0), EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        serve_launch.main(["--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        train_launch.main(["--arch", "gpt3-1b", "--smoke", "--steps", "1"])
    for mode in ("terapipe", "gpipe"):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            train_launch.main(["--arch", "gpt3-1b", "--smoke", "--steps", "1", "--mode", mode])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        measure_kernel_cost_table([(8, 0)])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        analysis_main([])
    for path in PORT_EXAMPLES:
        spec = importlib.util.spec_from_file_location(path.stem, path)
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            example.main([])
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        _build.build_all()
    q, k, v = _cpu_tensors()
    with pytest.raises(ValueError, match="CUDA tensors"):
        terapipe_attention_fwd(q, k, v, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode_attention_kernel(q[:, :1], k, v, 3)
    lse = torch.zeros(1, 4, 4)
    for bwd in (terapipe_attention_bwd, terapipe_attention_dq, terapipe_attention_dkv):
        with pytest.raises(ValueError, match="CUDA tensors"):
            bwd(q, k, v, q, lse, lse, 2)


def test_meta_device_only_when_named():
    """``meta`` (the abstract structures) is a device a caller must name:
    no default or fallback reaches it, and other devices are refused."""
    cfg = get_config("qwen3-0.6b", smoke=True)
    assert build_model(cfg, device="meta").device == torch.device("meta")
    assert resolve_device("meta") == torch.device("meta")
    assert build_model(cfg, device="cpu").device == torch.device("cpu")
    for bad in ("mps", "xla", "hpu"):
        with pytest.raises((ValueError, RuntimeError)):
            resolve_device(bad)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            abstract_init(build_model(cfg))
    params, _ = abstract_init(build_model(cfg, device="cpu"))
    assert all(t.is_meta for t in params.values() if isinstance(t, torch.Tensor))


def test_dryrun_runs_on_meta_without_a_gpu(tmp_path):
    """The dry run's device is meta by nature, not a fallback: it needs no
    GPU, and a traced cell allocates nothing off meta."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("qwen3-0.6b", "train_4k", smoke=True, out_dir=str(tmp_path),
                          shape=dryrun.ShapeSpec("x", 16, 2, "train"),
                          mesh=dryrun.Mesh(data=1, model=1), use_kernel=True)
    assert rec["ok"] and rec["largest_off_meta_bytes"] == 0
    assert rec["kernel_calls"]["terapipe_attention_fwd"] > 0
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                        "--out-dir", str(tmp_path)]) == 0


def test_cpu_tensors_take_the_plain_path_without_launches():
    counters = (terapipe_attention_fwd, decode_attention_kernel, terapipe_attention_dq,
                terapipe_attention_dkv)
    for fn in counters:
        fn.launches = 0
    q, k, v = _cpu_tensors()
    q.requires_grad_(True)
    out = ops.terapipe_attention(q, k, v, ctx_len=3)
    assert out.shape == q.shape
    assert torch.autograd.grad(out.sum(), q)[0].shape == q.shape
    assert ops.decode_attention(q[:, :1], k, v, torch.tensor([5])).shape == (1, 1, 4, 32)
    # the whole serving path on the CPU, kernels routed
    cfg = get_config("qwen3-0.6b", smoke=True).replace(dtype=torch.float32,
                                                       use_kernel=True)
    model = build_model(cfg, device="cpu")
    eng = DecodeEngine(model, model.init(0),
                       EngineConfig(max_batch=2, max_len=32, page_size=8,
                                    n_pages=9, slo_tmax=120.0), device="cpu")
    rng = np.random.RandomState(0)
    for n in (9, 12):
        eng.submit(rng.randint(0, cfg.vocab_size, size=n).tolist(), 3)
    eng.run()
    assert len(eng.finished) == 2
    # and the pipelined training step, kernels routed
    train_launch.main(["--arch", "gpt3-1b", "--smoke", "--device", "cpu", "--use-kernel",
                       "--mode", "terapipe", "--steps", "1", "--batch", "2", "--seq", "16"])
    assert all(fn.launches == 0 for fn in counters)


def test_forward_only_and_unported_surfaces_raise():
    """What the reference refuses, the port refuses too: the enc-dec family
    cannot be token-sliced (``_group_split``, and so ``--mode terapipe``,
    raise NotImplementedError), and the explicit-backward schedules take
    the dense and MoE families only (vlm raises ValueError)."""
    whisper = build_model(get_config("whisper-medium", smoke=True), device="cpu")
    with pytest.raises(NotImplementedError, match="not token-sliceable"):
        pipeline._group_split(whisper)
    vlm = build_model(get_config("phi-3-vision-4.2b", smoke=True), device="cpu")
    for schedule, V in (("1f1b", 1), ("zb-h1", 1), ("interleaved-1f1b", 2)):
        with pytest.raises(ValueError, match="dense/moe"):
            pipeline.make_terapipe_value_and_grad(
                vlm, pipeline.TeraPipeConfig(schedule=schedule, virtual_stages=V), 16, 2, 2)
