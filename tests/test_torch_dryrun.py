"""The port's dry run (``launch/dryrun.py``, ``launch/hlo_analysis.py``,
``launch/instruments.py``, the kernels' meta routes) against the JAX
package's.

* ``cell_tag`` equal to ``repro.launch.dryrun.cell_tag`` on every (arch,
  shape, pod, mode, V, schedule, variant), and skipped records equal;
* every ported ``hlo_analysis`` function equal to the reference's on every
  arch x shape to 1e-12 relative, ``Roofline`` with the v5e constants;
* the meta routes return the plain versions' shapes and dtypes and count
  the calls a CPU run makes; the dispatch sends CPU tensors only to the
  plain versions, CUDA tensors only to the kernels, meta tensors to
  neither, and refuses any other device;
* the traced FLOPs of a gpt3 SMOKE train step within 2% of
  ``repro.launch.hlo_tripcount.analyze`` of the reference's compiled step
  on one CPU device, and equal to ``FlopCounterMode``'s;
* the live-bytes account follows a storage's life, and is the same on CPU
  tensors and on meta;
* every SMOKE cell's record on a small mesh (the failures pinned: the
  state families under tensor parallelism; in terapipe mode the
  non-train shapes and the enc-dec family, as in the reference), one
  FULL cell, and the CLI's refusals.
"""
import itertools
import os

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jax_configs
from repro.launch import hlo_analysis as jax_ha
from repro.launch import hlo_tripcount
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch import configs
from repro_torch.configs import ShapeSpec
from repro_torch.core.schedules import schedule_names
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch.instruments import Account
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.optim.adamw import adamw, cosine_schedule
from repro_torch.launch.steps import make_train_step

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

ALL_ARCHS = configs.ARCHS + configs.PAPER_ARCHS


def _jax_dryrun():
    """``repro.launch.dryrun`` imported without its 512 placeholder
    devices: it sets XLA_FLAGS at import, which must not reach this
    worker's JAX (already initialised, and the environment restored)."""
    jax.devices()
    saved = {k: os.environ.get(k) for k in ("XLA_FLAGS", "REPRO_DRYRUN_DEVICES")}
    os.environ["REPRO_DRYRUN_DEVICES"] = "1"
    try:
        from repro.launch import dryrun as jax_dryrun
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return jax_dryrun


# ------------------------------------------------------------ tags, skips
def test_cell_tag_matches_reference():
    jax_dryrun = _jax_dryrun()
    n = 0
    for combo in itertools.product(ALL_ARCHS, configs.SHAPES, (False, True),
                                   ("gspmd", "terapipe"), (1, 2), schedule_names(),
                                   ("", "kernel")):
        arch, shape, pod, mode, v, sched, variant = combo
        assert dryrun.cell_tag(arch, shape, pod, mode, v, variant, sched) == \
            jax_dryrun.cell_tag(arch, shape, pod, mode, v, variant, sched), combo
        n += 1
    assert n == len(ALL_ARCHS) * 4 * 2 * 2 * 2 * len(schedule_names()) * 2


def test_skipped_records_match_reference(tmp_path, capsys):
    jax_dryrun = _jax_dryrun()
    cells = [(a, s) for a in configs.ARCHS for s in configs.SHAPES
             if configs.skip_reason(a, s)]
    assert len(cells) == 8
    for (arch, shape), mode, pod in itertools.product(cells, ("gspmd", "terapipe"),
                                                      (False, True)):
        kw = dict(multi_pod=pod, mode=mode, virtual_stages=2, schedule="1f1b")
        got = dryrun.run_cell(arch, shape, out_dir=str(tmp_path / "port"), **kw)
        want = jax_dryrun.run_cell(arch, shape, out_dir=str(tmp_path / "ref"), **kw)
        assert got == want and "skipped" in got
    out = capsys.readouterr().out
    assert out.count("[SKIP]") == 2 * len(cells) * 4


# ------------------------------------------------------------ hlo_analysis
def _rel_equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _rel_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, str) or a is None:
        assert a == b, what
    else:
        assert abs(a - b) <= 1e-12 * max(abs(a), abs(b)), (what, a, b)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_hlo_analysis_matches_reference(arch):
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    for fn in ("total_param_count", "active_param_count", "_eff_layers"):
        _rel_equal(getattr(ha, fn)(cfg), getattr(jax_ha, fn)(jcfg), fn)
    if cfg.family != "ssm":           # the reference's _attn_layers: attention families
        _rel_equal(ha._attn_layers(cfg), jax_ha._attn_layers(jcfg), "_attn_layers")
    for shape, n_chips, fsdp in itertools.product(configs.SHAPES.values(), (256, 512),
                                                  (True, False)):
        args = (shape.seq_len, shape.global_batch, shape.kind, n_chips)
        _rel_equal(ha.analytic_memory_per_device(cfg, *args, fsdp=fsdp),
                   jax_ha.analytic_memory_per_device(jcfg, *args, fsdp=fsdp), shape.name)
        _rel_equal(ha.analytic_min_bytes(cfg, *args), jax_ha.analytic_min_bytes(jcfg, *args),
                   shape.name)
        _rel_equal(ha.model_flops_train(cfg, shape.seq_len, shape.global_batch),
                   jax_ha.model_flops_train(jcfg, shape.seq_len, shape.global_batch), "train")
        _rel_equal(ha.model_flops_forward(cfg, shape.global_batch * 7),
                   jax_ha.model_flops_forward(jcfg, shape.global_batch * 7), "forward")
    rng = np.random.RandomState(len(arch))
    for _ in range(8):
        f, b, c = (float(x) for x in 10.0 ** rng.uniform(8, 16, size=3))
        mf = ha.model_flops_train(cfg, 4096, 256)
        got = ha.Roofline(f, b, c, 256, mf, peak_flops=jax_ha.PEAK_FLOPS,
                          hbm_bw=jax_ha.HBM_BW, link_bw=jax_ha.LINK_BW).to_dict()
        _rel_equal(got, jax_ha.Roofline(f, b, c, 256, mf).to_dict(), "roofline")
    assert ha.COLLECTIVE_MULT == jax_ha._MULT
    assert ha.Roofline(1.0, 1.0, 1.0, 1).peak_flops == 989e12


# ------------------------------------------------------------ meta routes
def _qkv(device, b=2, l=8, ctx=5, hq=4, hkv=2, hd=32, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, l, hq, hd, generator=g).to(dtype)
    k = torch.randn(b, ctx + l, hkv, hd, generator=g).to(dtype)
    v = torch.randn(b, ctx + l, hkv, hd, generator=g).to(dtype)
    return tuple(t.to(device) for t in (q, k, v))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_meta_routes_return_the_kernels_shapes(dtype):
    ctx = 5
    outs = {}
    for device in ("cpu", "meta"):
        ops.reset_meta()
        q, k, v = (t.requires_grad_(True) for t in _qkv(device, ctx=ctx, dtype=dtype))
        out = ops.terapipe_attention(q, k, v, ctx_len=ctx)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
        dec = ops.decode_attention(q[:, :1].detach(), k.detach(), v.detach(), ctx + 3)
        fwd = ops._fwd_meta if device == "meta" else ops.terapipe_attention_ref
        o2, lse = fwd(q.detach(), k.detach(), v.detach(), ctx)
        outs[device] = [(t.shape, t.dtype) for t in (out, dq, dk, dv, dec, o2, lse)]
        assert all(t.device.type == device for t in (out, dq, dk, dv, dec, o2, lse))
    assert outs["cpu"] == outs["meta"]
    b, l, hq, hd = 2, 8, 4, 32
    pairs = b * hq * (l * ctx + l * (l + 1) // 2)
    assert pairs == ops.attention_pairs(b, l, ctx, hq)
    assert {k: (e["calls"], e["flops"]) for k, e in ops.META.items()} == {
        "terapipe_attention_fwd": (2, 2 * 4 * hd * pairs),
        "terapipe_attention_dq": (1, 6 * hd * pairs),
        "terapipe_attention_dkv": (1, 8 * hd * pairs),
        "decode_attention": (1, 4 * hd * hq * b * (ctx + 3))}
    with pytest.raises(ValueError, match="head dim"):
        ops.terapipe_attention(*_qkv("meta", hd=48), ctx_len=ctx)


def test_meta_routes_count_the_calls_of_a_cpu_step(monkeypatch):
    """A gpt3 SMOKE train step with kernels: the meta run's calls per
    kernel are the CPU run's calls of the plain versions."""
    cfg = configs.get_config("gpt3-1b", smoke=True).replace(use_kernel=True, remat=True)
    calls = {"fwd": 0, "bwd": 0}

    def counted(fn, key):
        def wrapper(*a):
            calls[key] += 1
            return fn(*a)
        return wrapper

    monkeypatch.setattr(ops, "terapipe_attention_ref", counted(ops.terapipe_attention_ref, "fwd"))
    monkeypatch.setattr(ops, "terapipe_attention_bwd_ref",
                        counted(ops.terapipe_attention_bwd_ref, "bwd"))
    shape = ShapeSpec("x", 32, 2, "train")
    dryrun.trace_gspmd(cfg, shape, Mesh(data=1, model=1), device="cpu")
    res = dryrun.trace_gspmd(cfg, shape, Mesh(data=1, model=1))
    assert calls == {"fwd": 2 * cfg.n_layers, "bwd": cfg.n_layers}
    assert res["kernel_calls"] == {"terapipe_attention_fwd": calls["fwd"],
                                   "terapipe_attention_dq": calls["bwd"],
                                   "terapipe_attention_dkv": calls["bwd"],
                                   "decode_attention": 0}


class _OnCuda:
    """A stand-in whose device says cuda (no GPU here)."""
    device = torch.device("cuda")


def test_dispatch_sends_each_device_to_its_route(monkeypatch):
    """CPU tensors reach only the plain versions, CUDA tensors (a stand-in
    here) only the kernels, meta tensors neither; other devices raise."""
    seen = []
    for name in ("terapipe_attention_fwd", "terapipe_attention_bwd", "decode_attention_kernel",
                 "terapipe_attention_ref", "terapipe_attention_bwd_ref", "decode_attention_ref"):
        monkeypatch.setattr(ops, name, lambda *a, name=name: seen.append(name) or ("o", "l"))

    class Ctx:
        saved_tensors = None

        def save_for_backward(self, *a):
            self.saved_tensors = a

    def both(q, k, v):
        ctx = Ctx()
        ops._FlashAttention.forward(ctx, q, k, v, 5)
        ops.decode_attention(q[:, :1] if torch.is_tensor(q) else q, k, v, 3)
        return ctx

    cuda = _OnCuda()
    both(cuda, cuda, cuda)
    assert seen == ["terapipe_attention_fwd", "decode_attention_kernel"]
    seen.clear()
    q, k, v = _qkv("cpu")
    both(q, k, v)
    assert seen == ["terapipe_attention_ref", "decode_attention_ref"]
    seen.clear()
    ctx = both(*(t.to("meta") for t in (q, k, v)))
    ops._FlashAttention.backward(ctx, torch.ones_like(ctx.saved_tensors[0]))
    assert seen == []

    class OnXpu:
        device = torch.device("xpu")
    with pytest.raises(ValueError, match="cpu .*cuda .*meta"):
        ops.decode_attention(OnXpu(), OnXpu(), OnXpu(), 3)


# ------------------------------------------- serving under a one-rank group
class _ThreadGroup:
    """One rank of a tensor-parallel axis per thread, as one process of a
    process group: ``all_reduce`` sums the ranks' values in rank order."""

    def __init__(self, rank: int, size: int, shared: dict):
        self.rank, self.size, self.ranks, self.shared = rank, size, (rank,), shared

    def all_reduce(self, values):
        vals, barrier = self.shared["vals"], self.shared["barrier"]
        vals[self.rank] = values[0]
        barrier.wait()
        total = vals[0]
        for v in vals[1:]:
            total = total + v
        barrier.wait()
        return [total]

    def region(self, x):
        return [x]


@pytest.mark.parametrize("arch,tp", [("gpt3-1b", 2), ("qwen3-0.6b", 2), ("qwen3-0.6b", 4)])
def test_serving_modes_under_a_one_rank_group(arch, tp):
    """``attn_sliced`` and ``attn_decode`` (scalar and per-row positions)
    with each tp rank in a thread of its own, its heads and its cache, as
    the dry run's gspmd prefill and decode cells run one rank: the ranks'
    outputs summed by the group equal the unsharded modes' (f32, 1e-5); a
    group hosting several ranks is refused."""
    import threading
    from repro_torch.core import pipeline
    from repro_torch.distributed import sharding
    from repro_torch.models import attention
    from repro_torch.models.common import LocalGroup
    cfg = configs.get_config(arch, smoke=True).replace(dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    p = attention.init_attn(gen, cfg)
    x = torch.randn(2, 6, cfg.d_model, generator=gen)
    tok = torch.randn(2, 1, cfg.d_model, generator=gen)
    pspecs = sharding.map_specs(lambda sp: sharding.PartitionSpec(
        *pipeline._leaf_pspec((None,) + tuple(sp), "tp", tp, "pipe", cfg)[1:]),
        attention.attn_specs(cfg))
    rows = torch.tensor([7, 3])

    def run(p, cfg):
        cache = tuple(torch.zeros(2, 8, cfg.n_kv_heads, cfg.hd) for _ in range(2))
        y, cache = attention.attn_sliced(p, cfg, x, cache, 0)
        d, _ = attention.attn_decode(p, cfg, tok, cache, 6)
        b, _ = attention.attn_decode(p, cfg, tok, tuple(c.clone() for c in cache), rows)
        return y, d, b

    want = run(p, cfg)
    shared = {"vals": [None] * tp, "barrier": threading.Barrier(tp, timeout=60)}
    got, errors = [None] * tp, []

    def rank(r):
        try:
            got[r] = run_rank(r)
        except Exception as e:              # re-raised below, in the test's thread
            errors.append(e)
            shared["barrier"].abort()

    def run_rank(r):
        group = _ThreadGroup(r, tp, shared)
        local = cfg.replace(tp_axis=group, head_dim=cfg.hd, n_heads=cfg.n_heads // tp,
                            n_kv_heads=attention.tp_local_kv_heads(cfg.n_heads,
                                                                   cfg.n_kv_heads, tp))
        shard = sharding.local_shard_tree(p, pspecs, Mesh(tp=tp), {"tp": r})
        return run(attention.tp_rank_attn(shard, cfg, tp, r), local)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    for r in range(tp):
        for a, b in zip(got[r], want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="several ranks"):
        attention.attn_sliced([p, p], cfg.replace(tp_axis=LocalGroup(2)), x,
                              tuple(torch.zeros(2, 8, cfg.n_kv_heads, cfg.hd)
                                    for _ in range(2)), 0)


# --------------------------------------------------------------- FLOPs
def test_train_step_flops_match_the_reference_hlo():
    """gpt3 SMOKE, batch 2 x 64, plain attention, remat on: the trace's
    FLOPs (every matmul, the attention's included) against the dots of the
    reference's compiled step.  They differ by what XLA adds to the dots
    the model writes: none here beyond the 2% bound."""
    shape = ShapeSpec("x", 64, 2, "train")
    cfg = configs.get_config("gpt3-1b", smoke=True).replace(remat=True)
    res = dryrun.trace_gspmd(cfg, shape, Mesh(data=1, model=1))
    jmodel = jax_build_model(jax_configs.get_config("gpt3-1b", smoke=True).replace(remat=True))
    jopt = jax_adamw.adamw(jax_adamw.cosine_schedule(3e-4, 100, 10_000))
    structs, _ = jax_steps.abstract_init(jmodel)
    o_structs = jax_steps.abstract_opt_state(jopt, structs)
    batch = jax_configs.input_specs(jmodel.cfg, jax_configs.ShapeSpec("x", 64, 2, "train"))
    hlo = jax.jit(jax_steps.make_train_step(jmodel, jopt)).lower(
        structs, o_structs, batch).compile().as_text()
    want = hlo_tripcount.analyze(hlo)["flops"]
    assert abs(res["flops"] - want) <= 0.02 * want, (res["flops"], want)

    # the account's registry count is FlopCounterMode's on the same step
    model = build_model(cfg, "meta")
    params = model.init(0)
    opt = adamw(cosine_schedule(3e-4, 100, 10_000))
    state = opt.init(params)
    batch = configs.input_specs(cfg, shape)
    with FlopCounterMode(display=False) as fc:
        make_train_step(model, opt)(params, state, batch)
    assert fc.get_total_flops() == res["flops"]


# ------------------------------------------------------------ the account
def test_account_follows_a_storages_life():
    """Meta tensors all have data_ptr 0; the account keys a storage on its
    one Python object, which dies with the storage: a view keeps it alive
    after its base is gone, and the bytes go when the last view does."""
    acct = Account(block=1)
    with acct:
        a = torch.empty(1000, device="meta")             # 4000 B
        assert a.untyped_storage() is a.untyped_storage()
        view = a[10:20]
        del a
        assert len(acct.live) == 1
        b = torch.empty(10, device="meta")               # 40 B
        del view
        assert len(acct.live) == 1
        c = b * 2                                        # 40 B
        del b, c
    assert acct.events == [(0, 1), (1, 1), (0, -1), (2, 1), (1, -1), (2, -1)]
    assert acct.peaks() == {None: (4040.0, 1)}
    assert acct.breakdown(None, 1)["transient"] == 4040.0


def test_account_is_the_same_on_cpu_and_meta():
    """The same gpt3 SMOKE train step (plain attention, remat on) on CPU
    tensors and on meta: every allocation and free in the same order, so
    the same peak, breakdown, FLOPs and bytes."""
    cfg = configs.get_config("gpt3-1b", smoke=True).replace(remat=True)
    shape = ShapeSpec("x", 32, 2, "train")
    cpu = dryrun.trace_gspmd(cfg, shape, Mesh(data=1, model=1), device="cpu")
    meta = dryrun.trace_gspmd(cfg, shape, Mesh(data=1, model=1))
    for key in ("peak_above_state", "by_category", "flops", "bytes_accessed", "state_bytes",
                "events"):
        assert cpu[key] == meta[key], key
    assert meta["largest_off_meta_bytes"] == 0
    by = meta["by_category"]            # at this size the optimizer's update sets the peak
    assert by["opt_state"] > 0 and by["grads"] > 0 and by["transient"] > 0


def test_terapipe_account_gives_each_pipe_rank_its_units():
    """gpt3 SMOKE on pipe 2 (contiguous and 1f1b, kernels): one device's
    numbers (its units, the shared work, its share of the state) are below
    the whole process's, and the two ranks' FLOPs and the shared ones sum
    to the process's; the calls are the same."""
    from repro_torch.core.pipeline import TeraPipeConfig
    cfg = configs.get_config("gpt3-1b", smoke=True).replace(use_kernel=True)
    shape = ShapeSpec("x", 32, 2, "train")
    for schedule in ("contiguous", "1f1b"):
        tcfg = TeraPipeConfig(n_token_slices=2, schedule=schedule)
        one = dryrun.trace_terapipe(cfg, shape, Mesh(pipe=2), tcfg)
        whole = dryrun.trace_terapipe(cfg, shape, Mesh(pipe=2), tcfg, per_device=False)
        assert one["kernel_calls"] == whole["kernel_calls"]
        recompute = 2 if schedule == "1f1b" else 1     # a backward unit reruns its forward
        assert one["kernel_calls"]["terapipe_attention_fwd"] == 2 * cfg.n_layers * recompute
        assert 0 < one["peak_above_state"] < whole["peak_above_state"], schedule
        assert one["state_bytes"] < whole["state_bytes"]
        assert 0.5 * whole["flops"] < one["flops"] < whole["flops"]
        assert one["counted"]["collective-permute"] > 0


# ---------------------------------------------------------------- cells
SMOKE_SHAPE = {"train": ShapeSpec("x", 32, 4, "train"), "prefill": ShapeSpec("x", 32, 4, "prefill"),
               "decode": ShapeSpec("x", 32, 4, "decode")}


def _smoke_cell(arch, shape_name, mode, tmp_path, **kw):
    shape = configs.SHAPES[shape_name]
    mesh = Mesh(data=2, model=2) if mode == "gspmd" else Mesh(data=2, pipe=2)
    return dryrun.run_cell(arch, shape_name, mode=mode, smoke=True,
                           shape=SMOKE_SHAPE[shape.kind], mesh=mesh, out_dir=str(tmp_path),
                           terapipe_pipe=2, terapipe_slices=2, **kw)


def test_every_smoke_cell(tmp_path, capsys):
    failed, whisper = {}, {}
    for arch, shape_name, mode in itertools.product(configs.ARCHS, configs.SHAPES,
                                                    ("gspmd", "terapipe")):
        rec = _smoke_cell(arch, shape_name, mode, tmp_path, use_kernel=True)
        tag = dryrun.cell_tag(arch, shape_name, False, mode)
        assert (tmp_path / f"{tag}.json").exists()
        if rec.get("skipped"):
            assert rec["skipped"] == configs.skip_reason(arch, shape_name)
            continue
        if not rec["ok"]:
            failed[tag] = rec["error"].split(":")[0]
            continue
        mem = rec["memory"]
        assert mem["peak_bytes"] == mem["state_bytes"] + mem["peak_above_state"] > 0
        assert abs(sum(mem["by_category"].values()) - mem["peak_above_state"]) < 1e-6
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0 and rec["largest_off_meta_bytes"] == 0
        assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
        kind = configs.SHAPES[shape_name].kind
        calls = rec["kernel_calls"]
        family = configs.get_config(arch).family
        if family in ("ssm", "hybrid"):
            assert not any(calls.values()), tag
        elif kind == "decode":
            assert calls["decode_attention"] > 0 and calls["terapipe_attention_fwd"] == 0, tag
        else:
            assert calls["terapipe_attention_fwd"] > 0, tag
            assert (calls["terapipe_attention_dq"] > 0) == (kind == "train"), tag
        if mode == "terapipe":
            assert rec["collectives_counted"]["collective-permute"] > 0
            assert rec["collectives_derived"]["collective-permute"] > 0
        elif arch == "whisper-medium":
            whisper[kind] = rec["collectives_counted"]["all-reduce"]
    capsys.readouterr()
    # whisper's TP-local program sums every block's partials: per encoder
    # layer attention and FFN, per decoder layer self-attention,
    # cross-attention and FFN (one all-reduce each on the activation, rows
    # x d_model in bf16, ring weight 2); the backward pass sums each
    # region's input gradient, and the encoder output's once per decoder
    # layer (its cross K/V projection)
    cfg = configs.get_config("whisper-medium", smoke=True)
    n_enc, n_dec, s = cfg.n_enc_layers, cfg.n_dec_layers, SMOKE_SHAPE["train"].seq_len
    unit = SMOKE_SHAPE["train"].global_batch * cfg.d_model * 2 * 2
    assert whisper == {"decode": 3 * n_dec * unit,
                       "prefill": (2 * n_enc + 3 * n_dec) * s * unit,
                       "train": (2 * (2 * n_enc + 3 * n_dec) + n_dec) * s * unit}, whisper
    refused = {dryrun.cell_tag(a, s, False, "gspmd"): "NotImplementedError"
               for a in ("mamba2-2.7b", "recurrentgemma-9b") for s in configs.SHAPES}
    refused.update({dryrun.cell_tag(a, s, False, "terapipe"): "ValueError"
                    for a in configs.ARCHS for s in ("prefill_32k", "decode_32k", "long_500k")
                    if not configs.skip_reason(a, s)})
    refused[dryrun.cell_tag("whisper-medium", "train_4k", False, "terapipe")] = \
        "NotImplementedError"
    assert failed == refused


def test_full_gpt3_gspmd_cell(tmp_path):
    """gpt3-1b train_4k on the production mesh: one device holds 1 of 16
    heads per layer at 16 rows; the traced FLOPs are within a few percent
    of the useful 6·N·D share plus the attention."""
    rec = dryrun.run_cell("gpt3-1b", "train_4k", out_dir=str(tmp_path))
    assert rec["ok"] and rec["n_chips"] == 256
    assert rec["program"].startswith("TP-local model (1 heads")
    assert rec["memory"]["placement_state_bytes"]["params"] < rec["memory"]["state_bytes"]
    assert rec["collectives_counted"]["all-reduce"] > 0
    assert rec["collectives_derived"]["all-gather"] > 0
    assert 1.0 < rec["roofline"]["useful_ratio"] * 3 < 3.0
    assert rec["memory"]["by_category"]["saved"] > 0


@pytest.mark.parametrize("flag", ["--save-hlo", "--compile", "--compare-executors"])
def test_cli_refuses_what_has_no_counterpart(flag, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main([flag, "--arch", "gpt3-1b", "--shape", "train_4k"])
    assert e.value.code == 2
    assert "the port" in capsys.readouterr().err
