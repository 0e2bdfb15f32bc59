"""The port's parallel layer against the JAX package's, in one process.

* (a) sharding rules: ``spec_to_pspec`` over every leaf of every FULL arch
  of ``ARCHS``, with FSDP on and off, on the single- and multi-pod
  production meshes and on the TeraPipe meshes of 4 and 8 stages;
  ``batch_shardings`` and ``cache_pspec`` on every arch's cells: each the
  reference's ``PartitionSpec`` exactly (the reference runs on a
  ``jax.sharding.AbstractMesh``: its rules read only ``mesh.shape``);
* (b) the tensor-parallel blocks at tp 2 and 4 (``attn_full``,
  ``attn_sliced_dyn``, ``ffn``, ``moe_ffn`` with DeepSeek's shared
  experts): output and gradients in f32 within 2e-4 of the reference's
  same function under ``jax.vmap(..., axis_name="tp")`` over the same
  shards, and of the unsharded reference;
* (c) the two faults of the reference: with replicated KV heads the port
  matches the unsharded forward and the reference misses it; the rec
  block, mamba2, the explicit-backward schedules and the serving modes
  refuse TP;
* (d) the pipelined step on meshes with data and tp axes against JAX's
  ``value_and_grad(model.loss)`` (the reference's own bounds for its two
  system cases), and the stage placements against the reference's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.core.pipeline as jax_pipeline
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jax_sharding
from repro.launch import steps as jax_steps
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models import rglru as jax_rglru
from repro_torch import configs
from repro_torch.core import pipeline
from repro_torch.core.pipeline import TeraPipeConfig, make_terapipe_value_and_grad
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import attention, build_model, layers, moe, rglru, ssm
from repro_torch.models.attention import tp_local_kv_heads
from repro_torch.models.common import LocalGroup
from repro_torch.tree import tree_items, tree_leaves, tree_map
from repro_torch.weights import params_from_jax

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

TOL = 2e-4


# ------------------------------------------------------- (a) sharding rules
MESHES = {
    "pod": mesh_mod.make_production_mesh(),
    "multi-pod": mesh_mod.make_production_mesh(multi_pod=True),
    "terapipe-4": mesh_mod.make_terapipe_mesh(n_pipe=4),
    "terapipe-8": mesh_mod.make_terapipe_mesh(n_pipe=8),
}


def _abstract(mesh: Mesh) -> AbstractMesh:
    return AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)


def _rules(mesh: Mesh) -> dict:
    """The default rules, on ``tp`` where the mesh has no ``model`` axis."""
    axis = "model" if "model" in mesh.shape else "tp"
    return {k: (axis if v else None) for k, v in sharding.DEFAULT_RULES.items()}


def _get(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


def test_meshes_are_the_references():
    for m in MESHES.values():
        assert m.shape["data"] == 16 and m.size in (256, 512)
    assert MESHES["terapipe-4"].shape == {"data": 16, "pipe": 4, "tp": 4}
    assert MESHES["multi-pod"].axis_names == ("pod", "data", "model")
    assert mesh_mod.data_axes(MESHES["multi-pod"]) == ("pod", "data")
    with pytest.raises(AssertionError):
        mesh_mod.make_terapipe_mesh(n_pipe=3)


@functools.lru_cache(maxsize=None)
def _abstract_init(arch):
    return steps.abstract_init(build_model(configs.get_config(arch), "meta"))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_spec_to_pspec_matches_jax(mesh_name):
    """Every leaf (parameters; their shapes are the meta structures'),
    every FULL arch of ARCHS, FSDP off and on: the reference's
    PartitionSpec entry for entry; the batch of every cell too."""
    mesh = MESHES[mesh_name]
    jmesh, rules = _abstract(mesh), _rules(mesh)
    fsdp = mesh_mod.data_axes(mesh)
    n = 0
    for arch in configs.ARCHS:
        cfg = configs.get_config(arch)
        structs, specs = _abstract_init(arch)
        shapes = dict(tree_items(structs))
        for fsdp_axes in (None, fsdp):
            port = sharding.param_shardings(specs, structs, mesh, rules=rules,
                                            fsdp_axes=fsdp_axes)
            for path, ns in _sharding_items(port):
                spec = _get(specs, path)
                want = jax_sharding.spec_to_pspec(spec, rules, jmesh, tuple(shapes[path].shape),
                                                  fsdp_axes)
                assert ns.spec == tuple(want), (arch, path, fsdp_axes, ns.spec, want)
                assert ns.mesh is mesh
                n += 1
        for shape in configs.SHAPES.values():
            if configs.skip_reason(arch, shape.name) is None:
                batch = configs.input_specs(cfg, shape)
                got = sharding.batch_shardings(batch, mesh, fsdp)
                want = jax_sharding.batch_shardings(
                    {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.int32) for k, v in batch.items()},
                    jmesh, fsdp)
                assert {k: v.spec for k, v in got.items()} == {
                    k: tuple(v.spec) for k, v in want.items()}, (arch, shape.name)
    assert n > 300


def test_cache_pspec_and_gspmd_shardings_match_jax():
    """cache_pspec on every FULL arch's abstract caches of each decode and
    prefill cell (batch and length of the cell), on both production meshes;
    gspmd_shardings' optimizer layout is the parameters'."""
    for mesh in (MESHES["pod"], MESHES["multi-pod"]):
        jmesh, dax = _abstract(mesh), mesh_mod.data_axes(mesh)
        for arch in configs.ARCHS:
            model = build_model(configs.get_config(arch), "meta")
            for shape in configs.SHAPES.values():
                if shape.kind == "train" or configs.skip_reason(arch, shape.name):
                    continue
                caches = steps.abstract_caches(model, shape.global_batch, shape.seq_len)
                got = steps.cache_shardings(caches, mesh, dax)
                for (_, c), (_, ns) in zip(tree_items(caches), _sharding_items(got)):
                    assert ns.spec == tuple(jax_steps.cache_pspec(tuple(c.shape), jmesh, dax)), (
                        arch, shape.name, tuple(c.shape))
    from repro_torch.optim.adamw import adamw
    cfg = configs.get_config("gpt3-1b")
    structs, specs, p_sh, o_structs, o_sh = steps.gspmd_shardings(
        build_model(cfg, "meta"), MESHES["pod"], optimizer=adamw(1e-3, master_weights=True),
        param_dtype=torch.bfloat16)
    assert o_sh.step.spec == () and o_sh.m == p_sh == o_sh.v == o_sh.master
    assert next(tree_leaves(structs)).dtype == torch.bfloat16


def _is_sharding(x):
    return isinstance(x, sharding.NamedSharding)


def _sharding_items(tree, prefix=""):
    if _is_sharding(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _sharding_items(v, f"{prefix}/{k}")
    else:
        for i, v in enumerate(tree):
            yield from _sharding_items(v, f"{prefix}/{i}")


def test_local_shard_cuts_the_blocks_shard_map_hands_out():
    mesh = Mesh(data=2, tp=3)
    t = torch.arange(4 * 6 * 5).reshape(4, 6, 5)
    spec = sharding.PartitionSpec("data", ("tp",))
    blocks = [[sharding.local_shard(t, spec, mesh, {"data": d, "tp": r}) for r in range(3)]
              for d in range(2)]
    assert torch.equal(torch.cat([torch.cat(row, 1) for row in blocks], 0), t)
    both = sharding.PartitionSpec(None, ("data", "tp"))
    cut = [sharding.local_shard(t, both, mesh, {"data": d, "tp": r})
           for d in range(2) for r in range(3)]
    assert torch.equal(torch.cat(cut, 1), t) and cut[4].shape == (4, 1, 5)
    assert sharding.local_shard(t, sharding.PartitionSpec(), mesh, {}) is t


# --------------------------------------------------- (b) tensor-parallel blocks
def _layer_pspecs(specs, tp, cfg):
    """One layer's stage placements without the layer axis (the port's
    ``_leaf_pspec``, held to the reference's in (d))."""
    return sharding.map_specs(lambda s: sharding.PartitionSpec(
        *pipeline._leaf_pspec((None,) + tuple(s), "tp", tp, "pipe", cfg)[1:]), specs)


def _shards(p_full, pspecs, tp):
    return [sharding.local_shard_tree(p_full, pspecs, Mesh(tp=tp), {"tp": r}) for r in range(tp)]


def _attn_shards(p_full, pspecs, tp, cfg):
    """The ranks' attention parameters as the pipeline hands them out:
    their blocks, with the KV heads each reads where they are replicated."""
    return [attention.tp_rank_attn(s, cfg, tp, r) for r, s in
            enumerate(_shards(p_full, pspecs, tp))]


def _jax_stack(shards):
    return tree_map(lambda *xs: jnp.stack([np.asarray(x.detach()) for x in xs]), *shards)


def _unstack_grads(stacked, pspecs):
    """The reference's per-rank gradients of the stacked shards -> the full
    parameter's: concatenated along a sharded dim, summed where every rank
    holds a copy."""
    def one(spec, g):
        g = np.asarray(g)
        for dim, e in enumerate(spec):
            if e is not None:
                return np.concatenate(list(g), axis=dim)
        return g.sum(0)
    return sharding.map_specs(one, pspecs, stacked)


def _local_cfgs(jcfg, cfg, tp, group):
    kv = jcfg.n_kv_heads // tp if jcfg.n_kv_heads % tp == 0 else jcfg.n_kv_heads
    jloc = jcfg.replace(tp_axis="tp", head_dim=jcfg.hd, n_heads=jcfg.n_heads // tp, n_kv_heads=kv)
    loc = cfg.replace(tp_axis=group, head_dim=cfg.hd, n_heads=cfg.n_heads // tp,
                      n_kv_heads=tp_local_kv_heads(cfg.n_heads, cfg.n_kv_heads, tp))
    return jloc, loc


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=what)


def _tp_case(arch, sub, fn_port, fn_jax, x, tp):
    """Layer 0's ``sub`` parameters of ``arch`` SMOKE (f32), sharded at
    ``tp``: the port's TP output and gradients (parameters and x) against
    the reference under vmap and unsharded.  ``fn_port(shards, cfg, x)``
    and ``fn_jax(p, cfg, x)`` (``cfg.tp_axis`` "tp" under vmap, else
    None) return the output first."""
    jcfg, cfg = _f32(arch)
    group_name = "moe" if cfg.family == "moe" else "blocks"
    jp = jax.tree.map(lambda a: a[0], _jax_params(arch)["groups"][group_name][sub])
    spec = build_model(cfg, "meta").specs()["groups"][group_name]
    pspecs = _layer_pspecs(sharding.map_specs(lambda s: tuple(s[1:]), spec[sub]), tp, cfg)
    jloc, loc = _local_cfgs(jcfg, cfg, tp, LocalGroup(tp))
    first = lambda out: out[0] if isinstance(out, tuple) else out

    p_full = tree_map(lambda a: a.requires_grad_(True), params_from_jax(jp, "cpu"))
    xt = torch.from_numpy(x).requires_grad_(True)
    g = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    y = first(fn_port(_shards(p_full, pspecs, tp), loc, xt))
    paths = [path for path, _ in tree_items(p_full)]
    grads = torch.autograd.grad((y * torch.from_numpy(g)).sum(),
                                [_get(p_full, q) for q in paths] + [xt])

    def vmapped(ps, x):
        return jax.vmap(lambda p: first(fn_jax(p, jloc, x)), axis_name="tp")(ps)

    def unsharded(p, x):
        return first(fn_jax(p, jcfg, x))

    # one compiled call each: the output and the gradients of <out, g>
    # (the vmapped output's rank 0: each rank's output is the same sum)
    def with_grads(fn, pick):
        return jax.jit(lambda p, x: (fn(p, x), jax.grad(
            lambda p, x: jnp.sum(pick(fn(p, x)) * g), argnums=(0, 1))(p, x)))

    stacked, xj = _jax_stack(_shards(p_full, pspecs, tp)), jnp.asarray(x)
    yv, (gv_p, gv_x) = with_grads(vmapped, lambda y: y[0])(stacked, xj)
    gv = _unstack_grads(gv_p, pspecs)
    yu, (gu_p, gu_x) = with_grads(unsharded, lambda y: y)(jp, xj)
    for r in range(tp):
        _close(y, yv[r], f"output vs vmapped rank {r}")
    _close(y, yu, "output vs unsharded")
    for path, gp in zip(paths, grads):
        _close(gp, _get(gv, path), f"grad {path} vs vmapped")
        _close(gp, _get(gu_p, path), f"grad {path} vs unsharded")
    _close(grads[-1], gv_x, "grad x vs vmapped")
    _close(grads[-1], gu_x, "grad x vs unsharded")


def _x(shape, seed=3):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# qwen3 (qk_norm, GQA 2) in the full mode only: the sliced mode shares its
# projections and adds only the cache rows
ATTN_CASES = [("gpt3-1b", 2), ("gpt3-1b", 4), ("qwen3-0.6b", 2)]


@pytest.mark.parametrize("arch,tp", ATTN_CASES, ids=[f"{a}-tp{t}" for a, t in ATTN_CASES])
def test_attn_full_tp_matches_jax(arch, tp):
    _tp_case(arch, "attn", attention.attn_full, jax_attn.attn_full, _x((2, 16, 64)), tp)


@pytest.mark.parametrize("arch,tp", ATTN_CASES[:2], ids=[f"{a}-tp{t}" for a, t in ATTN_CASES[:2]])
def test_attn_sliced_dyn_tp_matches_jax(arch, tp):
    """A slice of 8 at ctx 8 over a cache whose first 8 rows hold a random
    prefix; each rank's cache is its block of the KV heads."""
    cfg = configs.get_config(arch, smoke=True)
    L, ctx, kv_local = 24, 8, cfg.n_kv_heads // tp
    full = _x((2, L, cfg.n_kv_heads, cfg.hd), 5)
    full[:, ctx:] = 0
    blocks = [full[:, :, r * kv_local:(r + 1) * kv_local] for r in range(tp)]
    stacked = jnp.stack([jnp.asarray(b) for b in blocks])

    def port(p, cfg, x):
        caches = [tuple(torch.from_numpy(b.copy()) for _ in range(2)) for b in blocks]
        return attention.attn_sliced_dyn(p, cfg, x, caches, ctx)

    def ref(p, cfg, x):
        c = jnp.asarray(full) if cfg.tp_axis is None else stacked[jax.lax.axis_index("tp")]
        return jax_attn.attn_sliced_dyn(p, cfg, x, (c, c), ctx)

    _tp_case(arch, "attn", port, ref, _x((2, 8, 64)), tp)


@pytest.mark.parametrize("tp", [2, 4])
def test_ffn_tp_matches_jax(tp):
    def port(p, cfg, x):
        return layers.ffn(p, x, cfg.tp_axis)

    def ref(p, cfg, x):
        return jax_layers.ffn(p, x, cfg.tp_axis)

    _tp_case("gpt3-1b", "ffn", port, ref, _x((2, 16, 64)), tp)


@pytest.mark.parametrize("tp", [2, 4])
def test_moe_ffn_expert_parallel_matches_jax(tp):
    """DeepSeek SMOKE (8 experts, top 2, 2 shared): each rank 8/tp experts
    and its block of the shared experts' ff; routing global."""
    _tp_case("deepseek-moe-16b", "moe", moe.moe_ffn, jax_moe.moe_ffn, _x((2, 16, 64)), tp)


def test_moe_routing_is_global_under_tp():
    """The routing record of a TP call equals the unsharded call's: one
    routing per call, over every expert."""
    cfg = configs.get_config("deepseek-moe-16b", smoke=True).replace(dtype=torch.float32)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    spec = moe.moe_specs(cfg)
    x = torch.from_numpy(_x((2, 16, 64)))
    logs = []
    for tp in (1, 2):
        moe.ROUTING_LOG = []
        try:
            if tp == 1:
                moe.moe_ffn(p, cfg, x)
            else:
                shards = _shards(p, _layer_pspecs(spec, tp, cfg), tp)
                moe.moe_ffn(shards, _local_cfgs(jax_get_config("deepseek-moe-16b", smoke=True),
                                                cfg, tp, LocalGroup(tp))[1], x)
            logs.append(moe.ROUTING_LOG)
        finally:
            moe.ROUTING_LOG = None
    assert len(logs[0]) == len(logs[1]) == 1
    for a, b in zip(logs[0][0][1:3], logs[1][0][1:3]):
        assert torch.equal(a, b)


def test_tp_axis_name_raises():
    """The reference's kind of ``tp_axis``, a mesh axis name, is refused."""
    cfg = configs.get_config("gpt3-1b", smoke=True).replace(tp_axis="model")
    p = layers.init_ffn(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(TypeError, match="group"):
        layers.ffn([p], torch.zeros(1, 4, cfg.d_model), cfg.tp_axis)


def test_serving_attention_refuses_tp():
    """The serving modes take no tensor parallelism, as the reference's
    serving has none: ``attn_sliced`` and ``attn_decode`` raise on a
    group; without one, a block's one-rank list is its dict."""
    cfg = configs.get_config("gpt3-1b", smoke=True).replace(dtype=torch.float32)
    p = attention.init_attn(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(1, 4, cfg.d_model, generator=torch.Generator().manual_seed(1))

    def cache():
        return tuple(torch.zeros(1, 8, cfg.n_kv_heads, cfg.hd) for _ in range(2))

    tp = cfg.replace(tp_axis=LocalGroup(2))
    with pytest.raises(ValueError, match="serving"):
        attention.attn_sliced([p, p], tp, x, cache(), 0)
    with pytest.raises(ValueError, match="serving"):
        attention.attn_decode([p, p], tp, x[:, :1], cache(), 0)
    assert torch.equal(attention.attn_sliced([p], cfg, x, cache(), 0)[0],
                       attention.attn_sliced(p, cfg, x, cache(), 0)[0])


# --------------------------------------------------------- (c) the two faults
# fault 1's layer: phi3-mini SMOKE with 8 heads of 16 over 2 KV heads, f32
FAULT1 = (("n_heads", 8), ("n_kv_heads", 2), ("head_dim", 16))


# a second layout of replicated KV heads: 12 heads over 4 at tp 3, so a
# rank's 4 q heads straddle two GQA groups and it selects one KV head each
# (d_ff 192: the ff axis is sharded over tp unchecked, as in the reference)
FAULT1_STRADDLE = (("n_heads", 12), ("n_kv_heads", 4), ("head_dim", 16), ("d_ff", 192))


@pytest.mark.parametrize("changes,tp,n_local", [(FAULT1, 4, 1), (FAULT1_STRADDLE, 3, 4)],
                         ids=["8-over-2-tp4", "12-over-4-tp3"])
def test_replicated_kv_heads_pair_with_their_q_heads(changes, tp, n_local):
    """Fault 1: where tp does not divide the KV heads they are replicated,
    and rank r's local q head j reads KV head (r·Hq_local + j) // (Hq //
    Hkv) (at 8 over 2 and tp 4: q heads 2r, 2r+1 read head r // 2).  The
    port matches the unsharded forward; the reference (local GQA over the
    replicated heads) misses it by > 0.1."""
    jcfg, cfg = (c.replace(**dict(changes)) for c in _f32("phi3-mini-3.8b"))
    jp = jax.tree.map(lambda a: a[0], _jax_params("phi3-mini-3.8b", **dict(changes))[
        "groups"]["blocks"]["attn"])
    p = params_from_jax(jp, "cpu")
    pspecs = _layer_pspecs(attention.attn_specs(cfg), tp, cfg)
    assert pspecs["wk"] == (None, None) and pspecs["wq"] == (None, "tp")
    jloc, loc = _local_cfgs(jcfg, cfg, tp, LocalGroup(tp))
    assert loc.n_kv_heads == n_local
    x = _x((2, 16, 64))
    want = np.asarray(jax.jit(lambda p, x: jax_attn.attn_full(p, jcfg, x))(jp, x))
    got = attention.attn_full(_attn_shards(p, pspecs, tp, cfg), loc, torch.from_numpy(x))
    _close(got, want, f"port under tp {tp} vs unsharded")
    ref = jax.jit(jax.vmap(lambda q, x: jax_attn.attn_full(q, jloc, x), in_axes=(0, None),
                           axis_name="tp"))(_jax_stack(_shards(p, pspecs, tp)), x)
    err = float(np.max(np.abs(np.asarray(ref[0]) - want)))
    assert err > 0.1, (err, float(np.max(np.abs(want))))


@pytest.mark.parametrize("changes,tp", [(FAULT1, 4), (FAULT1_STRADDLE, 3)],
                         ids=["8-over-2-tp4", "12-over-4-tp3"])
def test_replicated_kv_heads_in_the_pipeline_match_jax(changes, tp):
    """Fault 1 through the pipelined step (pipe 2 x tp, f32): loss and
    every gradient within 2e-4 of JAX's unsharded value_and_grad, the wk/wv
    gradients summed over the ranks' selections."""
    _pipeline_case("phi3-mini-3.8b", Mesh(pipe=2, tp=tp), TeraPipeConfig(
        n_token_slices=2, cache_dtype=torch.float32), loss_tol=TOL, grad_tol=TOL,
        changes=changes)


def test_rec_block_mamba2_and_explicit_schedules_refuse_tp():
    """Fault 2: the reference's rec block fails under TP (a dot_general
    shape error); the port's raises, naming it; so does the hybrid
    pipeline at tp 2.  mamba2 raises, as the reference asserts.  An
    explicit-backward schedule with tp 2 raises in both packages."""
    group = LocalGroup(2)
    rg = configs.get_config("recurrentgemma-9b", smoke=True).replace(dtype=torch.float32)
    p = rglru.init_rec_block(torch.Generator().manual_seed(0), rg)
    x = torch.zeros(1, 8, rg.d_model)
    with pytest.raises(NotImplementedError, match="w_a and w_i"):
        rglru.rec_block(p, rg.replace(tp_axis=group), x)
    jrg = jax_get_config("recurrentgemma-9b", smoke=True).replace(dtype=jnp.float32,
                                                                  tp_axis="tp")
    stacked = _jax_stack(_shards(p, _layer_pspecs(rglru.rec_block_specs(rg), 2, rg), 2))
    with pytest.raises(TypeError, match="dot_general"):
        jax.vmap(lambda q: jax_rglru.rec_block(q, jrg, jnp.asarray(x.numpy()))[0],
                 axis_name="tp")(stacked)
    tc = TeraPipeConfig(n_token_slices=2)
    with pytest.raises(NotImplementedError, match="dot_general"):
        make_terapipe_value_and_grad(build_model(rg, "cpu"), tc, 16, 2, Mesh(pipe=2, tp=2))
    mb = configs.get_config("mamba2-2.7b", smoke=True).replace(dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="mamba2"):
        ssm.mamba2_block(ssm.init_mamba2(torch.Generator().manual_seed(0), mb),
                         mb.replace(tp_axis=group), torch.zeros(1, 8, mb.d_model))
    with pytest.raises(NotImplementedError, match="mamba2"):
        make_terapipe_value_and_grad(build_model(mb, "cpu"), tc, 16, 2, Mesh(pipe=2, tp=2))
    cfg = configs.get_config("gpt3-1b", smoke=True)
    with pytest.raises(ValueError, match="tensor parallelism"):
        make_terapipe_value_and_grad(build_model(cfg, "cpu"), TeraPipeConfig(
            n_token_slices=2, schedule="1f1b"), 16, 2, Mesh(pipe=2, tp=2))
    jcfg = jax_get_config("gpt3-1b", smoke=True)
    jmodel = jax_build_model(jcfg)
    with pytest.raises(AssertionError, match="TP inside a stage"):
        jax_pipeline.make_terapipe_value_and_grad(
            jmodel, build_model(cfg, "meta").specs(), AbstractMesh((2, 2), ("pipe", "tp")),
            jax_pipeline.TeraPipeConfig(n_token_slices=2, schedule="1f1b", tp_axis="tp",
                                        data_axes=()), 16, 2)


def _rank_stacks(params, specs, cfg, tp, r):
    """Tp rank ``r``'s block of every stacked leaf of a group (the stage
    placements without the layer axis)."""
    def leaf(spec, a):
        ps = pipeline._leaf_pspec(spec, "tp", tp, "pipe", cfg)
        return sharding.local_shard(a, (None,) + tuple(ps[1:]), Mesh(tp=tp), {"tp": r})
    return sharding.map_specs(leaf, specs, params)


def test_whisper_decoder_under_tp_matches_unsharded_and_jax():
    """whisper-medium SMOKE (f32) as the TP-local model on a LocalGroup
    hosting tp 2 (every group's stacks the two ranks' blocks): its decoder
    runs self-attention, cross-attention (each rank's KV heads of the
    encoder output) and the FFN on the ranks' shards and sums them over the
    group.  Forward and loss within 2e-4 of the unsharded model's and of
    JAX's ``model.forward`` / ``model.loss`` on the same parameters, and
    the loss's gradients (through the shards' views) of the unsharded
    model's."""
    arch, tp = "whisper-medium", 2
    jcfg, cfg = _f32(arch)
    assert cfg.n_kv_heads % tp == 0
    jparams = _jax_params(arch)
    params = tree_map(lambda a: a.requires_grad_(True), params_from_jax(jparams, "cpu"))
    model = build_model(cfg, "cpu")
    local = build_model(_local_cfgs(jcfg, cfg, tp, LocalGroup(tp))[1], "cpu")
    specs = model.specs()["groups"]
    tp_params = {**params, "groups": {
        g: [_rank_stacks(sub, specs[g], cfg, tp, r) for r in range(tp)]
        for g, sub in params["groups"].items()}}
    rng = np.random.RandomState(5)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32),
             "labels": rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32),
             "frames": rng.randn(2, 24, cfg.d_model).astype(np.float32)}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jmodel = jax_build_model(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits = jax.jit(jmodel.forward)(jparams, jbatch)
    jloss = jax.jit(jmodel.loss)(jparams, jbatch)
    logits = local.forward(tp_params, tbatch)
    _close(logits, model.forward(params, tbatch).detach(), "tp 2 logits vs unsharded")
    _close(logits, jlogits, "tp 2 logits vs JAX")
    loss = local.loss(tp_params, tbatch)
    want = model.loss(params, tbatch)
    _close(loss, want.detach(), "tp 2 loss vs unsharded")
    _close(loss, jloss, "tp 2 loss vs JAX")
    leaves = list(tree_leaves(params))
    for got, ref, (path, _) in zip(torch.autograd.grad(loss, leaves),
                                   torch.autograd.grad(want, leaves), tree_items(params)):
        _close(got, ref, f"tp 2 grad {path} vs unsharded")


# ---------------------------------------------------------- (d) the pipelined step
@functools.lru_cache(maxsize=None)
def _jax_params(arch, **changes):
    """Parameters of ``arch`` SMOKE at f32 as numpy (the port's seeded
    init: both packages take the same values, and JAX's eager init would
    cost seconds per arch)."""
    cfg = _f32(arch)[1].replace(**changes)
    return tree_map(lambda a: a.numpy(), build_model(cfg, "cpu").init(0))


def _jax_reference(jcfg, B, S, seed, arch, changes=()):
    jmodel = jax_build_model(jcfg)
    jparams = _jax_params(arch, **dict(changes))
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)}
    loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return jparams, batch, float(loss), params_from_jax(jax.device_get(grads), "cpu")


def _pipeline_case(arch, mesh, tcfg, *, loss_tol, grad_tol=None, grad_rel=None,
                   B=4, S=32, seed=0, changes=()):
    jcfg, cfg = (c.replace(**dict(changes)) for c in _f32(arch))
    jparams, batch, jloss, jgrads = _jax_reference(jcfg, B, S, seed, arch, changes)
    model = build_model(cfg, "cpu")
    params = tree_map(lambda a: a.requires_grad_(True), params_from_jax(jparams, "cpu"))
    vg = make_terapipe_value_and_grad(model, tcfg, S, B, mesh)
    loss, grads = vg(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - jloss) < loss_tol, (float(loss), jloss)
    n = 0
    for path, g in tree_items(grads):
        w = _get(jgrads, path)
        if grad_rel is not None:
            rel = float((g - w).abs().max() / (1e-6 + w.abs().max()))
            assert rel < grad_rel, (path, rel)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=grad_tol, atol=grad_tol,
                                       err_msg=path)
        n += 1
    assert n == len(list(tree_leaves(jgrads)))
    return vg


def _f32(arch):
    return (jax_get_config(arch, smoke=True).replace(dtype=jnp.float32),
            configs.get_config(arch, smoke=True).replace(dtype=torch.float32))


PIPELINE_CASES = {
    # the reference's tests/test_system.py cases, in process, at its bounds
    "phi3 data2-pipe4 M4 D2": ("phi3-mini-3.8b", Mesh(data=2, pipe=4), dict(
        n_token_slices=4, n_microbatches=2), dict(loss_tol=2e-5, grad_rel=2e-3), 7),
    "phi3 data2-pipe2-tp2 M2": ("phi3-mini-3.8b", Mesh(data=2, pipe=2, tp=2), dict(
        n_token_slices=2), dict(loss_tol=5e-4, grad_tol=TOL), 11),
    "gpt3 pipe2-tp2 interleaved V2": ("gpt3-1b", Mesh(pipe=2, tp=2), dict(
        n_token_slices=4, schedule="interleaved", virtual_stages=2),
        dict(loss_tol=TOL, grad_tol=TOL), 0),
    "gpt3 data2-pipe2 1f1b": ("gpt3-1b", Mesh(data=2, pipe=2), dict(
        n_token_slices=4, schedule="1f1b"), dict(loss_tol=TOL, grad_tol=TOL), 0),
    "deepseek pipe2-tp2": ("deepseek-moe-16b", Mesh(pipe=2, tp=2), dict(
        n_token_slices=4), dict(loss_tol=TOL, grad_tol=TOL), 0),
}


@pytest.mark.parametrize("case", sorted(PIPELINE_CASES))
def test_pipelined_step_on_mesh_matches_jax(case):
    arch, mesh, tkw, bounds, seed = PIPELINE_CASES[case]
    vg = _pipeline_case(arch, mesh, TeraPipeConfig(cache_dtype=torch.float32, **tkw),
                        seed=seed, **bounds)
    assert (vg.plan.K, vg.plan.tp, vg.plan.data) == (
        mesh.get("pipe"), mesh.get("tp"), mesh.get("data"))


def test_int_ranks_mean_a_pipe_mesh():
    cfg = configs.get_config("gpt3-1b", smoke=True)
    vg = make_terapipe_value_and_grad(build_model(cfg, "cpu"), TeraPipeConfig(), 32, 4, 4)
    assert vg.plan.mesh == Mesh(pipe=4) and (vg.plan.tp, vg.plan.data) == (1, 1)


@pytest.mark.parametrize("arch", [a for a in configs.ARCHS if a != "whisper-medium"]
                         + ["gpt3-1b"])
def test_stage_placements_match_jax(arch):
    """``_leaf_pspec`` at tp 1, 2, 4, 8 and 16 and ``param_shardings_fn``
    on a pipe x tp mesh (the layer axis replicated where K does not divide
    the stack) against the reference's, leaf for leaf."""
    cfg = configs.get_config(arch)
    jcfg = jax_get_config(arch)
    model = build_model(cfg, "meta")
    main = pipeline._group_split(model)[1]
    specs = model.specs()
    for tp in (1, 2, 4, 8, 16):
        for path, spec in _tuple_items(specs["groups"][main.name]):
            got = pipeline._leaf_pspec(spec, "tp", tp, "pipe", cfg)
            want = jax_pipeline._leaf_pspec(spec, "tp", tp, "pipe", jcfg)
            assert got == tuple(want), (arch, tp, path, got, want)
    if cfg.family in ("ssm", "hybrid"):
        return
    for K, tp in ((4, 4), (5, 2)):
        if cfg.n_heads % tp:
            continue
        mesh = Mesh(data=1, pipe=K, tp=tp)
        jmodel = jax_build_model(jcfg)
        jplan = jax_pipeline._Plan(jmodel, specs, AbstractMesh((1, K, tp), ("data", "pipe", "tp")),
                                   jax_pipeline.TeraPipeConfig(n_token_slices=1, tp_axis="tp"),
                                   cfg.moe_block if cfg.family == "moe" else 8, 1)
        want = jplan.param_shardings_fn()(specs)
        plan = pipeline._Plan(model, TeraPipeConfig(n_token_slices=1),
                              cfg.moe_block if cfg.family == "moe" else 8, 1, mesh)
        got = plan.param_shardings_fn()(specs)
        gi, wi = list(_sharding_items(got)), jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: hasattr(x, "spec"))[0]
        assert len(gi) == len(wi)
        wmap = {"".join(f"/{getattr(k, 'key', k)}" for k in p): tuple(ns.spec) for p, ns in wi}
        for path, ns in gi:
            assert ns.spec == wmap[path], (arch, K, tp, path, ns.spec, wmap[path])


def _tuple_items(tree, prefix=""):
    if isinstance(tree, tuple):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from _tuple_items(v, f"{prefix}/{k}")
