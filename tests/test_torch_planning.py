"""The port's planning layer against the JAX package's, by exact equality.

The schedule IR (tick tables, comm plans, the residual and live-item
geometry, ``validate``) of every registered training schedule on the grids
of ``tests/test_schedules.py``; Algorithm 1 and its post-passes, the joint
batch × token DP and the brute-force oracle on the same cost callables;
the simulator's totals; the cost models on an (l, ctx) grid; the stacking
helpers.  The port copies these modules, so everything here must agree bit
for bit: floats are compared with ``==``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import cost_model as jcm
from repro.core import dp as jdp
from repro.core import schedules as jsch
from repro.core import simulator as jsim
from repro.core.schedule import SlicingScheme as JSlicingScheme
from repro_torch.configs import get_config
from repro_torch.core import cost_model as tcm
from repro_torch.core import dp as tdp
from repro_torch.core import schedules as tsch
from repro_torch.core import simulator as tsim
from repro_torch.core.schedule import SlicingScheme
from repro_torch.timing import PEAK_BF16_FLOPS, PEAK_BYTES

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

TRAINING_SCHEDULES = ("contiguous", "interleaved", "1f1b", "interleaved-1f1b", "zb-h1")
# the grids of tests/test_schedules.py: V = 1 schedules on GRID, the
# interleaved ones on IL_GRID
GRID = [(K, 1, D, M) for K in (1, 2, 3, 4, 8) for D in (1, 2, 4) for M in (1, 2, 4)]
IL_GRID = [(K, V, D, M) for K in (1, 2, 3, 4, 8) for V in (2, 3)
           for D in (1, 2, 4) for M in (1, 2, 4) if (D * M) % K == 0]
CASES = [(name, *g) for name in TRAINING_SCHEDULES
         for g in (IL_GRID if jsch.REGISTRY[name].min_virtual > 1 else GRID)]


def test_registry_matches_jax():
    assert tsch.schedule_names() == jsch.schedule_names()
    assert tsch.schedule_help() == jsch.schedule_help()
    for name, spec in jsch.REGISTRY.items():
        mine = tsch.REGISTRY[name]
        for field in ("min_virtual", "max_virtual", "has_backward", "splits_backward", "help"):
            assert getattr(mine, field) == getattr(spec, field), (name, field)
    for bad in (("interleaved-1f1b", 1), ("1f1b", 2), ("chimera", 1)):
        with pytest.raises(ValueError) as want:
            jsch.check_virtual_stages(*bad)
        with pytest.raises(ValueError) as got:
            tsch.check_virtual_stages(*bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,K,V,D,M", CASES)
def test_schedule_ir_matches_jax(name, K, V, D, M):
    """tick_table, comm_plan, residual_spread, peak_live_items, n_ticks and
    validate of one registered schedule at one (K, V, D, M)."""
    N = D * M
    kw = dict(n_ranks=K, n_layers=24, virtual_stages=V, n_microbatches=D)
    want, got = jsch.get_schedule(name, **kw), tsch.get_schedule(name, **kw)
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_array_equal(got.tick_table(N), want.tick_table(N))
    assert got.comm_plan() == tsch.CommPlan(**vars(want.comm_plan()))
    assert got.n_ticks(N) == want.n_ticks(N)
    assert got.n_units(N) == want.n_units(N)
    assert got.peak_live_items(N) == want.peak_live_items(N)
    assert got.validate(N) and want.validate(N)
    np.testing.assert_array_equal(got.param_permutation(), want.param_permutation())
    if want.has_backward:
        assert got.residual_spread(N) == want.residual_spread(N)


@pytest.mark.parametrize("K,V,n_layers", [(4, 2, 24), (3, 2, 12), (4, 1, 8), (2, 3, 10)])
def test_interleave_stacked_round_trips(K, V, n_layers):
    """On torch tensors: equals the JAX helper on numpy and the
    param_permutation gather, and uninterleave inverts it."""
    jassign = jsch.StageAssignment(K, V, n_layers)
    assign = tsch.StageAssignment(K, V, n_layers)
    x = np.arange(assign.n_padded * 6, dtype=np.float32).reshape(assign.n_padded, 2, 3)
    t = torch.from_numpy(x)
    mixed = tsch.interleave_stacked(t, assign)
    np.testing.assert_array_equal(mixed.numpy(), jsch.interleave_stacked(x, jassign))
    np.testing.assert_array_equal(mixed.numpy(), x[assign.param_permutation()])
    assert torch.equal(tsch.uninterleave_stacked(mixed, assign), t)


def test_slicing_scheme_matches_jax():
    for args, kw in (((64, 8), dict(n_token_slices=4, microbatch=2)),
                     ((64, 4), dict(n_token_slices=1)), ((96, 3), dict(n_token_slices=3))):
        a, b = SlicingScheme.uniform(*args, **kw), JSlicingScheme.uniform(*args, **kw)
        assert (a.splits, a.n_ticks, a.describe()) == (b.splits, b.n_ticks, b.describe())
    scheme = [(1, [704, 688, 656])] * 2 + [(2, [1024, 1024])]
    a = SlicingScheme.from_dp(2048, 4, scheme)
    b = JSlicingScheme.from_dp(2048, 4, scheme)
    assert (a.splits, a.describe()) == (b.splits, b.describe())


# ------------------------------------------------------------------- the DP
def _t_fwd(l, ctx):
    """An array-friendly Eq. 4-shaped cost: a floor, a linear term and a
    context term."""
    return 0.3 + 0.01 * np.maximum(l, 8) + 1e-4 * l * (ctx + l / 2)


def _t_scalar(l, ctx):
    """The same cost through a scalar-only path (the DP's fallback loop)."""
    return float(_t_fwd(int(l), int(ctx)))


def _same_dp(a, b):
    assert (a.latency, a.slices, a.t_max, a.n_tmax_evaluated) == \
        (b.latency, b.slices, b.t_max, b.n_tmax_evaluated)


@pytest.mark.parametrize("L,K,g,V", [(32, 4, 1, 1), (128, 3, 8, 1), (96, 8, 4, 2),
                                     (256, 4, 16, 1)])
def test_optimal_slicing_and_post_passes_match_jax(L, K, g, V):
    for t_fwd in (_t_fwd, _t_scalar):
        want = jdp.optimal_slicing(t_fwd, L, K, granularity=g, virtual_stages=V)
        got = tdp.optimal_slicing(t_fwd, L, K, granularity=g, virtual_stages=V)
        _same_dp(got, want)
    for slo in (None, 1.0, 2.5):
        _same_dp(tdp.plan_prefill(_t_fwd, L, K, granularity=g, slo_tmax=slo),
                 jdp.plan_prefill(_t_fwd, L, K, granularity=g, slo_tmax=slo))
    for name in TRAINING_SCHEDULES:
        for D in (1, 2, 3):
            kw = dict(schedule=name, n_ranks=K, n_microbatches=D, granularity=g)
            sl = jdp.ensure_executable(want.slices, **kw)
            assert tdp.ensure_executable(want.slices, **kw) == sl
            Vs = max(V, jsch.REGISTRY[name].min_virtual) \
                if jsch.REGISTRY[name].max_virtual is None else 1
            kw = dict(schedule=name, n_ranks=K, virtual_stages=Vs, n_microbatches=D)
            assert tdp.plan_schedule_info(sl, **kw) == jdp.plan_schedule_info(sl, **kw)
    for mult in (1, 3, 4):
        assert tdp.pad_slice_count(want.slices, mult, granularity=g) == \
            jdp.pad_slice_count(want.slices, mult, granularity=g)


def test_pad_slice_count_refusal_matches_jax():
    with pytest.raises(ValueError) as want:
        jdp.pad_slice_count([2, 2], 3, granularity=2)
    with pytest.raises(ValueError) as got:
        tdp.pad_slice_count([2, 2], 3, granularity=2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("L,K,g", [(8, 3, 1), (12, 4, 1), (24, 2, 2)])
def test_brute_force_slicing_matches_jax_and_the_dp(L, K, g):
    want = jdp.brute_force_slicing(_t_scalar, L, K, granularity=g)
    got = tdp.brute_force_slicing(_t_scalar, L, K, granularity=g)
    assert (got.latency, got.slices, got.t_max) == (want.latency, want.slices, want.t_max)
    assert tdp.optimal_slicing(_t_fwd, L, K, granularity=g, eps=0).latency == \
        pytest.approx(got.latency, rel=1e-12)


@pytest.mark.parametrize("objective", ["pipeline", "paper"])
@pytest.mark.parametrize("V", [1, 2])
def test_joint_batch_token_matches_jax(objective, V):
    t_b = lambda b: (lambda l, ctx: b * _t_fwd(l, ctx) + 0.2)
    kw = dict(granularity=8, objective=objective, virtual_stages=V)
    want = jdp.joint_batch_token(t_b, 64, 6, 4, **kw)
    got = tdp.joint_batch_token(t_b, 64, 6, 4, **kw)
    assert (got.latency, got.scheme) == (want.latency, want.scheme)
    kw["batch_candidates"] = (1, 2, 4)
    assert tdp.joint_batch_token(t_b, 64, 6, 4, **kw).scheme == \
        jdp.joint_batch_token(t_b, 64, 6, 4, **kw).scheme


# -------------------------------------------------------------- simulator
SCHEME = [(1, [5, 11, 9, 7])] * 3
DISCIPLINES = [("async", 1), ("lockstep", 1), ("interleaved", 2), ("interleaved", 3),
               ("1f1b", 1), ("interleaved-1f1b", 2), ("zb-h1", 1), ("streaming", 1)]


def _t_of(b, l, ctx):
    return b * float(_t_fwd(l, ctx))


@pytest.mark.parametrize("discipline,V", DISCIPLINES)
def test_simulate_and_bubble_fraction_match_jax(discipline, V):
    K = 4
    sch, jsch_ = SlicingScheme.from_dp(32, 3, SCHEME), JSlicingScheme.from_dp(32, 3, SCHEME)
    spec = jsch.REGISTRY.get(discipline)
    if spec is not None and spec.has_backward:      # inherently fwd+bwd
        variants = [dict(include_backward=True),
                    dict(include_backward=True, t_bwd_of=lambda b, l, c: 2.5 * _t_of(b, l, c)),
                    dict(include_backward=True, t_bwd_of=lambda b, l, c: 2.5 * _t_of(b, l, c),
                         t_bwd_input_of=lambda b, l, c: 1.2 * _t_of(b, l, c))]
    else:
        variants = [dict(include_backward=False), dict(include_backward=True)]
    for extra in variants:
        for slow in (None, [1.0, 1.5, 0.5, 2.0]):
            kw = dict(discipline=discipline, virtual_stages=V, stage_slowdown=slow, **extra)
            assert tsim.simulate(sch, K, _t_of, **kw) == jsim.simulate(jsch_, K, _t_of, **kw)
            assert tsim.bubble_fraction(sch, K, _t_of, **kw) == \
                jsim.bubble_fraction(jsch_, K, _t_of, **kw)


def test_simulate_stream_and_eq5_match_jax():
    def units(mod):
        return (mod.prefill_unit(0, 0, 12, final=False), mod.prefill_unit(0, 12, 20),
                mod.prefill_unit(1, 0, 7), mod.decode_round((0, 1), (32, 7)),
                mod.decode_round((0, 1), (33, 8)), mod.prefill_unit(2, 0, 30),
                mod.decode_round((0, 1, 2), (34, 9, 30)))
    t_unit = lambda u: 1.0 + 0.001 * u.tokens * (1 + max(u.ctx))
    for K in (1, 3):
        for slow in (None, [1.0, 2.0, 0.5][:K]):
            want = jsim.simulate_stream(jsch.streaming(K, 8, units(jsch)), t_unit,
                                        stage_slowdown=slow)
            got = tsim.simulate_stream(tsch.streaming(K, 8, units(tsch)), t_unit,
                                       stage_slowdown=slow)
            assert (got.ttft, got.finish, got.round_times, got.total, got.tokens,
                    got.tokens_per_s) == (want.ttft, want.finish, want.round_times,
                                          want.total, want.tokens, want.tokens_per_s)
    for slices in ([64], [5, 11, 9, 7], [16] * 8):
        assert tsim.eq5_latency(slices, 4, _t_fwd) == jsim.eq5_latency(slices, 4, _t_fwd)


# ------------------------------------------------------------- cost models
L_GRID = np.array([1, 8, 100, 256, 512, 2048])[:, None]
CTX_GRID = np.array([0, 7, 256, 1536])[None, :]


@pytest.mark.parametrize("arch,smoke", [("gpt3-1b", False), ("gpt3-1b", True),
                                        ("qwen3-0.6b", False)])
def test_analytic_cost_model_matches_jax(arch, smoke):
    jcfg, cfg = jax_get_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert tcm.layer_matmul_flops(cfg) == jcm.layer_matmul_flops(jcfg)
    np.testing.assert_array_equal(tcm.attention_context_flops(cfg, L_GRID, CTX_GRID),
                                  jcm.attention_context_flops(jcfg, L_GRID, CTX_GRID))
    for hw in ("TPU_V5E", "V100_AWS"):
        assert getattr(tcm, hw) == tcm.HardwareSpec(**vars(getattr(jcm, hw)))
        for kw in (dict(layers_per_stage=6), dict(layers_per_stage=3, batch=4, tp_degree=2,
                                                  stage_slowdown=1.5)):
            for incl in (True, False):
                want = jcm.AnalyticCostModel(jcfg, getattr(jcm, hw), include_backward=incl, **kw)
                got = tcm.AnalyticCostModel(cfg, getattr(tcm, hw), include_backward=incl, **kw)
                np.testing.assert_array_equal(got.t_fwd(L_GRID, CTX_GRID),
                                              want.t_fwd(L_GRID, CTX_GRID))
                assert got(100, 7) == want(100, 7)
                kinds = [tsch.KIND_FWD] + ([] if incl else [tsch.KIND_BWD, tsch.KIND_BWD_INPUT,
                                                            tsch.KIND_BWD_WEIGHT])
                for kind in kinds:
                    for l, c in ((1, 0), (100, 7), (512, 1536)):
                        assert got.unit_cost(l, c, kind=kind) == want.unit_cost(l, c, kind=kind)
                if not incl:
                    np.testing.assert_array_equal(got.t_bwd(L_GRID, CTX_GRID),
                                                  want.t_bwd(L_GRID, CTX_GRID))
                else:
                    with pytest.raises(AssertionError):
                        got.t_bwd(8, 0)
                with pytest.raises(ValueError):
                    got.unit_cost(8, 0, kind=tsch.KIND_IDLE)


def test_table_and_bilinear_models_match_jax():
    table = {(l, c): float(_t_fwd(l, c)) for l in range(8, 65, 8) for c in range(0, 65, 8)}
    bwd = {k: 2.5 * v for k, v in table.items()}
    for b in (None, bwd):
        want, got = jcm.TableCostModel(table, 8, b), tcm.TableCostModel(table, 8, b)
        for l, c in ((8, 0), (13, 21), (64, 64)):
            assert (got.t_fwd(l, c), got.t_bwd(l, c), got.t_bwd_input(l, c),
                    got.t_bwd_weight(l, c)) == (want.t_fwd(l, c), want.t_bwd(l, c),
                                                want.t_bwd_input(l, c), want.t_bwd_weight(l, c))
    truth = lambda l, c: float(_t_fwd(l, c))
    want = jcm.BilinearFitCostModel.fit(truth, 64, n_samples=64)
    got = tcm.BilinearFitCostModel.fit(truth, 64, n_samples=64)
    np.testing.assert_array_equal(got.a, want.a)
    assert got.t_fwd(17, 30) == want.t_fwd(17, 30)
    assert got.relative_error(truth, 64, n=64) == want.relative_error(truth, 64, n=64)


def test_h100_spec_is_the_card_not_a_reference_target():
    """The card's datasheet rates, no link term (the ranks are virtual, in
    one process), and fitted fields of its own."""
    hw = tcm.H100
    assert (hw.peak_flops, hw.hbm_bw) == (PEAK_BF16_FLOPS, PEAK_BYTES)
    assert hw.link_latency == 0.0 and hw.link_bw == float("inf")
    assert 0 < hw.efficiency < 1 and hw.occupancy_floor >= 1
    assert (hw.efficiency, hw.occupancy_floor) != (tcm.TPU_V5E.efficiency,
                                                   tcm.TPU_V5E.occupancy_floor)
    cm = tcm.AnalyticCostModel(get_config("gpt3-1b"), hw, layers_per_stage=6)
    assert np.all(np.diff(cm.t_fwd(np.arange(1, 2049), 0)) >= 0)


@pytest.mark.parametrize("eff,floor", [(0.37, 300), (0.6, 64), (0.25, 1)])
def test_fit_efficiency_and_floor_recovers_the_model(eff, floor):
    """The stage-sweep fit that set the H100 spec: on times the analytic
    model itself produced (a spec with a link term, which the fit ignores),
    it gives back the efficiency and the floor."""
    cfg = get_config("gpt3-1b")
    hw = tcm.HardwareSpec("x", tcm.H100.peak_flops, tcm.H100.hbm_bw, float("inf"), 0.0,
                          floor, eff)
    cm = tcm.AnalyticCostModel(cfg, hw, layers_per_stage=6, include_backward=False)
    ls = [32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048]
    with_link = dataclasses.replace(tcm.TPU_V5E, peak_flops=hw.peak_flops)
    got_eff, got_floor = tcm.fit_efficiency_and_floor(cfg, with_link, 6, ls,
                                                      [cm.t_fwd(l, 0) for l in ls])
    assert got_eff == pytest.approx(eff, rel=1e-9) and got_floor == floor


def test_measure_kernel_cost_table_on_cpu_shape_only():
    pairs = [(8, 0), (8, 8), (16, 0)]
    table = tcm.measure_kernel_cost_table(pairs, n_heads=4, n_kv_heads=2, head_dim=16,
                                          granularity=8, n_iters=2, device="cpu")
    assert sorted(table.table) == sorted(table.bwd_table) == sorted(pairs)
    for key in pairs:
        assert table.t_fwd(*key) > 0 and table.t_bwd(*key) >= table.t_fwd(*key)
