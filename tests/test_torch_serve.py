"""The port's serving engine against the JAX engine.

The ``tests/test_serve.py`` model (f32, 2 layers) with converted weights:
the port's ``DecodeEngine`` must emit the JAX engine's tokens and the same
``units`` trace, with SLO-split prefill chunks at ctx > 0; within the port,
continuous batching must equal the sequential engine bit for bit.  The
planner and the page helpers are held against their JAX counterparts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dp as jax_dp
from repro.core import schedules as jax_schedules
from repro.core import simulator as jax_simulator
from repro.models import build_model as jax_build_model
from repro.models.common import ModelConfig as JaxModelConfig
from repro.serve import DecodeEngine as JaxEngine
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import kv_cache as jax_kv
from repro_torch.core import dp
from repro_torch.core.schedules import ScheduleValidationError, decode_round, prefill_unit, streaming
from repro_torch.launch import serve as serve_launch
from repro_torch.models import ModelConfig, build_model
from repro_torch.serve import DecodeEngine, EngineConfig, kv_cache
from repro_torch.weights import params_from_jax

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

ARCH = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=64, remat=False)
GEOM = dict(max_batch=4, max_len=32, page_size=8, n_pages=20)
SLO = 150.0


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(JaxModelConfig(**ARCH, dtype=jnp.float32))
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(ModelConfig(**ARCH, dtype=torch.float32), device="cpu")
    return jmodel, jparams, tmodel, params_from_jax(jax.device_get(jparams), "cpu")


def _prompts(seed, n, lo=3, hi=14):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, size=rng.randint(lo, hi)).tolist() for _ in range(n)]


def _run(engine, prompts, gen):
    rids = [engine.submit(p, gen) for p in prompts]
    engine.run()
    return [engine.finished[r].generated for r in rids]


def test_engine_matches_jax_engine(models):
    jmodel, jparams, tmodel, tparams = models
    prompts = _prompts(1, 5, lo=8, hi=14)
    jeng = JaxEngine(jmodel, jparams, JaxEngineConfig(**GEOM, slo_tmax=SLO))
    teng = DecodeEngine(tmodel, tparams, EngineConfig(**GEOM, slo_tmax=SLO), device="cpu")
    assert _run(teng, prompts, 5) == _run(jeng, prompts, 5)
    assert [dataclasses.astuple(u) for u in teng.units] == \
        [dataclasses.astuple(u) for u in jeng.units]
    assert any(u.kind == "prefill" and u.ctx[0] > 0 for u in teng.units)
    assert teng.rounds == jeng.rounds
    assert teng.schedule().validate(len(teng.units))


def test_continuous_equals_sequential_bit_identical(models):
    _, _, tmodel, tparams = models
    prompts = _prompts(2, 6)
    seq = _run(DecodeEngine(tmodel, tparams, EngineConfig(**GEOM, max_concurrency=1),
                            device="cpu"), prompts, 5)
    eng = DecodeEngine(tmodel, tparams, EngineConfig(**GEOM, slo_tmax=SLO), device="cpu")
    rids = [eng.submit(p, 5) for p in prompts[:4]]
    for _ in range(3):                      # staggered admission
        eng.step()
    rids += [eng.submit(p, 5) for p in prompts[4:]]
    eng.run()
    assert [eng.finished[r].generated for r in rids] == seq
    assert eng.rounds < sum(len(s) for s in seq)
    assert eng.schedule().validate(len(eng.units))


@pytest.mark.parametrize("L,slo,K", [(24, 150.0, 1), (40, 400.0, 2), (17, 1.0, 1),
                                     (30, None, 3)])
def test_plan_prefill_matches_jax(L, slo, K):
    cost = lambda l, c: 32.0 + l * (c + l)
    want = jax_dp.plan_prefill(cost, L, K, slo_tmax=slo)
    got = dp.plan_prefill(cost, L, K, slo_tmax=slo)
    assert got.slices == want.slices and got.latency == want.latency


def test_page_helpers_match_jax():
    rng = np.random.RandomState(0)
    count, n_pages, ps, kv, hd, b, p = 2, 9, 4, 2, 3, 3, 4
    phys = [tuple(rng.randn(count, n_pages, ps, kv, hd).astype(np.float32) for _ in range(2))]
    table = np.array([[3, 5, 0, 0], [0, 0, 0, 0], [1, 2, 7, 8]], np.int32)
    jphys = jax.tree.map(jnp.asarray, phys)
    tphys = [tuple(torch.from_numpy(a.copy()) for a in phys[0])]

    jd = jax_kv.gather_pages(jphys, jnp.asarray(table))
    td = kv_cache.gather_pages(tphys, torch.from_numpy(table))
    for j, t in zip(jax.tree.leaves(jd), [x for g in td for x in g]):
        assert t.shape == (count, b, p * ps, kv, hd)
        assert np.array_equal(t.numpy(), np.asarray(j))

    dense = [tuple(rng.randn(count, b, p * ps, kv, hd).astype(np.float32) for _ in range(2))]
    pos, active = np.array([5, 0, 13], np.int32), np.array([True, False, True])
    jout = jax_kv.scatter_token(jphys, jax.tree.map(jnp.asarray, dense), jnp.asarray(table),
                                jnp.asarray(pos), jnp.asarray(active))
    tdense = [tuple(torch.from_numpy(a) for a in dense[0])]
    kv_cache.scatter_token(tphys, tdense, torch.from_numpy(table), torch.from_numpy(pos),
                           torch.from_numpy(active))
    for j, t in zip(jax.tree.leaves(jout), tphys[0]):
        assert np.array_equal(t.numpy(), np.asarray(j))
    # the inactive slot rewrote reserved page 0 with its old value
    assert np.array_equal(tphys[0][0][:, 0].numpy(), phys[0][0][:, 0])

    row = table[2]
    jout = jax_kv.scatter_prefill(jout, jax.tree.map(jnp.asarray, dense), jnp.asarray(row), 3, 9)
    kv_cache.scatter_prefill(tphys, tdense, torch.from_numpy(row), 3, 9)
    for j, t in zip(jax.tree.leaves(jout), tphys[0]):
        assert np.array_equal(t.numpy(), np.asarray(j))


def test_stream_audit_rejects_decode_before_prefill():
    ok = (prefill_unit(0, 0, 4, final=False), prefill_unit(0, 4, 3), decode_round([0], [7]))
    assert streaming(1, 2, ok).validate(3)
    bad = (prefill_unit(0, 0, 4, final=False), decode_round([0], [4]))
    with pytest.raises(ScheduleValidationError, match="decodes before"):
        streaming(1, 2, bad).validate(2)


def test_serve_launch_simulate_matches_jax_simulator(monkeypatch, capsys):
    """launch.serve --simulate prices the served trace with the port's
    simulate_stream; the printed totals equal the JAX simulator's on the
    same units."""
    engines = []

    class Recording(DecodeEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

    monkeypatch.setattr(serve_launch, "DecodeEngine", Recording)
    serve_launch.main(["--smoke", "--device", "cpu", "--simulate", "--requests", "3", "--gen",
                       "3", "--pipe", "2", "--slo-tmax", "120"])
    line = [x for x in capsys.readouterr().out.splitlines() if "simulated @K=2" in x]
    units = tuple(jax_schedules.StreamUnit(*dataclasses.astuple(u)) for u in engines[0].units)
    rep = jax_simulator.simulate_stream(
        jax_schedules.streaming(2, 1, units), lambda u: 1.0 + 0.001 * u.tokens * (1 + max(u.ctx)))
    ttfts = sorted(rep.ttft.values())
    assert line == [f"[serve] simulated @K=2: total={rep.total:.1f} "
                    f"ttft_p50={ttfts[len(ttfts) // 2]:.1f} tok/s={rep.tokens_per_s:.2f}"]
    assert any(u.kind == "prefill" and not u.final for u in units)
