"""The pipelined step with one pipe rank per process, run in one process
through ``distributed.transport.ThreadRing`` (K threads, one rank each).

* Every forward-only schedule (``contiguous`` with uniform and non-uniform
  slices, gpipe, ``interleaved`` V 2) on gpt3 SMOKE at K 2 and 4, and one
  case each of deepseek (MoE, with its pre-group), phi-3-vision (the patch
  prefix), mamba2 and recurrentgemma (the post-group): every rank, given
  its shard of the parameters (``shard_params``), returns the gradients of
  its blocks, each within 2e-6 of its leaf's largest magnitude of the
  in-process run's matching block (``LocalRing``, autograd over the whole
  tick loop), and its loss and blocks within 2e-4 of JAX's
  ``value_and_grad(model.loss)`` on the same parameters (f32).
* The ring itself: shifts hand each rank a copy of its predecessor's
  value, ``all_reduce`` sums in rank order (also with more threads than
  cores switching every microsecond, where the kernels' launch counter
  must lose no count), and a rank that skips a tick raises, on every
  rank, rather than hang.
* The launcher's mesh over ``n`` processes (the reference's rule), its
  refusal of ``--mode gspmd`` and its acceptance of the checkpoint options,
  as plain functions, with no process group.
"""
import argparse
import functools
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch import configs
from repro_torch.core.pipeline import TeraPipeConfig, make_terapipe_value_and_grad, shard_params
from repro_torch.distributed.transport import RingBroken, ThreadRing
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.tree import jax_items, tree_items, tree_leaves, tree_map
from repro_torch.weights import params_from_jax

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

TOL = 2e-4            # against JAX (tests/test_sliced_equivalence.py's bound)
LOCAL_REL = 2e-6      # against the in-process run, of each leaf's largest magnitude
B, S = 4, 16
GPT, MOE, VLM, MAMBA, RG = ("gpt3-1b", "deepseek-moe-16b", "phi-3-vision-4.2b", "mamba2-2.7b",
                            "recurrentgemma-9b")


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The port's model (f32), its seeded parameters as numpy, a batch, and
    JAX's loss and gradients of ``model.loss`` on them."""
    jcfg = jax_get_config(arch, smoke=True).replace(dtype=jnp.float32)
    cfg = configs.get_config(arch, smoke=True).replace(dtype=torch.float32)
    model = build_model(cfg, "cpu")
    jparams = tree_map(lambda a: a.numpy(), model.init(0))
    rng = np.random.RandomState(1)
    text = S - cfg.n_patches if cfg.family == "vlm" else S
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, text)).astype(np.int32),
             "labels": rng.randint(0, cfg.vocab_size, (B, text)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.randn(B, cfg.n_patches, cfg.d_model).astype(np.float32)
    loss, grads = jax.jit(jax.value_and_grad(jax_build_model(jcfg).loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return model, jparams, batch, float(loss), dict(jax_items(jax.device_get(grads)))


CASES = {
    # arch, K, TeraPipeConfig fields, extra mesh axes
    "gpt3-K2-contiguous-M4": (GPT, 2, dict(n_token_slices=4), {}),
    "gpt3-K4-contiguous-M4": (GPT, 4, dict(n_token_slices=4), {}),
    "gpt3-K2-contiguous-slices": (GPT, 2, dict(slice_lens=(3, 6, 2, 5)), {}),
    "gpt3-K4-contiguous-slices": (GPT, 4, dict(slice_lens=(5, 1, 7, 3)), {}),
    "gpt3-K2-gpipe-D2": (GPT, 2, dict(n_token_slices=1, n_microbatches=2), {}),
    "gpt3-K4-gpipe-D2": (GPT, 4, dict(n_token_slices=1, n_microbatches=2), {}),
    "gpt3-K2-interleaved-V2": (GPT, 2, dict(n_token_slices=4, schedule="interleaved",
                                            virtual_stages=2), {}),
    "gpt3-K4-interleaved-V2": (GPT, 4, dict(n_token_slices=4, schedule="interleaved",
                                            virtual_stages=2), {}),
    "gpt3-data2-K2-contiguous-D2": (GPT, 2, dict(n_token_slices=2, n_microbatches=2),
                                    {"data": 2}),
    "gpt3-K2-tp2-contiguous": (GPT, 2, dict(n_token_slices=4), {"tp": 2}),
    "deepseek-K2-contiguous": (MOE, 2, dict(n_token_slices=2), {}),
    "phi3v-K2-contiguous": (VLM, 2, dict(n_token_slices=4), {}),
    "mamba2-K2-contiguous-D2": (MAMBA, 2, dict(n_token_slices=2, n_microbatches=2), {}),
    "rg-K2-contiguous-post": (RG, 2, dict(n_token_slices=4), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank_per_thread_matches_in_process_and_jax(case):
    arch, K, tkw, axes = CASES[case]
    model, jparams, batch, jloss, jgrads = _reference(arch)
    params = tree_map(lambda a: a.requires_grad_(True), params_from_jax(jparams, "cpu"))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tcfg = TeraPipeConfig(cache_dtype=torch.float32, **tkw)
    mesh = Mesh(pipe=K, **axes)
    vg = make_terapipe_value_and_grad(model, tcfg, S, B, mesh)
    want_loss, want = vg(params, tbatch)
    want = dict(tree_items(want))
    if case == "rg-K2-contiguous-post":
        assert [g.name for g in vg.plan.post] == ["tail"]
    if arch == MOE:
        assert [g.name for g in vg.plan.pre] == ["dense0"]

    def rank_run(rank):
        vg = make_terapipe_value_and_grad(model, tcfg, S, B, mesh, {"pipe": rank})
        layout = vg.plan.shard_layout(params)
        return vg(shard_params(params, layout), tbatch), layout

    runs = ThreadRing(K, timeout=60).run(rank_run)
    assert len(runs) == K
    for k, ((loss, grads), layout) in enumerate(runs):
        assert abs(float(loss) - float(want_loss)) <= LOCAL_REL * abs(float(want_loss)), k
        assert abs(float(loss) - jloss) < TOL, (k, float(loss), jloss)
        got = dict(tree_items(grads))
        blocks = dict(zip(got, (ls.mine for ls in tree_leaves(layout))))
        assert got.keys() == want.keys() == jgrads.keys()
        for path, g in got.items():
            w = want[path]
            wb = blocks[path].cut(w)
            assert g.dtype == w.dtype and g.shape == wb.shape, path
            assert float((g - wb).abs().max()) <= LOCAL_REL * float(w.abs().max()), (k, path)
            jb = blocks[path].cut(torch.from_numpy(np.array(jgrads[path])))
            np.testing.assert_allclose(g.numpy(), jb.numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"rank {k} {path}")


def test_thread_ring_shift_and_all_reduce():
    """Each rank gets a copy of its ring predecessor's value (forward and
    reverse), None passes as None, and ``all_reduce`` is the rank-order
    sum on every rank."""
    K = 3
    vals = [torch.randn(5, generator=torch.Generator().manual_seed(k)) for k in range(K)]

    def work(rank):
        k = rank.rank
        fwd = rank.shift([vals[k]], step=1)[0]
        rev = rank.shift([vals[k]], step=-1)[0]
        idle = rank.shift([None if k == 1 else vals[k]])[0]
        total = rank.all_reduce([vals[k]])[0]
        return fwd, rev, idle, total

    out = ThreadRing(K, timeout=10).run(work)
    want_sum = (vals[0] + vals[1]) + vals[2]
    for k, (fwd, rev, idle, total) in enumerate(out):
        assert torch.equal(fwd, vals[(k - 1) % K]) and fwd is not vals[(k - 1) % K]
        assert torch.equal(rev, vals[(k + 1) % K])
        assert (idle is None) == ((k - 1) % K == 1)
        assert torch.equal(total, want_sum)


def test_thread_ring_and_launch_counts_under_a_short_switch_interval():
    """More threads than cores, switching every microsecond: every shift
    delivers its predecessor's value of that round, every all_reduce the
    round's exact sum, every gather the round's values in rank order on
    its rank alone, and the kernels' launch counter loses no count."""
    from repro_torch.kernels import _build

    K, rounds = 12, 40

    def counted():
        pass
    counted.launches = 0

    def work(rank):
        k = rank.rank
        for r in range(rounds):
            got = rank.shift([torch.tensor([float(100 * r + k)])])[0]
            assert float(got) == 100 * r + (k - 1) % K, (k, r, float(got))
            total = rank.all_reduce([torch.tensor([float(r + k)])])[0]
            assert float(total) == K * r + K * (K - 1) / 2, (k, r, float(total))
            got = rank.gather(torch.tensor([float(100 * r + k)]), dst=r % K)
            if k == r % K:
                assert [float(g) for g in got] == [100 * r + j for j in range(K)], (k, r)
            else:
                assert got is None, (k, r)
            for _ in range(50):
                _build.count(counted)
        return True

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.time()
        assert ThreadRing(K, timeout=30).run(work) == [True] * K
    finally:
        sys.setswitchinterval(before)
    assert counted.launches == K * rounds * 50
    assert time.time() - t0 < 60


class _SkipsATick:
    """A ring rank that leaves out its ``at``-th shift: it neither sends
    nor receives there (a rank whose tick loop skipped a tick)."""

    def __init__(self, rank, at: int):
        self.inner, self.at, self.calls = rank, at, 0
        self.size, self.ranks, self.rank = rank.size, rank.ranks, rank.rank

    def shift(self, sent, step=1):
        self.calls += 1
        if self.calls == self.at:
            return [None]
        return self.inner.shift(sent, step)

    def all_reduce(self, values):
        return self.inner.all_reduce(values)


@pytest.mark.parametrize("at", [2, 5])
def test_a_rank_that_skips_a_tick_raises(at):
    """Rank 1 of the pipelined step leaves out one shift: the run raises
    (the rank's own error, or a timeout; never only the ring's broken
    message), on every thread, within seconds."""
    model, jparams, batch, _, _ = _reference(GPT)
    params = params_from_jax(jparams, "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tcfg = TeraPipeConfig(n_token_slices=4, cache_dtype=torch.float32)

    def rank_run(rank):
        if rank.rank == 1:
            rank = _SkipsATick(rank, at)
        vg = make_terapipe_value_and_grad(model, tcfg, S, B, 2, {"pipe": rank})
        return vg(shard_params(params, vg.plan.shard_layout(params)), tbatch)

    t0 = time.time()
    with pytest.raises((AssertionError, TimeoutError, RuntimeError)) as err:
        ThreadRing(2, timeout=2.0).run(rank_run)
    assert not isinstance(err.value, RingBroken), err.value
    assert time.time() - t0 < 30


def test_a_missing_shift_times_out():
    """Rank 1 shifts twice where rank 0 shifts three times: rank 0's third
    shift raises TimeoutError after the ring's timeout."""
    def work(rank):
        for _ in range(3 if rank.rank == 0 else 2):
            rank.shift([torch.zeros(1)])

    t0 = time.time()
    with pytest.raises(TimeoutError, match="skipped a tick"):
        ThreadRing(2, timeout=0.5).run(work)
    assert time.time() - t0 < 10


# ------------------------------------------------------------- the launcher
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 12])
def test_launch_mesh_is_the_references(n):
    """``n`` processes -> ``Mesh(data=n // pipe, pipe=min(4, n))``, the
    reference's (``repro/launch/train.py:200-205``)."""
    pipe = min(4, n)
    assert train_launch.launch_mesh(n) == Mesh(data=n // pipe, pipe=pipe)


@pytest.mark.parametrize("n", [6, 10])
def test_launch_mesh_refuses_what_it_cannot_fill(n):
    with pytest.raises(ValueError, match="repro/launch/train.py"):
        train_launch.launch_mesh(n)


def _args(**kw):
    base = dict(mode="terapipe", checkpoint_dir=None, simulate_failure_at=-1)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("kw,reason", [
    (dict(mode="gspmd"), "builds no mesh"),
    # the checkpoint options run across processes (tests/test_torch_sharded_state.py)
    pytest.param(dict(checkpoint_dir="ck"), None, id="kw1-checkpoints across processes"),
    pytest.param(dict(simulate_failure_at=2), None, id="kw2-checkpoints across processes"),
])
def test_launcher_refusals_across_processes(kw, reason):
    """``--mode gspmd`` is refused with more than one process; the
    checkpoint options are accepted there (``reason`` None)."""
    train_launch.check_processes(_args(**kw), 1)          # one process: as before
    if reason is None:
        train_launch.check_processes(_args(**kw), 2)
    else:
        with pytest.raises(ValueError, match=reason):
            train_launch.check_processes(_args(**kw), 2)
    train_launch.check_processes(_args(mode="gpipe"), 4)


def test_launcher_refuses_before_any_process_group(monkeypatch, capsys):
    """Under a torchrun environment of 2 processes, ``--mode gspmd`` exits
    with the usage error before a process group starts."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as e:
        train_launch.main(["--arch", "gpt3-1b", "--smoke", "--device", "cpu", "--steps", "1"])
    assert e.value.code == 2
    assert "builds no mesh" in capsys.readouterr().err
    assert not torch.distributed.is_initialized()
