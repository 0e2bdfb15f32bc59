"""The port's last two families against the JAX package: phi-3-vision
(the vlm patch prefix: ``Model.embed`` at ctx 0, ``head_loss`` over the
text rows, the pipelined step) and whisper-medium (``EncDecModel``: the
bidirectional encoder, cross-attention, the decoder's ``(x, enc_kv)``
blocks, prefill and decode), and the ``"dots"`` remat policy.

SMOKE configs at f32: the parameters go through ``params_from_jax`` and
both packages run the same numpy-seeded inputs, held at the
``tests/test_sliced_equivalence.py`` tolerance (2e-4); the pipelined loss
within 2e-5 of JAX's ``model.loss``, as ``tests/test_torch_pipeline.py``
holds it.  The dots policy must give the full policy's loss and gradients
bit for bit, and its backward pass must run no plain matrix product of a
checkpointed block again.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.compat import make_mesh, use_mesh
from repro.configs import get_config as jax_get_config
from repro.core import pipeline as jax_pipeline
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, PAPER_ARCHS, get_config
from repro_torch.core import pipeline
from repro_torch.core.pipeline import TeraPipeConfig, make_terapipe_value_and_grad, value_and_grad
from repro_torch.launch import train as train_launch
from repro_torch.models import attention, build_model, lm
from repro_torch.optim import adamw
from repro_torch.tree import jax_items, tree_items, tree_leaves, tree_map
from repro_torch.weights import params_from_jax

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

TOL = 2e-4
PIPE_LOSS_TOL = 2e-5
VLM, WHISPER = "phi-3-vision-4.2b", "whisper-medium"
B, S = 4, 32                 # S: every position of the sequence (vlm: patches + text)
N_PATCHES = 4                # phi-3-vision SMOKE
SLICE_SETS = ((16, 8, 8), (8, 8, 8, 8), (24, 8))   # tests/test_sliced_equivalence.py's


def _configs(arch, **kw):
    jcfg = jax_get_config(arch, smoke=True).replace(dtype=jnp.float32, **kw)
    tcfg = get_config(arch, smoke=True).replace(dtype=torch.float32, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    """Per arch: the JAX model, one set of parameters as numpy arrays and
    the port's model.  The parameters are the port's init, checked leaf
    for leaf against the structure, shapes and dtypes of the JAX init's."""
    out = {}
    for arch in (VLM, WHISPER):
        jcfg, tcfg = _configs(arch)
        jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg, device="cpu")
        params = jax.tree.map(np.asarray, tree_map(lambda a: a.numpy(), tmodel.init(0)))
        shapes = jax.eval_shape(lambda k: jmodel.init(k)[0], jax.random.PRNGKey(0))
        assert jax.tree.structure(params) == jax.tree.structure(shapes)
        for a, want in zip(jax.tree.leaves(params), jax.tree.leaves(shapes)):
            assert a.shape == want.shape and a.dtype == want.dtype
        out[arch] = (jmodel, params, tmodel)
    return out


def _batch(arch, seed=0, b=B, s=S, frames=None):
    """A training batch of ``s`` positions: vlm ``s - n_patches`` text
    tokens behind ``n_patches`` patch rows; enc-dec ``s`` tokens and
    ``frames`` (default ``s``) frame rows."""
    rng = np.random.RandomState(seed)
    text = s - N_PATCHES if arch == VLM else s
    toks = rng.randint(0, 256, size=(b, text + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if arch == VLM:
        batch["patch_embeds"] = rng.randn(b, N_PATCHES, 64).astype(np.float32)
    else:
        batch["frames"] = rng.randn(b, frames or s, 64).astype(np.float32)
    return batch


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol, atol=tol)


def _check_tree(port, ref):
    """Every leaf of ``port`` against ``ref``'s, matched by path."""
    want = dict(jax_items(ref))
    got = dict(tree_items(port))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(want[path]), rtol=TOL,
                                   atol=TOL, err_msg=path)
    return len(got)


@pytest.fixture(scope="module")
def jax_loss_grads(models):
    """Per arch: jax.value_and_grad(model.loss) on ``_batch(arch)``."""
    out = {}
    for arch in (VLM, WHISPER):
        jmodel, jparams, _ = models[arch]
        loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
            jparams, {k: jnp.asarray(v) for k, v in _batch(arch).items()})
        out[arch] = float(loss), jax.device_get(grads)
    return out


# --------------------------------------------------------------- attention
def _attn_params(models, qk_norm=False, seed=1):
    """Layer 0's self-attention of the whisper encoder (numpy) with random
    q/k norm scales when ``qk_norm``, and the configs to match."""
    jp = jax.tree.map(lambda a: a[0], models[WHISPER][1]["groups"]["enc"]["attn"])
    if qk_norm:
        rng = np.random.RandomState(seed)
        jp = dict(jp, q_norm=rng.randn(16).astype(np.float32) * 0.3,
                  k_norm=rng.randn(16).astype(np.float32) * 0.3)
    jcfg, tcfg = _configs(WHISPER, qk_norm=qk_norm)
    return jp, params_from_jax(jp, "cpu"), jcfg, tcfg


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "use_kernel"])
@pytest.mark.parametrize("s", [40, 2064], ids=["scores", "blocked"])
def test_bidirectional_attn_full_matches_jax(models, s, use_kernel, monkeypatch):
    """attn_full(causal=False) at 40 tokens (one score matrix, no mask) and
    at 2064 (above _BLOCKED_THRESHOLD: attention_blocked_bidir, whose 1024
    query chunk does not divide 2064, so one chunk); with use_kernel the
    encoder still takes the plain route: the kernels' op is never called."""
    jp, tp, jcfg, tcfg = _attn_params(models)
    x = np.random.RandomState(2).randn(1, s, 64).astype(np.float32) * 0.5
    want = jax.jit(lambda p, x: jax_attn.attn_full(p, jcfg, x, causal=False))(jp, x)
    calls = []
    monkeypatch.setattr(attention.kops, "terapipe_attention",
                        lambda *a, **k: calls.append(a) or pytest.fail("kernel op called"))
    got = attention.attn_full(tp, tcfg.replace(use_kernel=use_kernel), _t(x), causal=False)
    _close(got, want)
    assert not calls


def test_attention_blocked_bidir_matches_jax():
    """Query chunks of 8 over 24 queries, GQA 4 / 2, every key attended."""
    rng = np.random.RandomState(3)
    q = rng.randn(2, 24, 4, 8).astype(np.float32)
    k, v = (rng.randn(2, 40, 2, 8).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda *a: jax_attn.attention_blocked_bidir(*a, q_chunk=8))(q, k, v)
    got = attention.attention_blocked_bidir(_t(q), _t(k), _t(v), q_chunk=8)
    _close(got, want)
    one = attention.attention_blocked_bidir(_t(q), _t(k), _t(v), q_chunk=7)  # 7 ∤ 24
    _close(one, want)


@pytest.mark.parametrize("qk_norm", [False, True], ids=["no-norm", "qk-norm"])
def test_cross_kv_and_attn_cross_match_jax(models, qk_norm):
    """cross_kv of an encoder output (with k_norm) and attn_cross of 12
    decoder positions over its 20 rows (with q_norm); no RoPE, no mask."""
    jp, tp, jcfg, tcfg = _attn_params(models, qk_norm)
    rng = np.random.RandomState(4)
    enc = rng.randn(2, 20, 64).astype(np.float32)
    x = rng.randn(2, 12, 64).astype(np.float32)
    jk, jv = jax.jit(lambda p, e: jax_attn.cross_kv(p, jcfg, e))(jp, enc)
    tk, tv = attention.cross_kv(tp, tcfg, _t(enc))
    _close(tk, jk)
    _close(tv, jv)
    want = jax.jit(lambda p, x, k, v: jax_attn.attn_cross(p, jcfg, x, k, v))(jp, x, jk, jv)
    _close(attention.attn_cross(tp, tcfg, _t(x), tk, tv), want)


# --------------------------------------------------------------------- vlm
def test_vlm_forward_and_loss_match_jax(models, jax_loss_grads):
    """forward: logits over patches + text (tests/test_models_smoke.py's
    length); loss and every gradient leaf (the patch rows carry no loss);
    the port also under remat."""
    jmodel, jparams, tmodel = models[VLM]
    params = params_from_jax(jparams, "cpu")
    batch = _batch(VLM)
    want = jax.jit(jmodel.forward)(jparams, batch)
    got = tmodel.forward(params, _tb(batch))
    assert got.shape == (B, S, 256) == want.shape
    _close(got, want)
    j_loss, j_grads = jax_loss_grads[VLM]
    for remat in (False, True):
        model = build_model(_configs(VLM)[1].replace(remat=remat), device="cpu")
        params = tree_map(lambda a: a.requires_grad_(True), params_from_jax(jparams, "cpu"))
        loss, grads = value_and_grad(model.loss)(params, _tb(batch))
        np.testing.assert_allclose(float(loss), j_loss, rtol=TOL, atol=TOL)
        assert _check_tree(grads, j_grads) == len(jax.tree.leaves(jparams))


@pytest.mark.parametrize("slices", SLICE_SETS, ids=lambda s: "-".join(map(str, s)))
def test_vlm_sliced_equals_full(models, slices):
    """apply_groups_sliced over the slices of patches + text gives the full
    forward's activations (the first slice holds the patch rows)."""
    _, jparams, tmodel = models[VLM]
    params = params_from_jax(jparams, "cpu")
    x = tmodel.embed(params, _tb(_batch(VLM, b=2)), 0)
    assert x.shape == (2, S, 64)
    with torch.no_grad():
        full = lm.apply_groups_full(tmodel, params, x)
        caches = tmodel.init_caches(2, S, dtype=torch.float32)
        outs, ctx = [], 0
        for length in slices:
            out, caches = lm.apply_groups_sliced(tmodel, params, x[:, ctx:ctx + length],
                                                 caches, ctx)
            outs.append(out)
            ctx += length
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=TOL, atol=TOL)


def _prefill_decode(models, arch, prompt: int, total: int, max_len: int, frames: int = 0):
    """JAX's forward logits of ``total`` tokens, its prefill of the first
    ``prompt`` (vlm: behind the patch rows; enc-dec: over ``frames``
    frames) into ``max_len`` and one decode step per remaining token, and
    the port's prefill and decode of the same.  Positions count the patch
    rows."""
    jmodel, jparams, tmodel = models[arch]
    params = params_from_jax(jparams, "cpu")
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, 256, size=(2, total)).astype(np.int32)
    extra = ({"patch_embeds": rng.randn(2, N_PATCHES, 64).astype(np.float32)} if arch == VLM
             else {"frames": rng.randn(2, frames, 64).astype(np.float32)})
    off = N_PATCHES if arch == VLM else 0

    jfull = jax.jit(jmodel.forward)(jparams, {"tokens": tokens, **extra})
    logits, caches = jax.jit(jmodel.prefill, static_argnums=2)(
        jparams, {"tokens": tokens[:, :prompt], **extra}, max_len)
    decode = jax.jit(jmodel.decode_step)              # one program for every pos
    jsteps = [logits[:, -1]]
    for t in range(prompt, total):
        step, caches = decode(jparams, caches, {"tokens": tokens[:, t:t + 1]},
                              jnp.int32(off + t))
        jsteps.append(step[:, 0])
    jfull, jsteps = jax.device_get((jfull, jsteps))
    with torch.no_grad():
        logits, caches = tmodel.prefill(
            params, {"tokens": _t(tokens[:, :prompt]), **_tb(extra)}, max_len)
        tsteps = [logits[:, -1]]
        for t in range(prompt, total):
            step, caches = tmodel.decode_step(params, caches, {"tokens": _t(tokens[:, t:t + 1])},
                                              off + t)
            tsteps.append(step[:, 0])
    return jfull, jsteps, tsteps, caches


def test_vlm_prefill_then_decode_matches_jax(models):
    """Prefill 4 patch rows + 12 tokens into max_len 20, then 4 decode steps
    (no patch prefix: ctx != 0); each step's logits against JAX's decode
    and against JAX's forward at that position."""
    jfull, jsteps, tsteps, _ = _prefill_decode(models, VLM, 12, 16, 20)
    assert jfull.shape == (2, N_PATCHES + 16, 256)
    for i, (t, j) in enumerate(zip(tsteps, jsteps)):
        _close(t, j)
        _close(t, jfull[:, N_PATCHES + 11 + i])


PIPE_CASES = {
    # schedule, K, D, slices (None: M uniform slices), M, remat
    "contiguous-K2-D1-M4": ("contiguous", 2, 1, None, 4, False),
    "contiguous-K4-D2-M2-remat": ("contiguous", 4, 2, None, 2, True),
    # the first slice only patch rows, the second straddling the last one
    "contiguous-K2-nonuniform": ("contiguous", 2, 1, (3, 6, 15, 8), 0, False),
    "interleaved-V2-K2-D2-M2": ("interleaved", 2, 2, None, 2, False),
}


@pytest.mark.parametrize("case", sorted(PIPE_CASES))
def test_vlm_pipelined_step_matches_jax(case, models, jax_loss_grads):
    """The pipelined step on patches + text against JAX's non-pipelined
    value_and_grad: the prologue embeds the patch rows, the loss after the
    pipeline strips them.  Loss within 2e-5, every gradient within 2e-4."""
    schedule, K, D, slices, M, remat = PIPE_CASES[case]
    _, jparams, _ = models[VLM]
    model = build_model(_configs(VLM)[1].replace(remat=remat), device="cpu")
    params = tree_map(lambda a: a.requires_grad_(True), params_from_jax(jparams, "cpu"))
    tcfg = TeraPipeConfig(n_token_slices=M, slice_lens=slices, n_microbatches=D,
                          cache_dtype=torch.float32, schedule=schedule,
                          virtual_stages=2 if schedule == "interleaved" else 1)
    vg = make_terapipe_value_and_grad(model, tcfg, S, B, K)
    loss, grads = vg(params, _tb(_batch(VLM)))
    j_loss, j_grads = jax_loss_grads[VLM]
    assert abs(float(loss) - j_loss) < PIPE_LOSS_TOL, (float(loss), j_loss)
    assert _check_tree(grads, j_grads) == len(jax.tree.leaves(jparams))


# ----------------------------------------------------------------- whisper
def test_whisper_encode_forward_and_loss_match_jax(models, jax_loss_grads):
    """encode (every decoder layer's cross K/V of the encoder output, on
    40 frames), forward on 32 tokens over them, and the loss with every
    gradient leaf at 32 frames; the port also under remat."""
    jmodel, jparams, tmodel = models[WHISPER]
    params = params_from_jax(jparams, "cpu")
    batch = _batch(WHISPER, b=2, frames=40)
    jk, jv = jax.jit(jmodel.encode)(jparams, batch["frames"])
    tk, tv = tmodel.encode(params, _t(batch["frames"]))
    assert tk.shape == (2, 2, 40, 4, 16) == jk.shape
    _close(tk, jk)
    _close(tv, jv)
    want = jax.jit(jmodel.forward)(jparams, batch)
    _close(tmodel.forward(params, _tb(batch)), want)
    j_loss, j_grads = jax_loss_grads[WHISPER]
    for remat in (False, True):
        model = build_model(_configs(WHISPER)[1].replace(remat=remat), device="cpu")
        params = tree_map(lambda a: a.requires_grad_(True), params_from_jax(jparams, "cpu"))
        loss, grads = value_and_grad(model.loss)(params, _tb(_batch(WHISPER)))
        np.testing.assert_allclose(float(loss), j_loss, rtol=TOL, atol=TOL)
        assert _check_tree(grads, j_grads) == len(jax.tree.leaves(jparams))


def test_whisper_decoder_sliceable_encoder_not(models):
    """As the reference's test of that name: the decoder's self-attention
    slices exactly over (16, 8, 8), the encoder is bidirectional (a group
    that is not causal and has no sliced mode)."""
    _, jparams, tmodel = models[WHISPER]
    params = params_from_jax(jparams, "cpu")
    batch = _tb(_batch(WHISPER, b=2))
    enc, dec = tmodel.groups
    assert (enc.name, enc.causal, enc.sliced) == ("enc", False, None) and dec.causal
    with torch.no_grad():
        full = tmodel.forward(params, batch)
        ek, ev = tmodel.encode(params, batch["frames"])
        x = tmodel.embed(params, batch)
        ck, cv = dec.init_cache(2, S, torch.float32)
        layers = lm._unstack(params["groups"]["dec"])
        outs, ctx = [], 0
        for length in SLICE_SETS[0]:
            h = x[:, ctx:ctx + length]
            for i, bp_l in enumerate(layers):
                (h, _), _ = dec.sliced(bp_l, (h, (ek[i], ev[i])), (ck[i], cv[i]), ctx)
            outs.append(h)
            ctx += length
        sliced = tmodel.head(params, torch.cat(outs, 1))
    torch.testing.assert_close(sliced, full, rtol=TOL, atol=TOL)


def test_whisper_prefill_then_decode_matches_jax(models):
    """Prefill 24 frames and 12 tokens into max_len 16, then 4 decode
    steps over the encoder's 24 rows; cache slot 0 holds the cross K/V at
    the frames' length, as the reference's."""
    jfull, jsteps, tsteps, caches = _prefill_decode(models, WHISPER, 12, 16, 16, frames=24)
    assert caches[0][0].shape == (2, 2, 24, 4, 16) and caches[1][0].shape == (2, 2, 16, 4, 16)
    for i, (t, j) in enumerate(zip(tsteps, jsteps)):
        _close(t, j)
        _close(t, jfull[:, 11 + i])
    zeros = models[WHISPER][2].init_caches(2, 16, dtype=torch.float32)
    assert [a.shape for a in tree_leaves(zeros)] == [(2, 2, 16, 4, 16)] * 4


def test_params_from_jax_copies_the_encdec_tree(models):
    """JAX's own whisper init through params_from_jax: a leaf-wise copy onto
    the port's tree (the same paths, shapes and dtypes as the port's init),
    every value equal."""
    jmodel, _, tmodel = models[WHISPER]
    jparams = jax.device_get(jax.jit(lambda k: jmodel.init(k)[0])(jax.random.PRNGKey(3)))
    got = params_from_jax(jparams, "cpu")
    port = dict(tree_items(tmodel.init(0)))
    items = dict(tree_items(got))
    assert items.keys() == port.keys() and len(items) == len(jax.tree.leaves(jparams))
    for path, leaf in jax_items(jparams):
        assert items[path].shape == port[path].shape and items[path].dtype == port[path].dtype
        assert np.array_equal(items[path].numpy(), np.asarray(leaf)), path


def test_whisper_checkpoint_restores_into_jax(tmp_path, models):
    """A port whisper state after one AdamW update restores into the JAX
    manager bit for bit (groups/dec before groups/enc, enc_ln between embed
    and final_ln: jax.tree.flatten's order)."""
    jmodel, _, tmodel = models[WHISPER]
    params = tmodel.init(7)
    opt = adamw.adamw(1e-2)
    gen = torch.Generator().manual_seed(3)
    grads = tree_map(lambda a: torch.randn(a.shape, generator=gen), params)
    updates, opt_state = opt.update(grads, opt.init(params), params)
    state = {"params": adamw.apply_updates(params, updates), "opt": opt_state, "step": 1}
    CheckpointManager(str(tmp_path)).save(1, state)
    jparams = jax.eval_shape(lambda k: jmodel.init(k)[0], jax.random.PRNGKey(0))
    jopt = jax.eval_shape(jax_adamw.adamw(1e-2).init, jparams)
    back = JaxCheckpointManager(str(tmp_path)).restore(
        target={"params": jparams, "opt": jopt, "step": 0})
    got, want = [leaf for _, leaf in jax_items(state)], jax.tree.leaves(back)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.shape == np.shape(w) and np.array_equal(a, np.asarray(w))
    paths = [p for p, _ in jax_items(state["params"])]
    assert paths.index("/groups/dec/cross/wk") < paths.index("/groups/enc/attn/wk")
    assert paths.index("/embed") < paths.index("/enc_ln") < paths.index("/final_ln")


# ------------------------------------------------------- launcher, refusals
@pytest.mark.parametrize("arch,mode", [(VLM, "gspmd"), (VLM, "terapipe"), (WHISPER, "gspmd")])
def test_train_main_drives_vlm_and_encdec(arch, mode):
    """launch.train.main --device cpu --smoke: the batch carries the
    stubbed frontends' inputs (vlm: 4 patch rows + 12 text tokens at --seq
    16; enc-dec: 16 frames), the pipelined vlm step at K 4, M 2."""
    history = []
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--mode", mode, "--token-slices", "2",
            "--use-kernel"]
    train_launch.main(argv, history=history)
    assert len(history) == 2 and all(abs(r["loss"] - math.log(256)) < 1 for r in history)
    text = 16 - N_PATCHES if arch == VLM else 16
    assert history[1]["tok_s"] == pytest.approx(2 * text / (history[1]["ms_per_step"] / 1e3))


def test_pipeline_refuses_encdec_and_vlm_explicit_backward(models):
    """As the reference: enc-dec cannot be token-sliced (_group_split
    raises NotImplementedError in both packages; --mode terapipe too), and
    vlm is refused by the explicit-backward schedules (JAX: AssertionError,
    the port: ValueError)."""
    jmodel, _, tmodel = models[WHISPER]
    with pytest.raises(NotImplementedError, match="not token-sliceable"):
        jax_pipeline._group_split(jmodel)
    with pytest.raises(NotImplementedError, match="not token-sliceable"):
        pipeline._group_split(tmodel)
    with pytest.raises(NotImplementedError, match="not token-sliceable"):
        train_launch.main(["--arch", WHISPER, "--smoke", "--device", "cpu", "--steps", "1",
                           "--batch", "2", "--seq", "16", "--mode", "terapipe"])
    jmodel, _, tmodel = models[VLM]
    specs = jax.tree.map(lambda a: (None,) * a.ndim, jax.eval_shape(
        lambda k: jmodel.init(k)[0], jax.random.PRNGKey(0)))
    mesh = make_mesh((1, 1), ("data", "pipe"))
    for schedule, V in (("1f1b", 1), ("zb-h1", 1), ("interleaved-1f1b", 2)):
        kw = dict(schedule=schedule, virtual_stages=V)
        with use_mesh(mesh), pytest.raises(AssertionError, match="dense/moe"):
            jax_pipeline.make_terapipe_value_and_grad(
                jmodel, specs, mesh, jax_pipeline.TeraPipeConfig(**kw), S, B)
        with pytest.raises(ValueError, match="dense/moe"):
            make_terapipe_value_and_grad(tmodel, TeraPipeConfig(**kw), S, B, 2)


# -------------------------------------------------------------- dots policy
class _DotCount(TorchDispatchMode):
    """Counts the plain matrix products (aten.mm) that run."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in lm._DOTS
        return func(*args, **(kwargs or {}))


def _dots_run(models, remat, policy="full"):
    """vlm SMOKE loss and gradients (kernels routed: the plain op on the
    CPU) with the products of the forward and of the backward counted."""
    _, jparams, _ = models[VLM]
    model = build_model(_configs(VLM)[1].replace(remat=remat, remat_policy=policy,
                                                 use_kernel=True), device="cpu")
    params = tree_map(lambda a: a.requires_grad_(True), params_from_jax(jparams, "cpu"))
    with _DotCount() as fwd:
        loss = model.loss(params, _tb(_batch(VLM)))
    with _DotCount() as bwd:
        grads = torch.autograd.grad(loss, list(tree_leaves(params)))
    return loss.detach(), grads, fwd.n, bwd.n


def test_dots_policy_saves_the_blocks_products(models):
    """remat_policy="dots" (jax's dots_with_no_batch_dims_saveable): loss
    and every gradient bit-equal to the full policy's; its backward runs
    exactly the products that the backward without remat runs (none of a
    block's forward again), where the full policy's runs 6 of each block's
    7 forward products again (q, k, v, o, gate, up: the non-reentrant
    checkpoint stops its recompute once it holds every tensor the backward
    needs, and no gradient needs the down projection's output)."""
    n_layers = get_config(VLM, smoke=True).n_layers
    l_full, g_full, f_full, b_full = _dots_run(models, True, "full")
    l_dots, g_dots, f_dots, b_dots = _dots_run(models, True, "dots")
    _, _, f_none, b_none = _dots_run(models, False)
    assert torch.equal(l_dots, l_full)
    assert all(torch.equal(a, b) for a, b in zip(g_dots, g_full))
    assert f_full == f_dots == f_none
    assert b_dots == b_none and b_full == b_none + 6 * n_layers, (b_full, b_dots, b_none)


@pytest.mark.parametrize("what", ["whisper", "vlm-pipelined"])
def test_dots_policy_reaches_only_the_models_own_stack(models, what):
    """As the reference, only _scan_full obeys the policy: whisper's
    encoder and decoder loops and the pipeline's stages use the plain
    checkpoint, so under "dots" their backward runs every product that it
    runs under "full", and the results are the same bits."""
    arch = WHISPER if what == "whisper" else VLM
    _, jparams, _ = models[arch]
    runs = []
    for policy in ("full", "dots"):
        model = build_model(_configs(arch)[1].replace(remat=True, remat_policy=policy),
                            device="cpu")
        params = tree_map(lambda a: a.requires_grad_(True), params_from_jax(jparams, "cpu"))
        vg = (value_and_grad(model.loss) if arch == WHISPER else make_terapipe_value_and_grad(
            model, TeraPipeConfig(n_token_slices=2, cache_dtype=torch.float32), S, B, 2))
        with _DotCount() as count:
            loss, grads = vg(params, _tb(_batch(arch)))
        runs.append((loss, list(tree_leaves(grads)), count.n))
    (l_full, g_full, n_full), (l_dots, g_dots, n_dots) = runs
    assert n_dots == n_full and torch.equal(l_dots, l_full)
    assert all(torch.equal(a, b) for a, b in zip(g_dots, g_full))


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("smoke", [False, True], ids=["FULL", "SMOKE"])
@pytest.mark.parametrize("arch", [VLM, WHISPER])
def test_configs_match_reference(arch, smoke):
    """Every field of the port's config equals the reference's (dtype by
    name)."""
    port = dataclasses.asdict(get_config(arch, smoke=smoke))
    ref = dataclasses.asdict(jax_get_config(arch, smoke=smoke))
    assert port.keys() == ref.keys()
    assert str(port.pop("dtype")).split(".")[-1] == jnp.dtype(ref.pop("dtype")).name
    assert port == ref


def test_every_arch_builds():
    """get_config and build_model accept every architecture of ARCHS and
    PAPER_ARCHS (SMOKE, on the CPU), each model's loss finite on its
    family's batch."""
    for arch in ARCHS + PAPER_ARCHS:
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg, device="cpu")
        s = max(16, cfg.moe_block if cfg.family == "moe" else 0)
        fam = VLM if cfg.family == "vlm" else WHISPER if cfg.family == "encdec" else None
        batch = _batch(fam, b=1, s=s) if fam else {
            k: v for k, v in _batch(WHISPER, b=1, s=s).items() if k != "frames"}
        with torch.no_grad():
            loss = model.loss(model.init(0), _tb(batch))
        assert math.isfinite(float(loss)), arch
