"""The port's layout layer against the JAX package's.

* ``Model.specs()`` equals the spec tree of the reference's
  ``abstract_init`` for every FULL arch of ``ARCHS`` and ``PAPER_ARCHS``;
  the meta parameter and optimizer-state trees of ``launch/steps.py``
  have the shapes and dtypes of the reference's ``jax.eval_shape``
  structs, and so do ``abstract_caches`` (one SMOKE config per family);
* ``SHAPES``, ``skip_reason`` and ``input_specs`` on every (arch x shape);
* a meta ``abstract_init`` allocates nothing, and ``Model.init(seed)`` on
  the CPU keeps its draws;
* ``make_train_step`` (gpt3 and qwen3 SMOKE, f32, 2 steps),
  ``make_prefill_step`` and ``make_decode_step`` within 2e-4 of the
  reference's, from the same parameters;
* ``distributed/collectives.py`` bit for bit with the reference, and the
  ports of ``tests/test_substrate.py``'s compression tests.
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from repro import configs as jax_configs
from repro.distributed import collectives as jax_coll
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch import configs
from repro_torch.distributed import collectives as coll
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.tree import jax_items, tree_items, tree_leaves, tree_map

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

TOL = 2e-4
ALL_ARCHS = configs.ARCHS + configs.PAPER_ARCHS
FAMILY_SMOKES = ["qwen3-0.6b", "deepseek-moe-16b", "mamba2-2.7b", "recurrentgemma-9b",
                 "whisper-medium", "phi-3-vision-4.2b"]


def _struct(tree) -> dict:
    """path -> (shape, dtype name) of a port tree (meta or not)."""
    return {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in jax_items(tree)}


def _jax_struct(tree) -> dict:
    """The same of a JAX tree of ShapeDtypeStructs or arrays, with the
    port's paths (dict keys and sequence indices joined by '/')."""
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    return {"".join(f"/{key(k)}" for k in path): (tuple(a.shape), jnp.dtype(a.dtype).name)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_specs_params_and_opt_state_match_reference(arch):
    jmodel = jax_build_model(jax_configs.get_config(arch))
    j_structs, j_specs = jax_steps.abstract_init(jmodel)
    model = build_model(configs.get_config(arch), "cpu")
    params, specs = steps.abstract_init(model)
    assert specs == j_specs == model.specs()
    assert _struct(params) == _jax_struct(j_structs)
    # the spec tree has the parameter tree's keys, one axis name per dim
    assert {p: t.dim() for p, t in tree_items(params)} == {
        p: len(s) for p, s in _spec_items(specs)}
    opt = steps.abstract_opt_state(adamw.adamw(1e-3), params)
    j_opt = jax_steps.abstract_opt_state(jax_adamw.adamw(1e-3), j_structs)
    assert _struct(opt._asdict()) == _jax_struct(j_opt._asdict())


def _spec_items(specs, prefix=""):
    for k, v in specs.items():
        if isinstance(v, dict):
            yield from _spec_items(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def test_abstract_init_allocates_nothing_and_recasts():
    # gpt3-175b's 233 B f32 parameters would be 933 GB of storage
    params, _ = steps.abstract_init(build_model(configs.get_config("gpt3-175b"), "cpu"))
    assert all(t.is_meta for t in tree_leaves(params))
    assert sum(t.numel() for t in tree_leaves(params)) == 233_165_721_600
    cfg = configs.get_config("qwen3-0.6b")
    bf16, _ = steps.abstract_init(build_model(cfg, "meta"), param_dtype=torch.bfloat16)
    assert {t.dtype for t in tree_leaves(bf16)} == {torch.bfloat16}
    j_bf16, _ = jax_steps.abstract_init(jax_build_model(jax_configs.get_config("qwen3-0.6b")),
                                        param_dtype=jnp.bfloat16)
    assert _struct(bf16) == _jax_struct(j_bf16)
    opt = adamw.adamw(1e-3, master_weights=True)
    j_opt = jax_adamw.adamw(1e-3, master_weights=True)
    assert (_struct(steps.abstract_opt_state(opt, bf16)._asdict())
            == _jax_struct(jax_steps.abstract_opt_state(j_opt, j_bf16)._asdict()))


@pytest.mark.parametrize("mode", ["decode", "sliced"])
@pytest.mark.parametrize("arch", FAMILY_SMOKES)
def test_abstract_caches_match_reference(arch, mode):
    jmodel = jax_build_model(jax_configs.get_config(arch, smoke=True))
    model = build_model(configs.get_config(arch, smoke=True), "cpu")
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        caches = steps.abstract_caches(model, 3, 40, dtype, mode=mode)
        assert all(t.is_meta for t in tree_leaves(caches))
        want = jax_steps.abstract_caches(jmodel, 3, 40, jdtype, mode=mode)
        assert _struct(caches) == _jax_struct(want)


#: sha256 (first 16 hex digits) of ``Model.init(3)`` of each SMOKE config
#: on the CPU, every leaf's path, dtype, shape and bytes, taken before the
#: meta device came to ``init``: its draws must not change
INIT_DIGESTS = {
    "gpt3-1b": "789c0b6723a1001f",
    "qwen3-0.6b": "2f628a0f965b7256",
    "deepseek-moe-16b": "5051226c36ba125a",
    "mamba2-2.7b": "c234fe75a399572a",
    "recurrentgemma-9b": "5122874c97003f63",
    "whisper-medium": "bad16dfc01dee23d",
    "phi-3-vision-4.2b": "ddb73739889d3b27",
}


@pytest.mark.parametrize("arch", sorted(INIT_DIGESTS))
def test_model_init_keeps_its_draws(arch):
    params = build_model(configs.get_config(arch, smoke=True), "cpu").init(3)
    h = hashlib.sha256()
    for path, t in tree_items(params):
        h.update(path.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest()[:16] == INIT_DIGESTS[arch]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_shapes_skip_reason_and_input_specs_match_reference(arch):
    assert {k: vars(v) for k, v in configs.SHAPES.items()} == {
        k: vars(v) for k, v in jax_configs.SHAPES.items()}
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    for name, shape in configs.SHAPES.items():
        reason = configs.skip_reason(arch, name)
        assert reason == jax_configs.skip_reason(arch, name)
        if reason is not None:
            continue
        batch = configs.input_specs(cfg, shape)
        assert all(t.is_meta for t in batch.values())
        assert _struct(batch) == _jax_struct(
            jax_configs.input_specs(jcfg, jax_configs.SHAPES[name]))


# ------------------------------------------------------------------ steps
def _pair(arch, **kw):
    """The JAX and the port's model of ``arch``'s SMOKE config in f32, and
    the port's seeded parameters for both (numpy leaves for JAX)."""
    jmodel = jax_build_model(jax_configs.get_config(arch, smoke=True).replace(
        dtype=jnp.float32, **kw))
    model = build_model(configs.get_config(arch, smoke=True).replace(
        dtype=torch.float32, **kw), "cpu")
    params = model.init(seed=0)
    return jmodel, model, tree_map(lambda t: t.numpy().copy(), params), params


def _close(t, j, what):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j, np.float32), rtol=TOL,
                               atol=TOL, err_msg=what)


@pytest.mark.parametrize("arch", ["gpt3-1b", "qwen3-0.6b"])
def test_train_step_matches_reference(arch):
    """Two steps; the losses and every parameter within TOL.  AdamW's eps
    is 1e-4: its step is ~lr * g / (|g| + eps), so at the default 1e-8 an
    element whose gradient cancels to rounding noise (4e-8 against a
    largest 0.29 in gpt3's embedding, step 2) moves by ~lr, with the
    noise's sign."""
    jmodel, model, jparams, params = _pair(arch, remat=False)
    jopt = jax_adamw.adamw(jax_adamw.cosine_schedule(1e-2, 1, 4), eps=1e-4)
    opt = adamw.adamw(adamw.cosine_schedule(1e-2, 1, 4), eps=1e-4)
    jstep = jax.jit(jax_steps.make_train_step(jmodel, jopt))
    step = steps.make_train_step(model, opt)
    jstate, state = jopt.init(jparams), opt.init(params)
    rng = np.random.RandomState(1)
    for i in range(2):
        toks = rng.randint(0, model.cfg.vocab_size, size=(2, 33)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        jparams, jstate, jloss = jstep(jparams, jstate, batch)
        params, state, loss = step(params, state, {k: torch.from_numpy(a)
                                                   for k, a in batch.items()})
        _close(loss, jloss, f"loss, step {i}")
    assert not any(p.requires_grad for p in tree_leaves(params))
    jleaves = dict(jax_items(jax.device_get(jparams)))
    for path, p in jax_items(params):
        _close(p, jleaves[path], path)
    assert int(state.step) == int(jstate.step) == 2


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-medium"])
def test_prefill_and_decode_steps_match_reference(arch):
    jmodel, model, jparams, params = _pair(arch)
    rng = np.random.RandomState(2)
    b, prompt, max_len = 2, 12, 20
    batch = {"tokens": rng.randint(0, model.cfg.vocab_size, size=(b, prompt)).astype(np.int32)}
    if model.cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(b, 10, model.cfg.d_model)).astype(np.float32)
    jlogits, jcaches = jax.jit(jax_steps.make_prefill_step(jmodel, max_len))(jparams, batch)
    logits, caches = steps.make_prefill_step(model, max_len)(
        params, {k: torch.from_numpy(a) for k, a in batch.items()})
    _close(logits, jlogits, "prefill logits")
    jdecode, decode = jax.jit(jax_steps.make_decode_step(jmodel)), steps.make_decode_step(model)
    for i in range(3):
        tok = rng.randint(0, model.cfg.vocab_size, size=(b, 1)).astype(np.int32)
        jlogits, jcaches = jdecode(jparams, jcaches, {"tokens": tok}, jnp.int32(prompt + i))
        logits, caches = decode(params, caches, {"tokens": torch.from_numpy(tok)}, prompt + i)
        _close(logits, jlogits, f"decode step {i}")
    jleaves = [np.asarray(a, np.float32) for a in jax.tree.leaves(jcaches)]
    for i, (c, j) in enumerate(zip(tree_leaves(caches), jleaves)):
        _close(c.float(), j, f"cache leaf {i}")


# ------------------------------------------------------------ collectives
def _grad_tree(rng):
    """Leaves at scales from 1e-6 to 1e3, one all zero, one with ties at
    half a quantization step; one shape, so JAX compiles each op once."""
    shape = (16, 32)
    tree = {"w": rng.normal(size=shape) * 1e3, "b": rng.normal(size=shape) * 1e-6,
            "nested": {"a": rng.normal(size=shape), "z": np.zeros(shape)},
            "ties": np.arange(-128.0, 128.0, 0.5).reshape(shape)}
    return tree_map(lambda a: a.astype(np.float32), tree)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_collectives_bit_for_bit_with_reference():
    # eagerly, op by op: under jit XLA fuses the residual's multiply and
    # subtract into one rounding (1e-13 apart at the 1e-9 leaf)
    j_compress, j_decompress = jax_coll.int8_ef_compress, jax_coll.int8_ef_decompress
    rng = np.random.RandomState(3)
    state = coll.int8_ef_init(tree_map(torch.from_numpy, _grad_tree(rng)))
    jstate = jax_coll.int8_ef_init(tree_map(jnp.asarray, _grad_tree(rng)))
    for _ in range(3):
        g = _grad_tree(rng)
        q, scales, state = coll.int8_ef_compress(tree_map(torch.from_numpy, g), state)
        jq, jscales, jstate = j_compress(tree_map(jnp.asarray, g), jstate)
        sent = coll.int8_ef_decompress(q, scales)
        jsent = j_decompress(jq, jscales)
        for tree, jtree in ((q, jq), (scales, jscales), (state.residual, jstate.residual),
                            (sent, jsent)):
            jleaves = dict(jax_items(jax.device_get(jtree)))
            for path, t in jax_items(tree):
                assert t.dtype == {"int8": torch.int8, "float32": torch.float32}[
                    jleaves[path].dtype.name]
                np.testing.assert_array_equal(t.numpy(), jleaves[path], err_msg=path)
    g = _grad_tree(rng)
    packed = coll.bf16_compress(tree_map(torch.from_numpy, g))
    jpacked = jax_coll.bf16_compress(tree_map(jnp.asarray, g))
    for (path, t), (_, j) in zip(jax_items(packed), jax_items(jax.device_get(jpacked))):
        np.testing.assert_array_equal(_bits(t), _jbits(j), err_msg=path)
    for (path, t), (_, j) in zip(jax_items(coll.bf16_decompress(packed)),
                                 jax_items(jax.device_get(jax_coll.bf16_decompress(jpacked)))):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=path)


def test_bf16_roundtrip_close():
    g = {"w": torch.linspace(-3, 3, 64)}
    out = coll.bf16_decompress(coll.bf16_compress(g))
    assert out["w"].dtype == torch.float32
    np.testing.assert_allclose(out["w"].numpy(), g["w"].numpy(), atol=2e-2)


@given(seed=st.integers(0, 1000))
@settings(max_examples=10, deadline=None)
def test_int8_error_feedback_mean_unbiased(seed):
    """With error feedback the accumulated quantized signal tracks the
    accumulated true gradient within the residual."""
    rng = np.random.default_rng(seed)
    state = coll.int8_ef_init({"w": torch.zeros(32)})
    total_true = np.zeros(32)
    total_sent = np.zeros(32)
    for step in range(20):
        g = {"w": torch.from_numpy((rng.normal(size=32) * (1 + step % 3)).astype(np.float32))}
        total_true += g["w"].numpy()
        q, scales, state = coll.int8_ef_compress(g, state)
        total_sent += coll.int8_ef_decompress(q, scales)["w"].numpy()
    resid = np.abs(state.residual["w"].numpy())
    np.testing.assert_allclose(total_sent, total_true, atol=float(resid.max()) + 1e-6)
