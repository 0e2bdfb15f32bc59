"""Step builders and abstract (storage-free) parameter, optimizer and
cache structures (reference: ``repro/launch/steps.py``).

The steps, functional as the reference's:
  * train_step(params, opt_state, batch)    -> (params, opt_state, loss)
  * prefill_step(params, batch)             -> (logits, caches)
  * decode_step(params, caches, batch, pos) -> (logits, caches)

They run ``Model.loss``, ``prefill`` and ``decode_step``, so attention
reaches the kernels exactly when it does there (``cfg.use_kernel`` and
CUDA tensors).  The reference's ``jax.eval_shape`` is the ``meta`` device:
``abstract_*`` build the model's twin there and return tensors with every
shape and dtype and no storage.  The shardings (``cache_pspec``,
``cache_shardings``, ``gspmd_shardings``) run over those meta structures on a
:class:`~repro_torch.launch.mesh.Mesh` and return the reference's
placements (``distributed/sharding.py``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Sequence, Tuple

import torch

from repro_torch.core.pipeline import value_and_grad
from repro_torch.distributed.sharding import NamedSharding, PartitionSpec, param_shardings
from repro_torch.launch.mesh import Mesh
from repro_torch.models import Model, build_model
from repro_torch.optim.adamw import Optimizer, apply_updates
from repro_torch.tree import tree_map


def _meta_twin(model: Model) -> Model:
    return model if model.device.type == "meta" else build_model(model.cfg, "meta")


def abstract_init(model: Model, seed: int = 0, param_dtype=None) -> Tuple[Any, Any]:
    """``(meta parameter tree, specs)`` of ``model.init(seed)`` without
    allocating anything; ``param_dtype`` (e.g. bf16) recasts the floating
    leaves (training on master weights)."""
    params = _meta_twin(model).init(seed)
    if param_dtype is not None:
        params = tree_map(lambda a: a.to(param_dtype) if a.is_floating_point() else a,
                          params)
    return params, model.specs()


def abstract_opt_state(optimizer: Optimizer, param_structs):
    """``optimizer.init`` on meta parameters: the state's meta tree."""
    return optimizer.init(param_structs)


def abstract_caches(model: Model, batch: int, max_len: int, dtype=torch.bfloat16,
                    mode: str = "decode"):
    """``model.init_caches`` on the meta device."""
    return _meta_twin(model).init_caches(batch, max_len, dtype, mode=mode)


def make_train_step(model: Model, optimizer: Optimizer) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``:
    the loss and gradients of ``model.loss`` by autograd, then
    ``optimizer.update`` and ``apply_updates``; the same operations in the
    same order as ``launch/train.py::train_step`` in the gspmd mode.  The
    parameters need not require grad (autograd runs on detached views of
    them); the new ones do not.  The caller's references keep the old
    parameters and state alive until it rebinds them."""
    vg = value_and_grad(model.loss)

    def train_step(params, opt_state, batch):
        loss, grads = vg(tree_map(lambda p: p.detach().requires_grad_(True), params), batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        del grads
        return apply_updates(params, updates), opt_state, loss

    return train_step


def make_prefill_step(model: Model, max_len: int) -> Callable:
    """``prefill_step(params, batch) -> (logits, caches)`` of ``max_len``
    rows, without autograd."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len)
    return prefill_step


def make_decode_step(model: Model) -> Callable:
    """``decode_step(params, caches, batch, pos) -> (logits, caches)``,
    without autograd; the caches are updated in place and returned."""
    @torch.no_grad()
    def decode_step(params, caches, batch, pos):
        return model.decode_step(params, caches, batch, pos)
    return decode_step


def cache_pspec(shape: Tuple[int, ...], mesh: Mesh, data_axes: Sequence[str],
                model_axis: str = "model") -> PartitionSpec:
    """Heuristic cache sharding: the batch dim (axis 1 of stacked caches)
    over the data axes when they divide it; then the kv-head-like dim
    (ndim - 2), else the largest remaining dim, over the model axis."""
    entries: list = [None] * len(shape)
    dsize = math.prod(mesh.shape[a] for a in data_axes)
    msize = mesh.shape[model_axis]
    if len(shape) >= 2 and shape[1] % dsize == 0 and shape[1] > 0:
        entries[1] = tuple(data_axes)
    cand_order = []
    if len(shape) >= 2:
        cand_order.append(len(shape) - 2)
    cand_order += sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in cand_order:
        if entries[i] is None and shape[i] % msize == 0 and shape[i] >= msize:
            entries[i] = model_axis
            break
    return PartitionSpec(*entries)


def cache_shardings(cache_structs, mesh: Mesh, data_axes: Sequence[str]):
    """:func:`cache_pspec` of every leaf of a cache tree (``abstract_caches``)."""
    return tree_map(lambda a: NamedSharding(mesh, cache_pspec(tuple(a.shape), mesh, data_axes)),
                    cache_structs)


def gspmd_shardings(model: Model, mesh: Mesh, *, optimizer=None, fsdp: bool = True,
                    data_axes=("data",), param_dtype=None, rules=None, seq_axis=None):
    """``(param_structs, specs, param_sh, opt_structs, opt_sh)``: the meta
    structures of :func:`abstract_init` and :func:`abstract_opt_state` and
    their placements.  The moments and ``master`` share the parameters'
    layout; ``step`` is replicated.

    The reference also pins the models' activation batch sharding to
    ``data_axes`` (and the sequence to ``seq_axis``) through
    ``set_activation_sharding``, a hint to XLA's sharding propagation.  An
    eager step has no propagation to hint, so ``seq_axis`` is accepted and
    nothing is done with it."""
    del seq_axis
    structs, specs = abstract_init(model, param_dtype=param_dtype)
    fsdp_axes = tuple(data_axes) if fsdp else None
    shard = lambda tree: param_shardings(specs, tree, mesh, fsdp_axes=fsdp_axes, rules=rules)
    p_sh = shard(structs)
    if optimizer is None:
        return structs, specs, p_sh, None, None
    o_structs = abstract_opt_state(optimizer, structs)
    o_sh = type(o_structs)(
        NamedSharding(mesh, PartitionSpec()), shard(o_structs.m), shard(o_structs.v),
        shard(o_structs.master) if o_structs.master is not None else None)
    return structs, specs, p_sh, o_structs, o_sh
