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
shape and dtype and no storage.  The shardings of the reference
(``cache_pspec``, ``cache_shardings``, ``gspmd_shardings``) need a device
mesh, which the port does not have yet.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.core.pipeline import value_and_grad
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
