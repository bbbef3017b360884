"""Train and serve step factories.

A port of ``repro.train.step``: ``make_train_step`` (gradient accumulation
over ``policy.n_micro`` microbatches in float32), ``make_prefill_step`` and
``make_decode_step``, plain functions of a parameter tree.  The reference
jits them under a mesh with the sharding trees of ``batch_pspec``,
``train_shardings``, ``batch_shardings`` and ``cache_shardings``; those are
mesh-bound and wait for the mesh-bound paths.  ``value_and_grad`` is the
counterpart of ``jax.value_and_grad`` for a function of a parameter tree.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.launch.policy import CellPolicy
from repro_torch.models.model import Model
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw


def value_and_grad(fn: Callable, params) -> Tuple[torch.Tensor, Dict]:
    """(``fn(params)``, its gradient with respect to every leaf of
    ``params``): a detached scalar and a tree of ``params``' nesting whose
    leaves have their parameters' dtypes (zeros for a leaf ``fn`` does not
    read, as JAX gives)."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        value = fn(tree_unflatten(params, leaves))
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return value.detach(), tree_unflatten(params, grads)


def _microbatches(batch: Dict[str, torch.Tensor], n_micro: int):
    def split(x):
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} does not split into {n_micro} "
                             f"microbatches")
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n_micro)]


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    policy: CellPolicy):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss's gradient, summed over ``policy.n_micro``
    microbatches in float32 and averaged, then one AdamW update;
    ``metrics`` holds ``loss``, ``grad_norm`` and ``lr``."""
    n_micro = policy.n_micro

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            loss, grads = value_and_grad(lambda p: model.loss(p, batch),
                                         params)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            loss = None
            for mb in _microbatches(batch, n_micro):
                lm, gm = value_and_grad(lambda p: model.loss(p, mb), params)
                grads = tree_map(torch.add, grads, gm)
                loss = lm.float() if loss is None else loss + lm
            # XLA turns the division by a constant into a product with its
            # float32 reciprocal
            grads = tree_map(lambda g: g * (1.0 / n_micro), grads)
            loss = loss * (1.0 / n_micro)
        new_params, new_opt, metrics = adamw.update(grads, opt_state, params,
                                                    opt_cfg)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(model: Model):
    """``prefill_step(params, batch) -> (last-position logits, caches)``;
    an encoder-only model returns its forward's last position and no
    cache."""
    def prefill_step(params, batch):
        if model.cfg.encoder_only:
            logits = model.forward(params, tokens=batch.get("tokens"),
                                   embeds=batch.get("embeds"))
            return logits[:, -1, :], None
        return model.prefill(params, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"),
                             vision_states=batch.get("vision_states"))
    return prefill_step


def make_decode_step(model: Model):
    """``decode_step(params, cache, index, batch) -> (logits, cache)``."""
    def decode_step(params, cache, index, batch):
        return model.decode_step(params, cache, index, batch["tokens"],
                                 vision_states=batch.get("vision_states"))
    return decode_step
