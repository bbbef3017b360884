"""Train and serve step factories and their shardings.

A port of ``repro.train.step``: ``make_train_step`` (gradient accumulation
over ``policy.n_micro`` microbatches in float32), ``make_prefill_step`` and
``make_decode_step``, plain functions of a parameter tree, and the specs
that place a step's inputs over a mesh (``batch_pspec``,
``train_shardings``, ``batch_shardings``, ``cache_shardings``).
``value_and_grad`` is the counterpart of ``jax.value_and_grad`` for a
function of a parameter tree.

Under a mesh (``sharding.use_mesh``) the train step is data parallel: each
rank runs its shard of every microbatch over ``policy.batch_axes`` and the
loss and gradients are averaged over those axes before the AdamW update,
so every rank holds the same whole parameters and optimizer state.  The
parameter specs place a tree at rest (checkpoints); inside the step the
parameters stay whole on every rank.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.launch.policy import CellPolicy
from repro_torch.models.model import Model
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw


def batch_pspec(policy: CellPolicy, ndim: int) -> shd.Spec:
    return (shd.entry(policy.batch_axes),) + (None,) * (ndim - 1)


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
    ``metrics`` holds ``loss``, ``grad_norm`` and ``lr``.

    Under a mesh, ``batch`` is the global batch and each rank computes on
    its shard of each microbatch (``batch_pspec``); the loss and the
    gradients are then averaged over ``policy.batch_axes``."""
    n_micro = policy.n_micro

    def train_step(params, opt_state, batch):
        mesh = shd.get_current_mesh()
        axes = mesh.axes(policy.batch_axes) if mesh is not None else ()

        def grad_of(mb):
            if mesh is None:
                return value_and_grad(lambda p: model.loss(p, mb), params)
            mb = {k: shd.local_shard(v, batch_pspec(policy, v.dim()), mesh)
                  for k, v in mb.items()}
            with shd.use_batch_axes(axes):
                return value_and_grad(lambda p: model.loss(p, mb), params)

        if n_micro == 1:
            loss, grads = grad_of(batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            loss = None
            for mb in _microbatches(batch, n_micro):
                lm, gm = grad_of(mb)
                grads = tree_map(torch.add, grads, gm)
                loss = lm.float() if loss is None else loss + lm
            # XLA turns the division by a constant into a product with its
            # float32 reciprocal
            grads = tree_map(lambda g: g * (1.0 / n_micro), grads)
            loss = loss * (1.0 / n_micro)
        if mesh is not None:
            n = mesh.size(axes)
            loss = shd.psum(loss, axes, mesh) / n
            grads = tree_map(lambda g: shd.psum(g, axes, mesh) / n, grads)
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


# ------------------------------------------------------- sharding builders --

def train_shardings(model: Model, policy: CellPolicy, mesh,
                    opt_cfg: adamw.AdamWConfig):
    """(parameter specs, AdamW state specs) over ``mesh``, each leaf a
    ``sharding.Named``."""
    with shd.use_mesh(mesh):
        pspecs = model.partition_specs()
    opt_specs = adamw.state_partition_specs(pspecs)
    ns = lambda spec: shd.Named(mesh, spec)
    return (tree_map(ns, pspecs),
            adamw.AdamWState(step=ns(opt_specs.step),
                             m=tree_map(ns, opt_specs.m),
                             v=tree_map(ns, opt_specs.v)))


def batch_shardings(batch_specs: Dict[str, torch.Tensor],
                    policy: CellPolicy, mesh):
    return {k: shd.Named(mesh, batch_pspec(policy, v.dim()))
            for k, v in batch_specs.items()}


_SEQ_KEYS = ("k", "v", "ckv", "kr", "ks", "vs")


def cache_shardings(cache_structs, policy: CellPolicy, mesh):
    """Decode caches: batch dim (axis 1, after the layer-stack dim) over the
    batch axes; attention caches' L axis (axis 2) over 'model' when the
    policy picked flash-decoding seq-sharding."""
    batch = shd.entry(a for a in policy.batch_axes if a in mesh.axis_names)

    def f(tree):
        out = {}
        for key, x in tree.items():
            if isinstance(x, dict):
                out[key] = f(x)
                continue
            spec = [None] * x.dim()
            if x.dim() >= 2:
                spec[1] = batch
            if policy.seq_shard and key in _SEQ_KEYS and x.dim() >= 3:
                spec[2] = "model"
            out[key] = shd.Named(mesh, tuple(spec))
        return out
    return f(cache_structs)
