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
loss and gradients are averaged over those axes before the AdamW update.
Without ``shardings`` every rank holds the same whole parameters and
optimizer state.  With them (``train_shardings``' pair; for serving,
``param_shardings``) each rank holds only its block of every parameter and
AdamW leaf, as the reference's ``NamedSharding`` places it
(``sharding.shard_tree``): the step gathers one repeat's leaves at a time
and reduces each gradient to the rank's block (``distributed/fsdp.py``),
and takes and returns trees of blocks (the reference's ``out_shardings``).
"""
from __future__ import annotations

import contextlib
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
                    policy: CellPolicy, shardings=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss's gradient, summed over ``policy.n_micro``
    microbatches in float32 and averaged, then one AdamW update;
    ``metrics`` holds ``loss``, ``grad_norm`` and ``lr``.

    Under a mesh, ``batch`` is the global batch and each rank computes on
    its shard of each microbatch (``batch_pspec``); the loss and the
    gradients are then averaged over ``policy.batch_axes``.  With
    ``shardings`` (``train_shardings``' (params, AdamW state) pair, whose
    mesh the step runs under) ``params`` and ``opt_state`` are this rank's
    blocks, the gradients come back as blocks and accumulate as float32
    blocks, and the step returns blocks of the same specs."""
    n_micro = policy.n_micro
    pnamed = None if shardings is None else shardings[0]
    step_mesh = None if pnamed is None else tree_leaves(pnamed)[0].mesh

    def train_step(params, opt_state, batch):
        with (contextlib.nullcontext() if step_mesh is None
              else shd.use_mesh(step_mesh)):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        mesh = shd.get_current_mesh()
        axes = mesh.axes(policy.batch_axes) if mesh is not None else ()

        def grad_of(mb):
            if mesh is None:
                return value_and_grad(lambda p: model.loss(p, mb), params)
            mb = {k: shd.local_shard(v, batch_pspec(policy, v.dim()), mesh)
                  for k, v in mb.items()}
            with shd.use_batch_axes(axes):
                return value_and_grad(
                    lambda p: model.loss(p, mb, shardings=pnamed), params)

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
            if pnamed is None:
                grads = tree_map(lambda g: shd.psum(g, axes, mesh) / n, grads)
            else:       # the backward summed each block over the batch axes
                grads = tree_map(lambda g: g / n, grads)
        new_params, new_opt, metrics = adamw.update(grads, opt_state, params,
                                                    opt_cfg, pnamed)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(model: Model, shardings=None):
    """``prefill_step(params, batch) -> (last-position logits, caches)``;
    an encoder-only model returns its forward's last position and no
    cache.  ``max_len`` pads the caches for decode.  With ``shardings``
    (``param_shardings``) ``params`` holds this rank's blocks, gathered one
    repeat at a time."""
    def prefill_step(params, batch, max_len=None):
        if model.cfg.encoder_only:
            logits = model.forward(params, tokens=batch.get("tokens"),
                                   embeds=batch.get("embeds"),
                                   shardings=shardings)
            return logits[:, -1, :], None
        return model.prefill(params, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"),
                             vision_states=batch.get("vision_states"),
                             max_len=max_len, shardings=shardings)
    return prefill_step


def make_decode_step(model: Model, shardings=None):
    """``decode_step(params, cache, index, batch) -> (logits, cache)``;
    ``shardings`` as for :func:`make_prefill_step`."""
    def decode_step(params, cache, index, batch):
        return model.decode_step(params, cache, index, batch["tokens"],
                                 vision_states=batch.get("vision_states"),
                                 shardings=shardings)
    return decode_step


# ------------------------------------------------------- sharding builders --

def param_shardings(model: Model, mesh, drop_fsdp: bool = False):
    """Each parameter leaf's ``sharding.Named`` over ``mesh``, from
    ``model.partition_specs(drop_fsdp)`` (serving: ``drop_fsdp`` keeps the
    weights whole over the data-parallel axes)."""
    with shd.use_mesh(mesh):
        pspecs = model.partition_specs(drop_fsdp)
    return tree_map(lambda spec: shd.Named(mesh, spec), pspecs)


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
