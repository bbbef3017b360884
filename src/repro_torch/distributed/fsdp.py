"""Sharded parameter storage inside a step: each rank holds its block.

The reference places every parameter and AdamW moment by its
``NamedSharding`` (``train_shardings``; ``model.partition_specs()`` when
serving), and GSPMD stores each leaf as the device's block of that spec.
Here a rank holds the same block (``sharding.shard_tree``) and a step reads
a leaf whole through :func:`gather_param`: the stack gathers one repeat's
leaves at a time, inside the function that ``torch.utils.checkpoint``
wraps, so that under ``cfg.remat`` no gathered weight outlives its repeat
(the backward gathers again).  Without remat, autograd keeps what the
layers save of the gathered weights (a matmul's operand) until the
backward: the storage is sharded between steps and inside the repeat, not
across the forward.  This is ZeRO-3 / FSDP over every axis that a spec
names, but 'model' where the layer computes on its block (below).

The gradient comes back as the rank's block.  A rank's gradient is the
gradient of its own loss (as in ``sharding``'s differentiable
collectives), so each mesh axis reduces the whole gradient by where it
stands (``B``: the batch axes, ``policy.batch_axes``):

=====  ============  =========  ==========================================
axis   in the spec   in ``B``   forward and backward over this axis
=====  ============  =========  ==========================================
a      yes           yes        gather; reduce-scatter (sum)
b      yes           no         gather; the rank's own block, no sum: its
                                ranks computed the same loss on the same
                                tokens.  The ranks repeat each other's
                                compute: RWKV's time mix, should a
                                config cut it
b'     yes ('model') no         no gather: the layer computes on the block
                                (``distributed/tp.py``), which gets its
                                whole gradient there, no sum; the caller
                                passes the spec without 'model'
                                (``drop_axes``, ``tp.compute_named``)
c      no            yes        all-reduce (sum), as the whole-tree step
=====  ============  =========  ==========================================

which is ``local_shard`` of the whole-tree step's ``psum`` over ``B``.  The
step then divides by the size of ``B`` as before.  A leaf that the loss
does not read gets no backward, so no collective, on every rank alike (its
gradient is zeros).  The collectives count in ``sharding.WIRE`` under
``param_gather``, ``grad_reduce_scatter`` and ``grad_all_reduce``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.distributed import sharding as shd


def drop_axes(spec: shd.Spec, keep: Sequence[str]) -> shd.Spec:
    """``spec`` without the axes ``keep``: the spec of a block that stays
    cut over them."""
    return tuple(shd.entry(a for a in shd._dim_axes(e) if a not in keep)
                 for e in spec)


def reduce_to_block(g: torch.Tensor, spec: shd.Spec, mesh: shd.Mesh,
                    batch: Sequence[str]) -> torch.Tensor:
    """This rank's block of the whole gradient ``g`` of a leaf of ``spec``,
    summed over the batch axes ``batch`` by the table above."""
    batch = set(batch)
    named = set()
    whole = g
    for d, entry in enumerate(spec):
        axes = [a for a in mesh.axes(shd._dim_axes(entry))
                if mesh.shape[a] > 1]
        if not axes:
            continue
        named.update(axes)
        sizes = [mesh.shape[a] for a in axes]
        x = g.unflatten(d, sizes + [g.shape[d] // math.prod(sizes)])
        for j in reversed(range(len(axes))):                    # case b
            if axes[j] not in batch:
                x = x.select(d + j, mesh.coordinate[axes[j]])
        red = [a for a in axes if a in batch]                   # case a
        if red:
            x = x.flatten(d, d + len(red) - 1).movedim(d, 0)
            x = shd.psum_scatter(x, tuple(red), mesh,
                                 kind="grad_reduce_scatter")
        g = x
    rest = tuple(a for a in mesh.axis_names                      # case c
                 if a in batch and a not in named and mesh.shape[a] > 1)
    if rest:
        g = shd.psum(g, rest, mesh, kind="grad_all_reduce")
    elif (g is not whole and g.untyped_storage().data_ptr()
          == whole.untyped_storage().data_ptr()):
        g = g.clone()           # a block cut from ``whole`` alone: not a view
    return g


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, spec, mesh, batch):
        ctx.spec, ctx.mesh, ctx.batch = spec, mesh, batch
        whole = shd.gather_shard(block, spec, mesh, kind="param_gather")
        return whole.view_as(whole) if whole is block else whole

    @staticmethod
    def backward(ctx, g):
        return (reduce_to_block(g, ctx.spec, ctx.mesh, ctx.batch), None,
                None, None)


def gather_param(block: torch.Tensor, named: Optional[shd.Named]
                 ) -> torch.Tensor:
    """The whole leaf from this rank's ``block`` of it (``named``: its
    ``sharding.Named``; ``None``: ``block`` is whole already); a spec
    without the axes the leaf is computed on leaves it cut over them (case
    b').  Under autograd the backward hands the block its gradient by the
    table above, with the batch axes current at the forward."""
    if named is None:
        return block
    if not (torch.is_grad_enabled() and block.requires_grad):
        return shd.gather_shard(block, named.spec, named.mesh,
                                kind="param_gather")
    return _GatherParam.apply(block, named.spec, named.mesh,
                              shd.batch_axes(named.mesh))


def gather_params(tree, named):
    """:func:`gather_param` over a tree of blocks and its tree of
    ``Named`` (``None``: the tree is whole; a leaf's spec without the axes
    it is computed on: ``tp.compute_named``)."""
    if named is None:
        return tree
    return shd.map_named(gather_param, tree, named)


def spec_axes(named: shd.Named) -> tuple:
    """The mesh axes of more than one rank that ``named``'s spec cuts, in
    mesh order."""
    mesh = named.mesh
    cut = {a for e in named.spec for a in mesh.axes(shd._dim_axes(e))}
    return tuple(a for a in mesh.axis_names if a in cut and mesh.shape[a] > 1)


def stored_bytes(tree) -> int:
    """The bytes of every tensor in a tree of dicts, lists, tuples and
    ``NamedTuple``s: a rank's storage of a tree of blocks."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(stored_bytes(v) for v in tree)
    return 0
