"""Tensor-parallel compute over 'model' on the blocks a rank stores.

The reference's specs cut some leaves over the mesh axis 'model' (the
logical axis ``"tp"``): GQA's query and output heads when the head count
divides 16, MLA's up-projections and output heads, the dense MLP's hidden
width, the experts, RWKV's channel-mix width, Mamba's inner width, and
the vocabulary of the embedding and the head when it divides 16.  GSPMD
computes on those blocks.  Here a step that holds blocks (``shardings=``)
does the same whenever 'model' does not cut the batch (:func:`context`;
``policy.batch_axes``, ``sharding.batch_axes``): such a leaf is gathered
over its other axes only (:func:`compute_named`: case b' of ``fsdp``'s
table) and the layer computes on its block.  A column-parallel matmul is
entered through :func:`enter` (identity forward, all-reduce backward:
Megatron's "f") and a row-parallel one left through :func:`leave`
(all-reduce forward, identity backward: "g"), so that every rank of
'model' ends with the whole gradient of the one loss they compute, as in
``sharding``'s differentiable collectives.  A row-parallel sum that every
rank's block then reads again (Mamba's low-rank delta, B and C) takes
both, :func:`summed`.
The rule holds at any size of 'model', one included, so a one-card run
goes through the same code.  Without blocks, or where 'model' cuts the
batch (the archs whose ``cell_policy`` folds it into data), every layer
computes on whole leaves as before.

Mamba's ``in_proj`` is cut over 'model' in contiguous blocks of the
concatenated ``[x, z]``, so a rank's stored block does not hold matching
halves of the two; :func:`recut` exchanges the blocks once a repeat
(``all_to_all`` over 'model') so that each rank holds its own channels of
both, and its backward sends each gradient back to the stored block.

A layer that does not compute on its blocks gathers them whole over
'model' itself (:func:`whole`, case b of ``fsdp``'s table: the ranks
repeat each other's compute).  Only RWKV's time mix does, and no config
cuts it (40 heads for rwkv6-3b; the spec cuts heads that divide 16).

The vocabulary-parallel pieces (:func:`vocab_embed`,
:func:`vocab_logsumexp`, :func:`vocab_gold`) compute the embedding and the
cross-entropy from a rank's block of the vocabulary; at one rank they give
the bits of the whole-vocabulary ops (``torch.logsumexp`` and its
backward, ``torch.gather``, indexing).  Every collective here counts in
``sharding.WIRE`` under ``tp_all_reduce``, ``tp_all_gather`` or
``tp_all_to_all``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding as shd

AXIS = "model"
REDUCE = "tp_all_reduce"
GATHER = "tp_all_gather"
ALL_TO_ALL = "tp_all_to_all"


def _first_named(shardings) -> Optional[shd.Named]:
    if shardings is None or isinstance(shardings, shd.Named):
        return shardings
    vals = shardings.values() if isinstance(shardings, dict) else shardings
    for v in vals:
        got = _first_named(v)
        if got is not None:
            return got
    return None


def context(shardings) -> Optional[shd.Mesh]:
    """The mesh whose 'model' axis the layers compute over, or ``None``:
    a tree of blocks (``shardings``, a tree of ``sharding.Named``) on a
    mesh with 'model', which the current batch axes do not name."""
    named = _first_named(shardings)
    if named is None:
        return None
    mesh = named.mesh
    if AXIS not in mesh.shape or AXIS in shd.batch_axes(mesh):
        return None
    return mesh


def cuts(named: Optional[shd.Named]) -> bool:
    """Whether ``named``'s spec cuts its leaf over 'model'."""
    return named is not None and any(AXIS in shd._dim_axes(e)
                                     for e in named.spec)


def compute_named(named, tp: Optional[shd.Mesh]):
    """A ``Named``, or a tree of them, with 'model' dropped from the specs
    under the context ``tp``, for ``fsdp.gather_param(s)``: the leaves
    reach the layers cut over 'model'."""
    if tp is None or named is None:
        return named
    if isinstance(named, shd.Named):
        return shd.Named(named.mesh, fsdp.drop_axes(named.spec, (AXIS,)))
    return {k: compute_named(v, tp) for k, v in named.items()}


def whole(p, abstract, tp: Optional[shd.Mesh]):
    """A layer's leaves ``p`` gathered whole over 'model' along the dims
    that its ``abstract`` (a dict of ``PSpec``) cuts over ``"tp"``, for a
    layer that computes on whole leaves: each rank keeps its block of the
    gradient (counted as ``param_gather``, as ``fsdp.gather_param``
    counts the other axes)."""
    if tp is None or tp.shape[AXIS] == 1:
        return p
    out = {}
    for k, x in p.items():
        for d, a in enumerate(abstract[k].axes):
            if a == "tp":
                x = shd.gather_from(x, AXIS, d, tp, "param_gather")
        out[k] = x
    return out


def lo(tp: shd.Mesh, local: int) -> int:
    """The first index of this rank's block of ``local`` entries."""
    return tp.index(AXIS) * local


def enter(x: torch.Tensor, tp: Optional[shd.Mesh]) -> torch.Tensor:
    """Into a region that each rank of 'model' computes in part (the
    identity; the backward sums the gradient over 'model')."""
    return x if tp is None else shd.copy_to(x, AXIS, tp, REDUCE)


def leave(x: torch.Tensor, tp: Optional[shd.Mesh]) -> torch.Tensor:
    """Out of such a region: the sum over 'model' of each rank's part."""
    return x if tp is None else shd.reduce_from(x, AXIS, tp, REDUCE)


def summed(x: torch.Tensor, tp: Optional[shd.Mesh]) -> torch.Tensor:
    """The sum over 'model' of each rank's part, read again by every
    rank's block: all-reduced forward and backward (:func:`leave`, then
    :func:`enter`), so that each part gets the gradient of every rank's
    reading, not of its own alone."""
    return enter(leave(x, tp), tp)


def gather(x: torch.Tensor, dim: int, tp: Optional[shd.Mesh]
           ) -> torch.Tensor:
    """Every rank's block along ``dim`` concatenated, whole on each."""
    return x if tp is None else shd.gather_from(x, AXIS, dim, tp, GATHER)


def own(x: torch.Tensor, dim: int, tp: Optional[shd.Mesh]) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x``, whole on every rank."""
    if tp is None:
        return x
    n = x.shape[dim] // tp.shape[AXIS]
    return x.narrow(dim, lo(tp, n), n)


def _exchange(rows: torch.Tensor, dests, srcs, tp: shd.Mesh
              ) -> torch.Tensor:
    """Two chunks of ``rows`` (its halves along dim 0) sent to the ranks
    ``dests`` of 'model', and the two chunks this rank gets back from the
    ranks ``srcs``, in the order of ``srcs``."""
    n, c = tp.shape[AXIS], rows.shape[0] // 2
    if dests[0] > dests[1]:
        rows = torch.cat([rows[c:], rows[:c]])
    got = shd.all_to_all(rows, AXIS, [c * dests.count(j) for j in range(n)],
                         [c * srcs.count(j) for j in range(n)], ALL_TO_ALL,
                         tp)
    return got if srcs[0] < srcs[1] else torch.cat([got[c:], got[:c]])


def _recut(w: torch.Tensor, tp: shd.Mesh, back: bool) -> torch.Tensor:
    """``w`` (d, 2c) from the stored block to ``[x_r, z_r]`` (``back``:
    the other way).  Of the 2n column chunks of ``[x, z]``, rank q stores
    2q and 2q + 1, and rank r computes on r (its ``x``) and n + r (its
    ``z``)."""
    n, r = tp.shape[AXIS], tp.index(AXIS)
    if n == 1:          # the identity, counted at 0 B
        return shd.all_to_all(w, AXIS, [w.shape[0]], [w.shape[0]],
                              ALL_TO_ALL, tp).view_as(w)
    stored = [(2 * r) % n, (2 * r + 1) % n]
    wanted = [r // 2, (n + r) // 2]
    dests, srcs = (wanted, stored) if back else (stored, wanted)
    return _exchange(w.t(), dests, srcs, tp).t()


class _Recut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, tp):
        ctx.tp = tp
        return _recut(w, tp, back=False)

    @staticmethod
    def backward(ctx, g):
        return _recut(g, ctx.tp, back=True), None


def recut(w: torch.Tensor, tp: Optional[shd.Mesh]) -> torch.Tensor:
    """Mamba's ``in_proj``, this rank's stored block (d, 2c) of the
    concatenated ``[x, z]`` (d, 2 x n x c), as this rank's ``c`` channels of
    ``x`` beside the same channels of ``z``: one ``all_to_all`` over
    'model', and one back in the backward (a view at one rank)."""
    return w if tp is None else _Recut.apply(w, tp)


def kv_heads(lo_q: int, n_q: int, group: int) -> slice:
    """The kv heads that the q heads ``[lo_q, lo_q + n_q)`` read (``group``
    q heads a kv head).  Either the rank's q heads are whole groups or
    they fall inside one group, so that ``flash_attention``'s grouping of
    the block is the whole layer's."""
    if n_q % group and group % n_q:
        raise ValueError(f"{n_q} q heads a rank and groups of {group} do "
                         f"not nest")
    return slice(lo_q // group, (lo_q + n_q - 1) // group + 1)


# -------------------------------------------------- vocabulary-parallel --

def _in_block(ids: torch.Tensor, n_local: int, tp: shd.Mesh):
    local = ids.long() - lo(tp, n_local)
    inside = (local >= 0) & (local < n_local)
    return local.clamp(0, n_local - 1), inside


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                tp: shd.Mesh, dtype) -> torch.Tensor:
    """Rows ``tokens`` of the embedding whose vocabulary block ``table``
    this rank holds, in ``dtype``: each rank looks up the tokens in its
    block, zeros the others, and the sum over 'model' (one nonzero term a
    row) is exact."""
    local, inside = _in_block(tokens, table.shape[0], tp)
    rows = table[local].to(dtype)
    return leave(torch.where(inside[..., None], rows, 0), tp)


class _VocabLSE(torch.autograd.Function):
    """``torch.logsumexp`` over a vocabulary cut over 'model': the
    maximum and the sum of exponentials reduced over the axis, the
    backward ``g * exp(logits - lse)`` on the block (the bits of
    ``torch.logsumexp``'s own at one rank)."""

    @staticmethod
    def forward(ctx, logits, tp):
        m = shd.pmax(torch.amax(logits, dim=-1, keepdim=True), AXIS, tp,
                     REDUCE)
        m = m.masked_fill(m.abs() == math.inf, 0)
        s = shd.psum(torch.sum(torch.exp(logits - m), dim=-1), AXIS, tp,
                     REDUCE)
        lse = torch.log(s) + m[..., 0]
        ctx.save_for_backward(logits, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        logits, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(logits - lse[..., None]), None


def vocab_logsumexp(logits: torch.Tensor, tp: shd.Mesh) -> torch.Tensor:
    """The log-sum-exp over the whole vocabulary of ``logits`` (..., V/n),
    this rank's block of it."""
    return _VocabLSE.apply(logits, tp)


def vocab_gold(logits: torch.Tensor, labels: torch.Tensor,
               tp: shd.Mesh) -> torch.Tensor:
    """Each position's logit at its label, from the blocks of the
    vocabulary (one rank holds it, the others add zero)."""
    local, inside = _in_block(labels, logits.shape[-1], tp)
    gold = torch.gather(logits, -1, local[..., None])[..., 0]
    return leave(torch.where(inside, gold, 0), tp)

