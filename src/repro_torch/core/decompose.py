"""MGARD-style multilevel interpolation decomposition (N-D, exact inverse).

A port of ``repro.core.decompose``.  Per level, per axis, odd samples are
predicted by linear interpolation of the even samples; the residuals are the
level's detail coefficients.  The transform is exactly invertible in float
arithmetic, so refactoring is lossless before bitplane truncation.

Bit-identity: XLA's CPU compiler computes the reference's ``xe + right`` on
its own, then fuses ``0.5 * (...)`` into the subtract (split) or add (merge)
that follows as one fused multiply-add, and flushes every subnormal result
to a zero of its sign (flush-to-zero; subnormal inputs read as zeros).  The
port computes the sum as its own torch op and flushes it, then forms the
fused result in float64 and flushes that (``_fma_half``), identically on the
CPU and the card.  Nothing is left to a device's own contraction (no
``torch.lerp``, ``addcmul`` or ``torch.compile`` here).  Without the
flushes, fields far below float32's normal range (``2**-100``) reconstruct
an ulp apart.

Error propagation (max-norm, conservative):
    |x - x_hat|_inf <= eps_corner + (2^D - 1) * sum_level eps_level
(+ a float32 roundoff slack), implemented by ``error_bound``.
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.align import flush_subnormal as _ftz


def _fma_half(d: torch.Tensor, s: torch.Tensor, half: float) -> torch.Tensor:
    """``d + half * s`` rounded once to float32 and flushed, as the fused
    multiply-add does: the product is never rounded or flushed on its own.
    ``half * s`` is exact in float64, and so is the sum wherever it can
    change the float32 result, so rounding to float64 then to float32 gives
    the fused result."""
    return _ftz(torch.add(d, s.double(), alpha=half).float())


def _split_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """One 1-D decomposition step along ``axis``: returns [even | detail]."""
    x = torch.movedim(x, axis, -1)
    xe = x[..., 0::2]
    xo = x[..., 1::2]
    ne, no = xe.shape[-1], xo.shape[-1]
    # right neighbor of odd i is even i+1 (duplicate edge when absent)
    right = xe[..., 1:no + 1] if ne > no else torch.cat(
        [xe[..., 1:], xe[..., -1:]], dim=-1)
    detail = _fma_half(xo, _ftz(xe[..., :no] + right), -0.5)
    out = torch.cat([xe, detail], dim=-1)
    return torch.movedim(out, -1, axis)


def _merge_axis(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """Inverse of `_split_axis` for an axis of original length ``n``.  Its
    inputs hold no subnormals (``align_decode`` flushes the decoded pieces,
    as the reference's does), so no operand is flushed here."""
    x = torch.movedim(x, axis, -1)
    ne = (n + 1) // 2
    no = n - ne
    xe, detail = x[..., :ne], x[..., ne:]
    right = xe[..., 1:no + 1] if ne > no else torch.cat(
        [xe[..., 1:], xe[..., -1:]], dim=-1)
    xo = _fma_half(detail, _ftz(xe[..., :no] + right), 0.5)
    out = torch.zeros(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    out[..., 0::2] = xe
    out[..., 1::2] = xo
    return torch.movedim(out, -1, axis)


def num_levels(shape: Sequence[int], min_size: int = 8, max_levels: int = 6) -> int:
    lv = 0
    dims = list(shape)
    while lv < max_levels and all(d >= 2 * min_size or d == 1 for d in dims):
        dims = [(d + 1) // 2 if d > 1 else 1 for d in dims]
        lv += 1
    return max(lv, 1)


def _coarse_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    # d == 0 stays 0 (empty axes stay empty); d == 1 stays 1
    return tuple((d + 1) // 2 if d > 1 else d for d in shape)


def _corner(cs: Tuple[int, ...]) -> Tuple[slice, ...]:
    return tuple(slice(0, c) for c in cs)


@functools.lru_cache(maxsize=64)
def _detail_mask(full_shape: Tuple[int, ...], device: torch.device
                 ) -> torch.Tensor:
    """Boolean mask (on ``device``) of every entry outside the coarse
    corner; row-major selection order equals the reference's
    ``np.nonzero`` index order."""
    mask = torch.ones(full_shape, dtype=torch.bool, device=device)
    mask[_corner(_coarse_shape(full_shape))] = False
    return mask


def decompose(x: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """x -> [corner, detail_L, detail_{L-1}, ..., detail_1], each flattened.

    detail_k is the detail coefficient set of level k (k=1 is the finest).
    The corner is the coarsest approximation."""
    x = x.to(torch.float32)
    pieces_rev: List[torch.Tensor] = []
    cur = _ftz(x)  # denormals-are-zero: the arithmetic reads them as zeros
    for _ in range(levels):
        shape = tuple(cur.shape)
        for ax in range(cur.dim()):
            if shape[ax] > 1:
                cur = _split_axis(cur, ax)
        cs = _coarse_shape(shape)
        corner = cur[_corner(cs)]
        detail = torch.masked_select(cur, _detail_mask(shape, cur.device))
        pieces_rev.append(detail)
        cur = corner
    # the corner is copied from x, never computed, so the reference keeps
    # its subnormals: every 2**levels-th sample along each axis
    corner = x[tuple(slice(None, None, 1 << levels) for _ in x.shape)]
    # order: [corner, detail_L (coarsest), ..., detail_1 (finest)]
    return [corner.reshape(-1)] + pieces_rev[::-1]


def level_shapes(shape: Sequence[int], levels: int) -> List[Tuple[int, ...]]:
    """Shapes of the working array at each level, finest first."""
    shapes = [tuple(shape)]
    for _ in range(levels):
        shapes.append(_coarse_shape(shapes[-1]))
    return shapes


# --------------------------------------------------- cached recompose plans --
#
# One level of the inverse transform -- scatter the coarse corner and the
# level's detail coefficients into the full grid, then merge every axis --
# only depends on the level's full shape, so the detail mask (a device
# tensor) and the merge function are cached per (shape, device).  The
# incremental engine (``core.reconstruct``) runs a *suffix* of the same
# per-level functions against cached intermediates, which keeps it
# bit-exact with the full pass.

@functools.lru_cache(maxsize=64)
def level_merge_fn(full_shape: Tuple[int, ...], device: torch.device):
    """``(coarse, detail) -> full`` merge for one level at ``full_shape``
    on ``device``, with the detail scatter mask precomputed there."""
    cs = _coarse_shape(full_shape)
    corner_sl = _corner(cs)
    mask = _detail_mask(full_shape, device)

    def merge(corner: torch.Tensor, detail: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(full_shape, dtype=corner.dtype, device=corner.device)
        out[corner_sl] = corner.reshape(cs)
        out.masked_scatter_(mask, detail.reshape(-1))
        full = out
        for ax in range(len(full_shape) - 1, -1, -1):
            if full_shape[ax] > 1:
                full = _merge_axis(full, ax, full_shape[ax])
        return full

    return merge


def recompose_plan(shape: Sequence[int], levels: int,
                   device: torch.device):
    """[(full_shape, merge fn)] for stages 1..levels (coarsest first):
    stage ``i`` merges detail piece ``i`` (pieces order: [corner, detail_L,
    ..., detail_1]) into the running coarse approximation."""
    shapes = level_shapes(shape, levels)  # [finest ... coarsest]
    dev = torch.device(device)
    return [(shapes[k - 1], level_merge_fn(shapes[k - 1], dev))
            for k in range(levels, 0, -1)]


def recompose(pieces: List[torch.Tensor], shape: Sequence[int],
              levels: int) -> torch.Tensor:
    """Inverse of `decompose`."""
    shapes = level_shapes(shape, levels)
    cur = pieces[0].reshape(shapes[-1])
    for i, (_, merge) in enumerate(recompose_plan(shape, levels,
                                                  cur.device)):
        cur = merge(cur, pieces[i + 1])
    return cur


def error_bound(eps_pieces: Sequence[float], ndim: int,
                data_amax: float = 0.0) -> float:
    """Max-norm reconstruction error bound from per-piece coefficient errors.

    eps_pieces = [eps_corner, eps_L, ..., eps_1] matching `decompose` output.
    ``data_amax`` adds a float32-roundoff slack for the forward+inverse
    transform itself: 2 * levels * ndim * 2^-24 * amax.
    """
    eps_corner, *eps_levels = [float(e) for e in eps_pieces]
    levels = len(eps_levels)
    slack = 2.0 * levels * ndim * (2.0 ** -24) * float(data_amax)
    factor = (1 << ndim) - 1
    return eps_corner + factor * float(np.sum(eps_levels)) + slack
