"""Abstract parameter descriptions: one source of truth for init, analytic
parameter counts and the reference's parameter names.

A port of ``repro.models.params``.  A model's abstract tree is nested dicts
of :class:`PSpec`; ``tree_init`` materializes it on a device from an
explicit ``torch.Generator`` and ``params_from_reference`` carries the
reference's parameters (a tree of numpy arrays) across with the same names,
shapes and dtypes.  ``tree_partition_specs`` turns the logical sharding
axes into specs over the current mesh ('fsdp' -> ('pod', 'data'), 'tp' ->
'model'), and ``tree_shape_structs`` gives the leaves as ``meta`` tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd

Axis = Union[None, str, Tuple[str, ...]]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}

# values drawn at once by ``tree_init``: a leaf is drawn in float32 in
# pieces of this many and each piece is cast, so no leaf needs a float32
# temporary of its own size (deepseek-v2's stacked experts hold 3.77 B)
INIT_PIECE = 1 << 28


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Axis, ...]             # logical: 'fsdp' | 'tp' | None per dim
    init: str = "normal"               # normal | zeros | ones
    scale: float = 1.0                 # stddev multiplier (normal)
    dtype: Optional[str] = None        # override model param dtype

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the same
    nesting, their leaves passed alongside)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the reference's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _resolve_axis(a: Axis, drop_fsdp: bool = False):
    if a == "fsdp":
        return None if drop_fsdp else ("pod", "data")
    if a == "tp":
        return "model"
    return a


def pspec_to_partition(ps: PSpec, drop_fsdp: bool = False) -> shd.Spec:
    return shd.spec(*[_resolve_axis(a, drop_fsdp) for a in ps.axes])


def tree_partition_specs(tree, drop_fsdp: bool = False):
    """drop_fsdp=True gives serving-style TP-only sharding: weights live
    whole on each model shard."""
    return tree_map(lambda p: pspec_to_partition(p, drop_fsdp), tree)


def tree_shape_structs(tree, default_dtype: str):
    """The leaves as ``meta`` tensors of their shapes and dtypes."""
    return tree_map(lambda ps: torch.empty(
        ps.shape, dtype=DTYPES[ps.dtype or default_dtype], device="meta"),
        tree)


def _fan_in(ps: PSpec) -> int:
    return ps.shape[0] if len(ps.shape) > 1 else max(ps.shape[-1], 1)


def tree_init(tree, generator: torch.Generator, default_dtype: str,
              device: DeviceLike = None):
    """Materialize an abstract tree on ``device`` (``None`` means ``cuda``):
    zeros, ones, or normal x ``scale / sqrt(fan_in)`` (the reference's
    fan-in rule), drawn in float32 from ``generator`` leaf by leaf in the
    reference's flattening order, then cast to the leaf's dtype.  The
    generator must live on ``device``'s type."""
    dev = resolve_device(device)

    def init(ps: PSpec) -> torch.Tensor:
        dt = DTYPES[ps.dtype or default_dtype]
        if ps.init == "zeros":
            return torch.zeros(ps.shape, dtype=dt, device=dev)
        if ps.init == "ones":
            return torch.ones(ps.shape, dtype=dt, device=dev)
        std = ps.scale / math.sqrt(_fan_in(ps))
        out = torch.empty(ps.shape, dtype=dt, device=dev)
        flat = out.view(-1)
        for lo in range(0, flat.numel(), INIT_PIECE):
            n = min(INIT_PIECE, flat.numel() - lo)
            piece = torch.randn(n, generator=generator, device=dev,
                                dtype=torch.float32)
            flat[lo:lo + n] = piece.mul_(std)
        return out

    # draw in the flattening order, then rebuild the nesting
    return tree_unflatten(tree, [init(ps) for ps in tree_leaves(tree)])


def _rebuild(t, it):
    if isinstance(t, dict):
        return {k: _rebuild(t[k], it) for k in sorted(t)}
    return next(it)


def tree_unflatten(like, leaves):
    """``like``'s nesting with ``leaves`` (in ``tree_leaves`` order).  The
    recursion is a module-level function: a nested one refers to itself
    through its closure, and that cycle would keep the leaves alive until
    the garbage collector runs."""
    return _rebuild(like, iter(leaves))


def tree_param_count(tree) -> int:
    return sum(ps.size for ps in tree_leaves(tree))


def _leaf_tensor(x) -> torch.Tensor:
    """One numpy leaf of the reference as a CPU tensor of the same dtype.
    bfloat16 arrives as ``ml_dtypes``' numpy bfloat16 or as a ``uint16``
    view of its bits (no parameter is ever uint16)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if str(a.dtype) == "bfloat16" or a.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_reference(tree: Any, device: DeviceLike = None):
    """The reference's parameter tree (``Model.init``'s, as numpy) -> the
    port's, with the same names, shapes and dtypes, on ``device``
    (``None`` means ``cuda``)."""
    dev = resolve_device(device)
    return tree_map(lambda x: _leaf_tensor(x).to(dev), tree)
