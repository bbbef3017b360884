"""AdamW with dtype-configurable moment states, global-norm clipping and a
linear-warmup/cosine schedule.

A port of ``repro.optim.adamw``.  Trees are nested dicts of tensors (the
``Model.params`` layout); ``update`` is functional and returns new trees.
The moments share the parameters' specs (``state_partition_specs``).

Bit-identity with the reference's jitted ``update`` (XLA on the CPU), a
rule per op, each found against XLA's output:

* XLA contracts ``a * b + c`` into one fused multiply-add: the moments
  (``m * b1`` and ``v * b2`` are the products contracted for a float32
  state; for a bfloat16 state ``g * (1 - b1)`` and ``g**2 * (1 - b2)``,
  and the step reads ``v`` formed once more with ``v * b2`` contracted),
  the decoupled
  weight decay (``wd * p``), the parameter step (``lr * delta``) and the
  schedule's ``0.1 + 0.9 * cos``.  The port forms each in float64 and
  rounds once, which is the FMA's value (a float32 product is exact in
  float64; the second rounding can differ from a true FMA only when the
  float64 sum lands within 2**-53 of a float32 midpoint);
* XLA rewrites ``(a / b) / c`` into ``a / (b * c)`` (the bias-corrected
  first moment over the denominator) and a division by a constant into a
  product with its float32 reciprocal (the schedule);
* torch's CPU float32 ``sqrt`` is not correctly rounded; the square roots
  are taken in float64 and rounded once (``core/qoi.py`` does the same);
* XLA's CPU arithmetic flushes subnormals to zero; the update flushes
  explicitly (``core/align.py`` ``flush_subnormal``).

What stays apart: XLA reduces a leaf's sum of squares in an order of its
own; the port accumulates the global norm in float64, so under clipping
(``scale < 1``) the scaled gradient, and all after it, can differ in the
last bit.  XLA's CPU ``cos`` is glibc's ``cosf``, within an ulp of the
cosine the port rounds from float64, and XLA's ``pow`` differs from
torch's by an ulp at some arguments: so the learning rate and the bias
corrections can differ by an ulp at some steps (no step of the warmup,
where the cosine's argument is 0).  On the card the scalars are the
card's.

On blocks (a sharded step's trees, ``sharding.shard_tree``) the update is
the same elementwise pass; only the global norm must see every element
once: ``update(..., shardings=)`` sums each leaf's block in float64 over
the axes its spec cuts, and no others, before it adds up the leaves.

On the card (and on ``meta``) each leaf's update is one launch of the
``adamw_update`` kernel (``kernels.optim``), which computes ``_upd`` op for
op with the same roundings, and the global norm's sums of squares are one
``global_sumsq`` operator over every leaf, which reads each gradient once
and sums in a fixed order of its own (the same bits on every call; within
rounding of torch's order); on the CPU, or with ``backend="torch"``,
``_upd`` and the float64 chain (``_sumsq_plain``) run, their plain
versions.  The leaves' sums are added in leaf order either way.  The
schedule and the bias corrections are torch everywhere.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.align import flush_subnormal
from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import optim as _kopt
from repro_torch.models.params import (DTYPES, tree_leaves, tree_map,
                                       tree_unflatten)


class AdamWState(NamedTuple):
    step: torch.Tensor        # int32 scalar
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    state_dtype: str = "float32"


def init(params, cfg: AdamWConfig) -> AdamWState:
    """Zero moments in ``cfg.state_dtype`` beside each parameter, step 0 on
    the parameters' device."""
    dt = DTYPES[cfg.state_dtype]
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def state_partition_specs(param_specs) -> AdamWState:
    """The state's specs: the step replicated, each moment its
    parameter's."""
    return AdamWState(step=(), m=param_specs, v=param_specs)


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at float32 ``step``: linear warmup, then a cosine
    from 1 down to 0.1 of ``cfg.lr``."""
    dev = step.device
    inv_warm = _f32(1.0, dev) / max(cfg.warmup_steps, 1)
    inv_decay = _f32(1.0, dev) / max(cfg.total_steps - cfg.warmup_steps, 1)
    warm = torch.minimum(step * inv_warm, _f32(1.0, dev))
    prog = torch.clamp((step - cfg.warmup_steps) * inv_decay, 0.0, 1.0)
    # float32 argument, cosine in float64 rounded once (XLA calls cosf)
    cos = 0.5 * (1.0 + torch.cos((math.pi * prog).double()).float())
    return cfg.lr * warm * _fma(cos, _f32(0.9, dev).double(), _f32(0.1, dev))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64)."""
    return torch.sqrt(x.double()).float()


def _sumsq_plain(leaves):
    """Each leaf's sum of squares, a float64 copy squared and summed: the
    plain version of the ``global_sumsq`` kernel."""
    return [torch.sum(torch.square(g.double())) for g in leaves]


def global_norm(tree, shardings=None, backend: str = "auto") -> torch.Tensor:
    """The float32 norm of all leaves together, accumulated in float64.
    With ``shardings`` (the tree's ``sharding.Named`` by leaf) the leaves
    are this rank's blocks: each leaf's sum of squares is summed over the
    mesh axes its spec cuts (summing over an axis that holds it whole
    would count it once per rank), one all-reduce for each set of axes.
    ``backend``: ``"auto"`` takes each leaf's sum from the
    ``global_sumsq`` kernel on the card and on ``meta`` and from the
    float64 chain on the CPU; ``"torch"`` from the chain everywhere."""
    leaves = tree_leaves(tree)
    if leaves and _kopt.use_operators(leaves[0], backend):
        sums = list(_kopt.global_sumsq([g.contiguous() for g in leaves])
                    .unbind(0))
    else:
        sums = _sumsq_plain(leaves)
    if shardings is not None:
        by_axes = {}
        for i, n in enumerate(tree_leaves(shardings)):
            by_axes.setdefault(fsdp.spec_axes(n), []).append(i)
        mesh = tree_leaves(shardings)[0].mesh
        for axes, idx in by_axes.items():
            if axes:
                got = shd.psum(torch.stack([sums[i] for i in idx]), axes,
                               mesh).unbind(0)
                for i, s in zip(idx, got):
                    sums[i] = s
    total = sum(sums)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float64)).float()


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's contracted FMA."""
    return (a.double() * b + c.double()).float()


def _moment(old: torch.Tensor, b: float, x: torch.Tensor,
            old_product: bool) -> torch.Tensor:
    """``old * b + x * (1 - b)`` in float32, the product with the old
    moment contracted into the FMA, or else the other product."""
    bt = _f32(b, x.device)
    if old_product:
        return flush_subnormal(_fma(old.float(), bt.double(), x * (1 - b)))
    omb = _f32(1 - b, x.device)
    return flush_subnormal(_fma(x, omb.double(), old.float() * bt))


def _upd(p, g, m, v, scale, lr, c1, c2, cfg: AdamWConfig, sdt):
    g = flush_subnormal(g.float() * scale)
    g2 = flush_subnormal(torch.square(g))
    f32_state = sdt == torch.float32
    m32 = _moment(m, cfg.b1, g, f32_state)
    v32 = _moment(v, cfg.b2, g2, f32_state)
    # with a bfloat16 state XLA forms v once more for the step, in a fusion
    # of its own that contracts the other product
    v_step = v32 if f32_state else _moment(v, cfg.b2, g2, True)
    denom = flush_subnormal(c1 * (_sqrt(flush_subnormal(v_step / c2))
                                  + cfg.eps))
    p32 = p.float()
    delta = flush_subnormal(_fma(p32, _f32(cfg.weight_decay,
                                           g.device).double(),
                                 flush_subnormal(m32 / denom)))
    newp = flush_subnormal(_fma(delta, -lr.double(), p32))
    return newp.to(p.dtype), m32.to(sdt), v32.to(sdt)


def step_scalars(cfg: AdamWConfig, step: torch.Tensor, gnorm: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """The update's 0-d float32 device scalars at int32 ``step`` (1 for the
    first) and global norm ``gnorm``: the clip factor, the learning rate
    and the two bias corrections."""
    dev = gnorm.device
    scale = torch.minimum(_f32(1.0, dev),
                          cfg.clip_norm / torch.clamp_min(gnorm, 1e-9))
    stepf = step.float()
    lr = _schedule(cfg, stepf)
    c1 = 1 - torch.pow(_f32(cfg.b1, dev), stepf)
    c2 = 1 - torch.pow(_f32(cfg.b2, dev), stepf)
    return scale, lr, c1, c2


def update(grads, state: AdamWState, params, cfg: AdamWConfig,
           shardings=None, backend: str = "auto"
           ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: returns (new params, new state, {"grad_norm",
    "lr"}), all on the parameters' device.  ``shardings``: the parameters'
    ``sharding.Named`` by leaf when the trees hold this rank's blocks.
    ``backend``: ``"auto"`` updates each leaf with the ``adamw_update``
    kernel on the card and on ``meta`` and with ``_upd`` on the CPU, and
    takes the global norm's sums from ``global_sumsq`` where the update
    takes the kernel; ``"torch"`` uses ``_upd`` and the float64 chain
    everywhere."""
    if backend not in ("auto", "torch"):
        raise ValueError(f"backend must be 'auto' or 'torch', got "
                         f"{backend!r}")
    step = state.step + 1
    gnorm = global_norm(grads, shardings, backend)
    scale, lr, c1, c2 = step_scalars(cfg, step, gnorm)
    sdt = DTYPES[cfg.state_dtype]

    def leaf(p, g, m, v):
        if _kopt.use_operators(p, backend):
            return _kopt.adamw_update(
                p.contiguous(), g.contiguous(), m.contiguous(),
                v.contiguous(), scale, lr, c1, c2, cfg.b1, cfg.b2, cfg.eps,
                cfg.weight_decay)
        return _upd(p, g, m, v, scale, lr, c1, c2, cfg, sdt)
    outs = [leaf(p, g, m, v)
            for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                                  tree_leaves(state.m), tree_leaves(state.v))]
    pick = lambda i: tree_unflatten(params, [o[i] for o in outs])
    return (pick(0), AdamWState(step=step, m=pick(1), v=pick(2)),
            {"grad_norm": gnorm, "lr": lr})
