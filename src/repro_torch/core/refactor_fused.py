"""Fused write engine: the whole encode chain as one cached per-plan program.

A port of ``repro.core.refactor_fused``.  The reference compiles the chain
-- decompose -> exponent alignment / quantization -> bitplane encode ->
per-group byte blobs, plus the scalar pass (amax / range / per-piece
exponents) -- into ONE jitted program per chunk shape.  PyTorch runs
eagerly, so here the "program" is a cached per-plan Python function over
the same static plan:

  * pieces are padded with zeros to whole bitplane tiles (zero elements
    contribute zero bits — bit-identical to the kernels' own padding),
    bucketed by padded word count, and stacked;
  * each bucket's magnitudes and signs encode through ONE batched
    ``kernels.ops.encode_bitplanes_batch`` launch each (on the card: the
    CUDA kernel with a batch grid axis);
  * the plane stacks are sliced into merged groups and reinterpreted as
    stacked uint8 blob rows, which ``lossless_batch.encode_groups_stacked``
    consumes without re-slicing.

Per chunk that is one plan invocation (``STATS.dispatches``) and the same
three host syncs as the batched path: one for the scalar pass, two inside
the lossless engine.  ``finish_encode`` is separate from ``dispatch_encode``
so a pipeline can keep a chunk's device work in flight while the previous
chunk's host-side lossless selection runs.

Bit-exactness contract: serializations are byte-identical to the per-piece
paths (``refactor_array(fused=False)`` and ``batched=False``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tune as tn
from repro_torch.core import align as al
from repro_torch.core import decompose as dc
from repro_torch.core import lossless as ll
from repro_torch.core import lossless_batch as lb
from repro_torch.core import refactor as rf
from repro_torch.device import DeviceLike, as_float32
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


# ------------------------------------------------------------------- stats --

@dataclasses.dataclass
class FusedStats(obs_metrics.StatCounters):
    """Counters for the fused write engine (thread-safe, process-global).

    ``dispatches`` counts invocations of the cached per-plan program — the
    write path's budget is ONE per chunk.  ``plan_builds`` counts cache
    misses."""
    dispatches: int = 0
    finishes: int = 0
    plan_builds: int = 0
    pieces_encoded: int = 0


STATS = FusedStats()


# -------------------------------------------------------------------- plan --

def piece_sizes(shape: Sequence[int], levels: int) -> List[int]:
    """Element count of every decompose piece, statically from the shape.

    Matches ``decompose.decompose`` order: [corner, detail_L (coarsest),
    ..., detail_1]."""
    shapes = dc.level_shapes(shape, levels)  # [finest ... coarsest]
    prods = [int(np.prod(s, dtype=np.int64)) for s in shapes]
    return [prods[levels]] + [prods[k - 1] - prods[k]
                              for k in range(levels, 0, -1)]


@dataclasses.dataclass(frozen=True)
class _StackEntry:
    """One stacked blob family emitted by the plan: rows are the ``kind``
    ('sign' or 'group') blobs of the bucket's pieces."""
    kind: str
    group: int            # group index, -1 for sign
    piece_idxs: Tuple[int, ...]
    n_words: int


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    shape: Tuple[int, ...]
    levels: int
    design: str
    mag_bits: int
    group_planes: Tuple[int, ...]
    piece_ns: Tuple[int, ...]
    entries: Tuple[_StackEntry, ...]
    empty_pieces: Tuple[int, ...]
    run: Callable         # (x,) -> (exps, overflow, amax?, rng?, *stacks)
    has_scalars: bool     # amax/range present (x.numel() > 0)


def _bytes_rows(planes: torch.Tensor) -> torch.Tensor:
    """(B, P, W) uint32 plane stacks (int32 storage) -> (B, 4*P*W) uint8
    blob rows; row ``b`` is byte-for-byte ``refactor._device_bytes(
    planes[b])``."""
    b = planes.shape[0]
    return planes.contiguous().reshape(b, -1).view(torch.uint8)


# Cached like decompose.level_merge_fn: the live set is #distinct
# (chunk shape, levels, design) combinations of a workload.
@functools.lru_cache(maxsize=32)
def fused_encode_plan(shape: Tuple[int, ...], levels: int, design: str,
                      mag_bits: int, group_planes: Tuple[int, ...],
                      backend: str) -> FusedPlan:
    """Build (and cache) the encode program for a chunk shape.

    The returned plan's ``run(x)`` emits the per-piece exponent vector and
    magnitude-overflow flags (``align.overflows``), the amax/range scalars,
    and every stacked blob family of the chunk (sign planes + merged groups
    per size bucket), all on ``x``'s device."""
    STATS.add(plan_builds=1)
    piece_ns = tuple(piece_sizes(shape, levels))
    size = int(np.prod(shape, dtype=np.int64)) if shape else 1
    # bucket non-empty pieces by padded word count: same-padded pieces stack
    # exactly and share one batched encode launch
    buckets: Dict[int, List[int]] = {}
    for pi, n in enumerate(piece_ns):
        if n > 0:
            buckets.setdefault(kref.padded_words(n, design), []).append(pi)
    empty_pieces = tuple(pi for pi, n in enumerate(piece_ns) if n == 0)

    entries: List[_StackEntry] = []
    for w, idxs in buckets.items():
        entries.append(_StackEntry("sign", -1, tuple(idxs), w))
        for gi in range(len(group_planes)):
            entries.append(_StackEntry("group", gi, tuple(idxs), w))

    def run(x: torch.Tensor):
        x = x.to(torch.float32)
        pieces = dc.decompose(x, levels)
        exps = []
        mags: List[Optional[torch.Tensor]] = [None] * len(pieces)
        signs: List[Optional[torch.Tensor]] = [None] * len(pieces)
        for pi, piece in enumerate(pieces):
            mag, sign, e = al.align_encode(piece, mag_bits)
            exps.append(e)
            mags[pi], signs[pi] = mag, sign
        outs = [torch.stack(exps),
                torch.stack([al.overflows(m, mag_bits) for m in mags])]
        if size:
            outs.append(torch.max(torch.abs(x)))
            outs.append(torch.max(x) - torch.min(x))
        kw = dict(design=design, backend=backend, device=x.device)
        for w, idxs in buckets.items():
            n_pad = 32 * w
            mstack = torch.stack([torch.nn.functional.pad(
                mags[i], (0, n_pad - piece_ns[i])) for i in idxs])
            sstack = torch.stack([torch.nn.functional.pad(
                signs[i], (0, n_pad - piece_ns[i])) for i in idxs])
            planes = kops.encode_bitplanes_batch(mstack, mag_bits, **kw)
            sign_planes = kops.encode_bitplanes_batch(sstack, 1, **kw)
            outs.append(_bytes_rows(sign_planes))
            row = 0
            for g in group_planes:
                outs.append(_bytes_rows(planes[:, row:row + g, :]))
                row += g
        return tuple(outs)

    return FusedPlan(shape=tuple(shape), levels=levels, design=design,
                     mag_bits=mag_bits, group_planes=group_planes,
                     piece_ns=piece_ns, entries=tuple(entries),
                     empty_pieces=empty_pieces, run=run,
                     has_scalars=bool(size))


# ---------------------------------------------------------------- dispatch --

@dataclasses.dataclass
class PendingChunk:
    """One chunk's in-flight encode: device handles only, no syncs."""
    name: str
    plan: FusedPlan
    hybrid: ll.HybridConfig
    exps: torch.Tensor                    # (n_pieces,) int32
    overflow: torch.Tensor                # (n_pieces,) bool
    amax: Optional[torch.Tensor]          # None when the chunk is empty
    rng: Optional[torch.Tensor]
    stacks: Tuple[torch.Tensor, ...]      # (B, S) uint8 rows, plan.entries order
    backend: str = "auto"                 # the lossless passes' (cfg.backend)


def dispatch_encode(x, name: str = "var",
                    levels: Optional[int] = None,
                    design: Optional[str] = None,
                    mag_bits: Optional[int] = None,
                    hybrid: Optional[ll.HybridConfig] = None,
                    backend: Optional[str] = None,
                    config: Optional[tn.RefactorConfig] = None,
                    device: DeviceLike = None) -> PendingChunk:
    """Launch one chunk's whole encode chain through its cached plan.

    Returns with device handles; no host synchronization happens until
    ``finish_encode``.  All knobs normalize into ONE ``RefactorConfig``
    (explicit kwargs win), and the plan is keyed on the fields that shape
    the encode."""
    cfg = tn.as_config(config, design=design, mag_bits=mag_bits,
                       hybrid=hybrid, backend=backend)
    hybrid = cfg.hybrid(force=hybrid.force if hybrid is not None else None)
    mag_bits = cfg.resolved_mag_bits()
    x = as_float32(x, device)
    if levels is None:
        levels = dc.num_levels(tuple(x.shape))
    group_planes = tuple(rf._group_plane_split(mag_bits, hybrid.group_size))
    with obs_trace.span("encode.dispatch", name=name):
        plan = fused_encode_plan(tuple(x.shape), levels, cfg.design, mag_bits,
                                 group_planes, cfg.backend)
        outs = plan.run(x)
        STATS.add(dispatches=1, pieces_encoded=len(plan.piece_ns))
        obs_trace.event(obs_trace.EV_DISPATCH, kind="fused_encode", name=name,
                        pieces=len(plan.piece_ns))
    exps, overflow, rest = outs[0], outs[1], outs[2:]
    amax = rng = None
    if plan.has_scalars:
        amax, rng, rest = rest[0], rest[1], rest[2:]
    return PendingChunk(name=name, plan=plan, hybrid=hybrid, exps=exps,
                        overflow=overflow, amax=amax, rng=rng,
                        stacks=tuple(rest), backend=cfg.backend)


def finish_encode(p: PendingChunk, _scalars=None) -> rf.Refactored:
    """Resolve a dispatched chunk: ONE scalar sync, then the stacked
    lossless engine (two syncs), then host-side manifest assembly.

    ``_scalars`` lets a caller that already gathered the chunk's
    ``scalar_handles`` as host values skip the per-chunk sync."""
    STATS.add(finishes=1)
    with obs_trace.span("encode.finish", name=p.name):
        scalars = (lb.host_sync(scalar_handles(p), label="encode.scalars")
                   if _scalars is None else _scalars)
        segs_flat = lb.encode_groups_stacked(p.stacks, p.hybrid, p.backend)
        return _assemble(p, scalars, segs_flat)


def scalar_handles(p: PendingChunk):
    """The chunk's device scalars that its finish needs on the host:
    (exps, amax, rng, overflow flags)."""
    return (p.exps, p.amax, p.rng, p.overflow)


def stack_rows(p: PendingChunk) -> int:
    """Total blob rows ``p``'s stacks contribute to a flattened
    ``encode_groups_stacked`` call."""
    return sum(int(st.shape[0]) for st in p.stacks)


def finish_encode_many(pendings: Sequence[PendingChunk], _scalars=None
                       ) -> List[rf.Refactored]:
    """Resolve MANY dispatched chunks with batch-amortized host work: ONE
    scalar sync gathers every chunk's (exps, amax, range), and ONE stacked
    lossless pass encodes every chunk's blob rows — 3 host syncs for the
    batch instead of 3 per chunk.  Results come back in input order and are
    byte-identical to ``[finish_encode(p) for p in pendings]``.  Chunks
    with differing ``HybridConfig``s or backends are batched per config."""
    pendings = list(pendings)
    if not pendings:
        return []
    if _scalars is None:
        _scalars = lb.host_sync([scalar_handles(p) for p in pendings],
                                label="encode.scalars")
    STATS.add(finishes=len(pendings))
    out: List[Optional[rf.Refactored]] = [None] * len(pendings)
    by_cfg = lb.batch_jobs(pendings, lambda p: (
        p.hybrid.group_size, p.hybrid.size_threshold, p.hybrid.cr_threshold,
        p.hybrid.force, p.backend))
    with obs_trace.span("encode.finish_many", chunks=len(pendings)):
        for idxs in by_cfg.values():
            segs_flat = lb.encode_groups_stacked(
                [st for i in idxs for st in pendings[i].stacks],
                pendings[idxs[0]].hybrid, pendings[idxs[0]].backend)
            base = 0
            for i in idxs:
                n = stack_rows(pendings[i])
                out[i] = _assemble(pendings[i], _scalars[i],
                                   segs_flat[base:base + n])
                base += n
    return out


def _assemble(p: PendingChunk, scalars, segs_flat: List[ll.Segment]
              ) -> rf.Refactored:
    """Host-side manifest assembly for one finished chunk: scatter the
    chunk's flattened segment rows back to (piece, kind, group) slots and
    build the ``Refactored``."""
    plan = p.plan
    al.check_fits(scalars[3], plan.mag_bits, p.name)
    with obs_trace.span("encode.assemble", name=p.name):
        exps = [int(e) for e in scalars[0]]
        amax = float(scalars[1]) if p.amax is not None else 0.0
        rng = float(scalars[2]) if p.rng is not None else 0.0

        sign_segs: Dict[int, ll.Segment] = {}
        group_segs: Dict[Tuple[int, int], ll.Segment] = {}
        n_words: Dict[int, int] = {}
        base = 0
        for ent in plan.entries:
            for j, pi in enumerate(ent.piece_idxs):
                seg = segs_flat[base + j]
                if ent.kind == "sign":
                    sign_segs[pi] = seg
                    n_words[pi] = ent.n_words
                else:
                    group_segs[(pi, ent.group)] = seg
            base += len(ent.piece_idxs)
        dev = p.exps.device
        for pi in plan.empty_pieces:
            # empty pieces reproduce the per-piece encoders exactly: every
            # blob is zero-length, n_words is 0
            sign_segs[pi] = ll.compress_group(np.zeros(0, np.uint8), p.hybrid,
                                              device=dev, backend=p.backend)
            for gi in range(len(plan.group_planes)):
                group_segs[(pi, gi)] = ll.compress_group(
                    np.zeros(0, np.uint8), p.hybrid, device=dev,
                    backend=p.backend)
            n_words[pi] = 0

        ndim = len(plan.shape)
        group_planes = list(plan.group_planes)
        metas: List[rf.PieceMeta] = []
        for pi, n in enumerate(plan.piece_ns):
            groups = [group_segs[(pi, gi)] for gi in range(len(group_planes))]
            for g, seg in zip(group_planes, groups):
                seg.meta["n_planes"] = g
                seg.meta["n_words"] = n_words[pi]
            metas.append(rf.PieceMeta(
                n=n, exponent=exps[pi],
                weight=1.0 if pi == 0 else float((1 << ndim) - 1),
                sign_seg=sign_segs[pi], groups=groups,
                group_planes=group_planes))
        return rf.Refactored(name=p.name, shape=plan.shape,
                             levels=plan.levels, design=plan.design,
                             mag_bits=plan.mag_bits,
                             group_size=p.hybrid.group_size, data_amax=amax,
                             data_range=rng, pieces=metas)


def refactor_fused(x, name: str = "var", levels: Optional[int] = None,
                   design: Optional[str] = None,
                   mag_bits: Optional[int] = None,
                   hybrid: Optional[ll.HybridConfig] = None,
                   backend: Optional[str] = None,
                   config: Optional[tn.RefactorConfig] = None,
                   device: DeviceLike = None) -> rf.Refactored:
    """One-call fused refactor: ``finish_encode(dispatch_encode(...))``."""
    return finish_encode(dispatch_encode(
        x, name=name, levels=levels, design=design, mag_bits=mag_bits,
        hybrid=hybrid, backend=backend, config=config, device=device))
