"""Device-resident incremental reconstruction engine (read path).

A port of ``repro.core.reconstruct``.  The read chain — bitplane expand ->
sign / scale -> multilevel recompose — is linear, so progressive refinement
costs only a *delta* decode of the newly fetched plane groups plus a partial
recompose:

  * ``mag``   — accumulated uint32 magnitudes (int32 storage).  Newly
    fetched plane groups are decoded *at their bit offsets*
    (``kernels.ops.decode_bitplanes_offset_batch``: on the card, the CUDA
    decode kernel) and OR-ed in; disjoint bit ranges make the accumulation
    exact, so the magnitudes are bit-identical to a full-stack decode.
  * ``sign``  — decoded once, with the piece's first group.
  * ``value`` — the align-decoded float32 coefficients, refreshed only for
    pieces whose magnitudes changed.
  * per-level recompose intermediates — ``reconstruct_device`` re-runs only
    the recompose *suffix* from the coarsest changed piece, through the
    cached per-(shape, device) merges of ``decompose.recompose_plan``.

Bit-exactness contract: the full-decode oracle (``ProgressiveReader(...,
incremental=False)``) and this engine run the same per-level merges on
bit-identical inputs, so both produce bit-identical reconstructions.

``batch_apply_pending`` drains the staged plane groups of many engines and
decodes every same-shaped (rows, words, n, offset, device) bucket through
ONE batched kernel launch.  Nothing here synchronizes with the host.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import align as al
from repro_torch.core import decompose as dc
from repro_torch.core import lossless_batch as lb
from repro_torch.core.refactor import Refactored
from repro_torch.device import DeviceLike, as_u32_bits, resolve_device
from repro_torch.obs import metrics as obs_metrics


# ------------------------------------------------------------------- stats --

@dataclasses.dataclass
class ReconStats(obs_metrics.StatCounters):
    """Counters for the incremental read path (thread-safe, process-global).

    ``bytes_decoded`` counts DELTA plane bytes actually run through the
    bitplane decoder; ``levels_reused`` counts recompose stages served from
    the level cache instead of being recomputed."""
    groups_staged: int = 0
    rows_decoded: int = 0
    bytes_decoded: int = 0
    delta_decode_batches: int = 0
    sign_decode_batches: int = 0
    recompose_calls: int = 0
    levels_merged: int = 0
    levels_reused: int = 0
    cache_hits: int = 0


STATS = ReconStats()


@dataclasses.dataclass
class _PendingRows:
    """Staged, not-yet-decoded plane rows of one piece (device-resident)."""
    piece: int
    rows: torch.Tensor     # (P', W) uint32 bits, MSB-first slice
    row_offset: int        # rows already decoded into the piece's magnitudes


class IncrementalReconstructor:
    """Per-variable(-chunk) device-resident incremental reconstruction state.

    Fed by a ``ProgressiveReader``: ``stage_rows``/``stage_sign`` upload newly
    fetched plane groups, ``reconstruct_device`` returns the up-to-date
    reconstruction as a tensor on ``device`` (``None`` means ``cuda``)."""

    def __init__(self, ref: Refactored, backend: str = "auto",
                 device: DeviceLike = None):
        self.ref = ref
        self.backend = backend
        self.device = resolve_device(device)
        # delta plane bytes decoded into THIS engine (STATS aggregates)
        self.bytes_decoded = 0
        n_pieces = len(ref.pieces)
        self._mag: List[Optional[torch.Tensor]] = [None] * n_pieces
        self._sign: List[Optional[torch.Tensor]] = [None] * n_pieces
        self._value: List[Optional[torch.Tensor]] = [None] * n_pieces
        self._kept: List[int] = [0] * n_pieces     # planes decoded into _mag
        self._dirty: set = set()
        self._pending: List[_PendingRows] = []
        self._pending_sign: List[Tuple[int, torch.Tensor]] = []
        # recompose level cache: _levels[0] = reshaped corner, _levels[i] =
        # state after merging detail piece i; x_hat = _levels[levels]
        self._levels: Optional[List[torch.Tensor]] = None

    # ------------------------------------------------------------- staging --
    def stage_sign(self, piece: int, rows) -> None:
        """(1, W) uint32 sign plane of a piece's first fetch."""
        if self.ref.pieces[piece].n == 0:
            return
        self._pending_sign.append((piece, as_u32_bits(rows, self.device)))

    def stage_rows(self, piece: int, rows, row_offset: int) -> None:
        """(P', W) uint32 plane rows sitting ``row_offset`` rows into the
        piece's MSB-first stack.  Upload only; decode happens batched."""
        if self.ref.pieces[piece].n == 0 or rows.shape[0] == 0:
            return
        self._pending.append(_PendingRows(
            piece, as_u32_bits(rows, self.device), row_offset))
        STATS.add(groups_staged=1)

    def _take_pending(self) -> List[_PendingRows]:
        out, self._pending = self._pending, []
        return out

    def _take_pending_sign(self) -> List[Tuple[int, torch.Tensor]]:
        out, self._pending_sign = self._pending_sign, []
        return out

    def _apply_mag(self, piece: int, mag_delta: torch.Tensor,
                   n_rows: int) -> None:
        cur = self._mag[piece]
        self._mag[piece] = (mag_delta if cur is None
                            else torch.bitwise_or(cur, mag_delta))
        self._kept[piece] += n_rows
        self._dirty.add(piece)

    def _apply_sign(self, piece: int, sign: torch.Tensor) -> None:
        self._sign[piece] = sign
        self._dirty.add(piece)

    # -------------------------------------------------------- reconstruction --
    def _piece_value(self, pi: int) -> torch.Tensor:
        v = self._value[pi]
        if v is None:
            v = torch.zeros((self.ref.pieces[pi].n,), dtype=torch.float32,
                            device=self.device)
            self._value[pi] = v
        return v

    def reconstruct_device(self) -> torch.Tensor:
        """Current reconstruction as a device tensor (shape ``ref.shape``).

        Decodes any still-pending plane groups (batched), align-decodes only
        the changed pieces, and re-runs only the recompose suffix below the
        coarsest changed piece; a clean engine returns the cached tensor."""
        if self._pending or self._pending_sign:
            batch_apply_pending([self])
        r = self.ref
        if not self._dirty and self._levels is not None:
            STATS.add(cache_hits=1)
            return self._levels[r.levels]
        for pi in self._dirty:
            pm = r.pieces[pi]
            if self._kept[pi] == 0 or pm.n == 0:
                continue
            self._value[pi] = al.align_decode(
                self._mag[pi], self._sign[pi], pm.exponent,
                r.mag_bits, planes_kept=self._kept[pi])
        plan = dc.recompose_plan(r.shape, r.levels, self.device)
        if self._levels is None or 0 in self._dirty:
            shapes = dc.level_shapes(r.shape, r.levels)
            self._levels = [self._piece_value(0).reshape(shapes[-1])
                            ] + [None] * r.levels
            start = 1
        else:
            start = min(self._dirty)
        for i in range(start, r.levels + 1):
            _, merge = plan[i - 1]
            self._levels[i] = merge(self._levels[i - 1], self._piece_value(i))
        STATS.add(recompose_calls=1, levels_merged=r.levels - start + 1,
                  levels_reused=start - 1)
        self._dirty.clear()
        return self._levels[r.levels]


# ------------------------------------------------- cross-engine batched decode

def batch_apply_pending(engines: Sequence[IncrementalReconstructor]) -> None:
    """Drain and decode the staged plane groups of many engines.

    All staged (rows, words, n, row_offset, device)-compatible groups decode
    through ONE batched ``decode_bitplanes_offset_batch`` launch per bucket;
    sign planes batch the same way.  Decoded magnitudes are OR-accumulated
    into each engine's device state; no host sync happens here."""
    from repro_torch.kernels import ops as kops  # local: flat import graph

    jobs: List[Tuple[IncrementalReconstructor, _PendingRows]] = [
        (e, p) for e in engines for p in e._take_pending()]
    sign_jobs: List[Tuple[IncrementalReconstructor, int, torch.Tensor]] = [
        (e, pi, rows) for e in engines
        for pi, rows in e._take_pending_sign()]

    def key(job):
        e, p = job
        # the engine's device is part of the bucket: a stacked decode never
        # mixes devices, so each launch runs where its engine state lives
        return (int(p.rows.shape[0]), int(p.rows.shape[1]), p.row_offset,
                e.ref.pieces[p.piece].n, e.ref.mag_bits, e.ref.design,
                e.backend, e.device)

    for k, pos in lb.batch_jobs(jobs, key).items():
        n_rows, _, offset, n, mag_bits, design, backend, dev = k
        batch = [jobs[p] for p in pos]
        stacked = torch.stack([p.rows for _, p in batch])
        mags = kops.decode_bitplanes_offset_batch(
            stacked, mag_bits, n, offset, design, backend=backend, device=dev)
        row_bytes = 4 * n_rows * int(stacked.shape[2])
        STATS.add(delta_decode_batches=1, rows_decoded=n_rows * len(batch),
                  bytes_decoded=row_bytes * len(batch))
        for j, (e, p) in enumerate(batch):
            e.bytes_decoded += row_bytes
            e._apply_mag(p.piece, mags[j], n_rows)

    def sign_key(job):
        e, pi, rows = job
        return (int(rows.shape[1]), e.ref.pieces[pi].n, e.ref.design,
                e.backend, e.device)

    for k, pos in lb.batch_jobs(sign_jobs, sign_key).items():
        _, n, design, backend, dev = k
        batch = [sign_jobs[p] for p in pos]
        stacked = torch.stack([rows for _, _, rows in batch])
        sgs = kops.decode_bitplanes_batch(stacked, 1, n, design,
                                          backend=backend, device=dev)
        # sign planes count toward the delta bytes: the full-decode baseline
        # (ProgressiveReader.decoded_plane_bytes) includes them too
        row_bytes = 4 * int(stacked.shape[2])
        STATS.add(sign_decode_batches=1, rows_decoded=len(batch),
                  bytes_decoded=row_bytes * len(batch))
        for j, (e, pi, _) in enumerate(batch):
            e.bytes_decoded += row_bytes
            e._apply_sign(pi, sgs[j])
