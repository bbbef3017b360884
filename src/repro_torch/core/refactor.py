"""End-to-end data refactoring (paper Fig 1, write path).

A port of ``repro.core.refactor``.  refactor_array:  x -> multilevel
decompose -> per-piece exponent alignment -> bitplane encode -> merged plane
groups -> Algorithm-2 hybrid lossless -> ``Refactored`` (segments +
manifest).  The manifest carries everything the reader needs for
error-controlled progressive retrieval.

Pieces are indexed [0]=coarsest corner, [1]=detail_L ... [levels]=detail_1,
matching ``decompose.decompose``.  Piece error weights for the max-norm bound
are w_0 = 1 (corner), w_k = 2^ndim - 1 (details) per ``decompose.error_bound``.

``refactor_array`` runs on ``device`` (``None`` means ``cuda``; see
``repro_torch.device``).  The wire format records no device and no backend:
``refactored_to_bytes`` is byte-identical whichever device and backend
encoded the array, and byte-identical to the reference package's.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import align as al
from repro_torch.core import decompose as dc
from repro_torch.core import lossless as ll
from repro_torch.core import lossless_batch as lb
from repro_torch.device import DeviceLike, as_float32
from repro_torch.kernels import ops as kops

_WIRE_MAGIC = 0x4D445230  # 'MDR0' single-blob wire format


@dataclasses.dataclass
class PieceMeta:
    n: int                      # elements in this piece
    exponent: int               # alignment exponent e  (max|x| <= 2**e)
    weight: float               # error weight in the recomposition bound
    sign_seg: ll.Segment
    groups: List[ll.Segment]    # MSB-first merged plane groups
    group_planes: List[int]     # planes per group (last may be short)

    @property
    def mag_bits(self) -> int:
        return sum(self.group_planes)


@dataclasses.dataclass
class Refactored:
    """Refactored representation of one array ('variable')."""
    name: str
    shape: Tuple[int, ...]
    levels: int
    design: str
    mag_bits: int
    group_size: int
    data_amax: float
    data_range: float
    pieces: List[PieceMeta]

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape))

    @property
    def stored_bytes(self) -> int:
        return sum(p.sign_seg.stored_bytes + sum(g.stored_bytes for g in p.groups)
                   for p in self.pieces)

    # -- error model -------------------------------------------------------
    def piece_eps(self, piece: int, planes_kept: int) -> float:
        pm = self.pieces[piece]
        if pm.n == 0:
            return 0.0  # no coefficients -> no truncation error contribution
        return al.truncation_error(pm.exponent, planes_kept, self.mag_bits)

    def bound(self, planes_per_piece: Sequence[int]) -> float:
        eps = [self.piece_eps(i, p) for i, p in enumerate(planes_per_piece)]
        return dc.error_bound(eps, ndim=len(self.shape), data_amax=self.data_amax)


def _group_plane_split(mag_bits: int, group_size: int) -> List[int]:
    group_planes: List[int] = []
    left = mag_bits
    while left > 0:
        g = min(group_size, left)
        group_planes.append(g)
        left -= g
    return group_planes


def _device_bytes(planes: torch.Tensor) -> torch.Tensor:
    """(P, W) uint32 planes (int32 storage) -> flat uint8 blob, on device.

    ``view(torch.uint8)`` of a contiguous 32-bit tensor is the little-endian
    byte order ``np.asarray(planes).reshape(-1).view(np.uint8)`` sees."""
    return planes.contiguous().reshape(-1).view(torch.uint8)


def refactor_array(
    x,
    name: str = "var",
    levels: Optional[int] = None,
    design: Optional[str] = None,
    mag_bits: Optional[int] = None,
    hybrid: Optional[ll.HybridConfig] = None,
    backend: Optional[str] = None,
    batched: bool = True,
    fused: Optional[bool] = None,
    config=None,
    device: DeviceLike = None,
) -> Refactored:
    """Refactor one array (numpy or torch) on ``device``.

    With ``fused=True`` (the default when ``batched``) the whole encode
    chain runs through ``refactor_fused``: one batched kernel launch per
    padded-size bucket for magnitudes and one for signs.  ``fused=False,
    batched=True`` is the piece-at-a-time device-resident path;
    ``batched=False`` the original per-group path.  All three produce
    byte-identical serializations — the slower paths stay as bit-exactness
    oracles — and all honor the same effective ``RefactorConfig``
    (``config=`` or legacy kwargs; explicit kwargs win)."""
    from repro_torch import tune as tn  # local: keep import graph flat
    cfg = tn.as_config(config, design=design, mag_bits=mag_bits,
                       hybrid=hybrid, backend=backend)
    force = hybrid.force if hybrid is not None else None
    design, mag_bits = cfg.design, cfg.resolved_mag_bits()
    hybrid, backend = cfg.hybrid(force=force), cfg.backend
    if fused is None:
        fused = batched
    elif fused and not batched:
        raise ValueError("fused=True requires batched=True: the fused engine "
                         "replaces the batched path, not the per-group oracle")
    x = as_float32(x, device)
    if fused and batched:
        from repro_torch.core import refactor_fused as rff  # no import cycle
        return rff.refactor_fused(x, name=name, levels=levels,
                                  hybrid=hybrid, config=cfg,
                                  device=x.device)
    if levels is None:
        levels = dc.num_levels(tuple(x.shape))
    pieces = dc.decompose(x, levels)
    ndim = x.dim()
    group_planes = _group_plane_split(mag_bits, hybrid.group_size)
    kw = dict(backend=backend, device=x.device)

    if not batched:
        return _refactor_array_pergroup(x, pieces, name, levels, design,
                                        mag_bits, hybrid, group_planes, ndim,
                                        kw)

    # -- device-resident batched path ---------------------------------------
    # Stage every piece's planes + per-group blobs on device; collect the
    # scalar outputs (amax/range/exponents) and pull them in ONE host_sync.
    scalars: List[torch.Tensor] = []
    if x.numel():
        scalars.append(torch.max(torch.abs(x)))
        scalars.append(torch.max(x) - torch.min(x))
    blobs: List[torch.Tensor] = []       # canonical order: per piece sign,
    n_words_all: List[int] = []          # then MSB-first groups
    overflow: List[torch.Tensor] = []
    for piece in pieces:
        mag, sign, e = al.align_encode(piece, mag_bits)
        scalars.append(e)
        overflow.append(al.overflows(mag, mag_bits))
        planes = kops.encode_bitplanes(mag, mag_bits, design, **kw)
        sign_planes = kops.encode_bitplanes(sign, 1, design, **kw)
        n_words_all.append(int(planes.shape[1]))
        blobs.append(_device_bytes(sign_planes))
        row = 0
        for g in group_planes:
            blobs.append(_device_bytes(planes[row:row + g]))
            row += g
    host_scalars, host_overflow = lb.host_sync((scalars,
                                                torch.stack(overflow)))
    al.check_fits(host_overflow, mag_bits, name)
    host_scalars = list(host_scalars)
    if x.numel():
        amax = float(host_scalars.pop(0))
        rng = float(host_scalars.pop(0))
    else:
        amax = rng = 0.0
    exponents = [int(e) for e in host_scalars]

    segs = lb.encode_groups(blobs, hybrid, backend=backend)
    metas: List[PieceMeta] = []
    per_piece = 1 + len(group_planes)
    for pi, piece in enumerate(pieces):
        base = pi * per_piece
        sign_seg = segs[base]
        groups = segs[base + 1:base + per_piece]
        for g, seg in zip(group_planes, groups):
            seg.meta["n_planes"] = g
            seg.meta["n_words"] = n_words_all[pi]
        metas.append(PieceMeta(
            n=int(piece.shape[0]), exponent=exponents[pi],
            weight=1.0 if pi == 0 else float((1 << ndim) - 1),
            sign_seg=sign_seg, groups=groups, group_planes=group_planes))
    return Refactored(name=name, shape=tuple(x.shape), levels=levels,
                      design=design, mag_bits=mag_bits,
                      group_size=hybrid.group_size, data_amax=amax,
                      data_range=rng, pieces=metas)


def _refactor_array_pergroup(x, pieces, name, levels, design, mag_bits,
                             hybrid, group_planes, ndim, kw) -> Refactored:
    """Original per-(piece, group) path: one host round-trip per group.

    Kept as the bit-exactness oracle for the batched engine (and for
    debugging); produces byte-identical serializations."""
    amax = float(torch.max(torch.abs(x))) if x.numel() else 0.0
    rng = float(torch.max(x) - torch.min(x)) if x.numel() else 0.0
    dev = x.device
    metas: List[PieceMeta] = []
    for pi, piece in enumerate(pieces):
        mag, sign, e = al.align_encode(piece, mag_bits)
        if bool(al.overflows(mag, mag_bits)):
            al.check_fits([i == pi for i in range(len(pieces))], mag_bits,
                          name)
        planes = kops.encode_bitplanes(mag, mag_bits, design, **kw)
        sign_planes = kops.encode_bitplanes(sign, 1, design, **kw)
        sign_seg = ll.compress_group(
            _device_bytes(sign_planes).cpu().numpy(), hybrid, device=dev,
            backend=kw["backend"])
        groups: List[ll.Segment] = []
        row = 0
        planes_np = planes.cpu().numpy()
        for g in group_planes:
            blob = planes_np[row:row + g].reshape(-1).view(np.uint8)
            seg = ll.compress_group(blob, hybrid, device=dev,
                                    backend=kw["backend"])
            seg.meta["n_planes"] = g
            seg.meta["n_words"] = planes_np.shape[1]
            groups.append(seg)
            row += g
        metas.append(PieceMeta(
            n=int(piece.shape[0]), exponent=int(e),
            weight=1.0 if pi == 0 else float((1 << ndim) - 1),
            sign_seg=sign_seg, groups=groups, group_planes=group_planes))
    return Refactored(name=name, shape=tuple(x.shape), levels=levels,
                      design=design, mag_bits=mag_bits,
                      group_size=hybrid.group_size, data_amax=amax,
                      data_range=rng, pieces=metas)


# ------------------------------------------------------------ serialization --
#
# Two layers, so an on-disk store can address plane groups without
# re-encoding anything (repro.store.layout):
#
#   * ``iter_segments`` / ``Segment.to_bytes`` — the canonical segment stream
#     (per piece: sign, then MSB-first groups).  A store writes each blob at
#     its own offset and records (offset, size, method) per segment.
#   * ``refactored_meta`` / ``refactored_from_meta`` — the payload-free
#     header.  Rebuilding from it with stub segments yields a ``Refactored``
#     whose planner sees true stored sizes but holds no payload bytes.
#
# ``refactored_to_bytes`` / ``refactored_from_bytes`` (the single-blob wire
# format used by the pipelines) are thin compositions of the two layers.


def iter_segments(r: Refactored):
    """Yield (piece_idx, kind, group_idx, Segment) in canonical stream order.

    kind is 'sign' (group_idx = -1) or 'group' (group_idx = 0..G-1, MSB
    first).  This order is shared by ``refactored_to_bytes`` and the store
    layout, so offsets computed against it address the same bytes."""
    for pi, p in enumerate(r.pieces):
        yield pi, "sign", -1, p.sign_seg
        for gi, g in enumerate(p.groups):
            yield pi, "group", gi, g


def refactored_meta(r: Refactored) -> Dict:
    """JSON-able payload-free header: everything the retrieval planner and
    error model need, minus the segment payloads."""
    return {
        "name": r.name,
        "shape": list(r.shape),
        "levels": r.levels,
        "design": r.design,
        "mag_bits": r.mag_bits,
        "group_size": r.group_size,
        "amax": r.data_amax,
        "range": r.data_range,
        "pieces": [
            {
                "n": p.n,
                "exponent": p.exponent,
                "weight": p.weight,
                "n_words": int(p.groups[0].meta.get("n_words", 0))
                if p.groups else 0,
                "group_planes": list(p.group_planes),
            }
            for p in r.pieces
        ],
    }


def refactored_from_meta(meta: Dict, segments) -> Refactored:
    """Rebuild a ``Refactored`` from a payload-free header.

    ``segments(piece_idx, kind, group_idx) -> ll.Segment`` supplies each
    segment — either a real decoded segment or a stub carrying
    ``meta["stored_bytes"]`` (see ``ll.Segment.is_stub``)."""
    pieces = []
    for pi, pm in enumerate(meta["pieces"]):
        sign_seg = segments(pi, "sign", -1)
        groups = [segments(pi, "group", gi)
                  for gi in range(len(pm["group_planes"]))]
        pieces.append(PieceMeta(
            n=int(pm["n"]), exponent=int(pm["exponent"]),
            weight=float(pm["weight"]), sign_seg=sign_seg, groups=groups,
            group_planes=[int(g) for g in pm["group_planes"]]))
    return Refactored(
        name=meta["name"], shape=tuple(int(s) for s in meta["shape"]),
        levels=int(meta["levels"]), design=meta["design"],
        mag_bits=int(meta["mag_bits"]), group_size=int(meta["group_size"]),
        data_amax=float(meta["amax"]), data_range=float(meta["range"]),
        pieces=pieces)


def refactored_to_bytes(r: Refactored) -> bytes:
    head = {
        "name": r.name.encode(), "shape": r.shape, "levels": r.levels,
        "design": r.design.encode(), "mag_bits": r.mag_bits,
        "group_size": r.group_size, "amax": r.data_amax, "range": r.data_range,
    }
    parts = [struct.pack("<I", _WIRE_MAGIC)]
    nb = head["name"]; db = head["design"]
    parts.append(struct.pack("<i", len(nb)) + nb)
    parts.append(struct.pack("<i", len(db)) + db)
    parts.append(struct.pack("<iii", r.levels, r.mag_bits, r.group_size))
    parts.append(struct.pack("<dd", r.data_amax, r.data_range))
    parts.append(struct.pack("<i", len(r.shape)) + struct.pack(f"<{len(r.shape)}q", *r.shape))
    parts.append(struct.pack("<i", len(r.pieces)))
    for p in r.pieces:
        parts.append(struct.pack("<qid", p.n, p.exponent, p.weight))
        sb = p.sign_seg.to_bytes()
        parts.append(struct.pack("<q", len(sb)) + sb)
        parts.append(struct.pack("<i", len(p.groups)))
        for g, gp in zip(p.groups, p.group_planes):
            gb = g.to_bytes()
            parts.append(struct.pack("<iq", gp, len(gb)) + gb)
    return b"".join(parts)


def refactored_from_bytes(buf: bytes) -> Refactored:
    try:
        return _refactored_from_bytes(buf)
    except struct.error as exc:  # truncation must surface as ValueError too
        raise ValueError(f"corrupt refactored blob: truncated ({exc})") from exc


def _refactored_from_bytes(buf: bytes) -> Refactored:
    (magic,) = struct.unpack_from("<I", buf, 0)
    if magic != _WIRE_MAGIC:
        raise ValueError("corrupt refactored blob: bad magic")
    off = 4
    (ln,) = struct.unpack_from("<i", buf, off); off += 4
    name = buf[off:off + ln].decode(); off += ln
    (ld,) = struct.unpack_from("<i", buf, off); off += 4
    design = buf[off:off + ld].decode(); off += ld
    levels, mag_bits, group_size = struct.unpack_from("<iii", buf, off); off += 12
    amax, rng = struct.unpack_from("<dd", buf, off); off += 16
    (nd,) = struct.unpack_from("<i", buf, off); off += 4
    shape = struct.unpack_from(f"<{nd}q", buf, off); off += 8 * nd
    (npieces,) = struct.unpack_from("<i", buf, off); off += 4
    pieces = []
    for _ in range(npieces):
        n, e, w = struct.unpack_from("<qid", buf, off); off += struct.calcsize("<qid")
        (ls,) = struct.unpack_from("<q", buf, off); off += 8
        sign_seg = ll.Segment.from_bytes(buf[off:off + ls]); off += ls
        (ng,) = struct.unpack_from("<i", buf, off); off += 4
        groups, gp = [], []
        for _ in range(ng):
            g_planes, lg = struct.unpack_from("<iq", buf, off); off += struct.calcsize("<iq")
            groups.append(ll.Segment.from_bytes(buf[off:off + lg])); off += lg
            gp.append(g_planes)
        pieces.append(PieceMeta(n=n, exponent=e, weight=w, sign_seg=sign_seg,
                                groups=groups, group_planes=gp))
    return Refactored(name=name, shape=tuple(int(s) for s in shape),
                      levels=levels, design=design, mag_bits=mag_bits,
                      group_size=group_size, data_amax=amax, data_range=rng,
                      pieces=pieces)
