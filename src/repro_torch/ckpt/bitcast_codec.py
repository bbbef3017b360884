"""Exact progressive codec for tensors: IEEE-bitplane refactoring.

A port of ``repro.ckpt.bitcast_codec``.  A tensor is viewed as its integer
bit patterns and bitplane-encoded MSB-first (sign, exponent, mantissa).  A
*prefix* of planes is a truncated-mantissa approximation with bounded
RELATIVE error; the FULL set of planes restores the tensor BIT-EXACTLY:

  planes_kept >= 1 + n_exp + k   ->   relative error <= 2^-k
  (fp32: n_exp=8, 23 mantissa planes; bf16: n_exp=8, 7 mantissa planes)

Sign+exponent planes are always fetched together (min prefix 1+n_exp).  Plane
groups are compressed with Algorithm 2 (``core.lossless.compress_group``).
float64 (Miranda's dtype) is two 32-plane limbs: the hi limb (sign, 11
exponent bits, 20 mantissa bits) is the progressive prefix, the lo limb the
exact tail.

The planes go through ``kernels.ops.encode_bitplanes`` and
``decode_bitplanes``: on a CUDA tensor the ``design``'s kernels
(``rb_encode``/``rb_decode`` for ``register_block``), on a CPU tensor their
plain versions.  Numpy or torch input is encoded on ``device``, and
``exact_retrieve`` rebuilds on ``device`` (``None`` means ``cuda`` in both).

16-bit formats stay torch tensors throughout (``int16`` views of the bits,
widened with ``& 0xFFFF`` so that a negative value's sign does not reach
planes 16-31): bfloat16 has no numpy dtype without ``ml_dtypes``.  Blobs
name dtypes as numpy does (``float32``, ``bfloat16``, ...), so they are
byte-identical to the reference's, which they also read, whatever its
plane width (``n_words`` is taken from each group).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import lossless as ll
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.obs import trace as obs_trace

_FMT = {
    "float32": dict(bits=32, n_exp=8, view=torch.int32),
    "bfloat16": dict(bits=16, n_exp=8, view=torch.int16),
    "float16": dict(bits=16, n_exp=5, view=torch.int16),
    "int32": dict(bits=32, n_exp=31, view=torch.int32),  # exact only
    # fp64 (Miranda): 64 planes as two 32-plane limbs — the hi limb
    # (sign+11exp+20 mantissa) is the progressive prefix, the lo limb is the
    # exact tail fetched only for bit-exact restores / rel < 2^-20
    "float64": dict(bits=64, n_exp=11, view=torch.int64),
}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int32": torch.int32,
                "float64": torch.float64}


def dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype (``torch.bfloat16`` ->
    ``"bfloat16"``): the name the reference writes into blobs and
    manifests."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return str(np.dtype(dtype))


def as_tensor(x, device: DeviceLike = None) -> torch.Tensor:
    """numpy (``ml_dtypes`` bfloat16 included) or torch input -> a tensor
    of the same dtype on the resolved device."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    a = np.array(x)     # a copy: the tensor never aliases the caller's
    if str(a.dtype) == "bfloat16":   # ml_dtypes' numpy bfloat16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


@dataclasses.dataclass
class ExactRefactored:
    dtype: str
    shape: Tuple[int, ...]
    n_bits: int
    n_exp: int
    group_planes: List[int]
    groups: List[ll.Segment]

    @property
    def stored_bytes(self) -> int:
        return sum(g.stored_bytes for g in self.groups)

    def min_planes(self) -> int:
        return 1 + self.n_exp

    def planes_for_rel_error(self, rel: Optional[float]) -> int:
        if rel is None or rel <= 0:
            return self.n_bits
        k = max(int(np.ceil(-np.log2(rel))), 0)
        return min(self.min_planes() + k, self.n_bits)


def _limbs(x: torch.Tensor, bits: int) -> List[torch.Tensor]:
    """The (n,) uint32 bit patterns (int32 storage) to encode, MSB limb
    first.  A float64 is split by a view as two 32-bit words (little-endian:
    the low word first), so no signed 64-bit shift is involved."""
    flat = x.reshape(-1).contiguous()
    if bits == 64:
        words = flat.view(torch.int32).reshape(-1, 2)
        return [words[:, 1].contiguous(), words[:, 0].contiguous()]
    raw = flat.view(_FMT[dtype_name(x.dtype)]["view"])
    if bits == 16:
        return [(raw.to(torch.int32) & 0xFFFF)]
    return [raw]


def exact_refactor(x, hybrid: ll.HybridConfig = ll.HybridConfig(),
                   design: str = "register_block", backend: str = "auto",
                   device: DeviceLike = None) -> ExactRefactored:
    """Refactor ``x`` (numpy or torch) into plane groups, encoded on
    ``device`` (``None`` means ``cuda``)."""
    x = as_tensor(x, device)
    dt = dtype_name(x.dtype)
    fmt = _FMT[dt]
    bits = fmt["bits"]
    with obs_trace.span("ckpt.encode_planes", n=x.numel(), bits=bits):
        planes = torch.cat([kops.encode_bitplanes(limb, min(bits, 32), design,
                                                  backend, device=x.device)
                            for limb in _limbs(x, bits)], dim=0)
        planes_np = planes.cpu().numpy()
    group_planes: List[int] = []
    left = bits
    while left:
        g = min(hybrid.group_size, left)
        group_planes.append(g)
        left -= g
    groups = []
    row = 0
    with obs_trace.span("ckpt.compress", groups=len(group_planes)):
        for g in group_planes:
            blob = planes_np[row:row + g].reshape(-1).view(np.uint8)
            seg = ll.compress_group(blob, hybrid, device=x.device,
                                    backend=backend)
            seg.meta["n_planes"] = g
            seg.meta["n_words"] = int(planes_np.shape[1])
            groups.append(seg)
            row += g
    return ExactRefactored(dtype=dt, shape=tuple(x.shape), n_bits=bits,
                           n_exp=fmt["n_exp"], group_planes=group_planes,
                           groups=groups)


def exact_retrieve(r: ExactRefactored, rel_error: Optional[float] = None,
                   design: str = "register_block", backend: str = "auto",
                   device: DeviceLike = None) -> Tuple[torch.Tensor, int]:
    """Reconstruct to <= rel_error (None = bit-exact) on ``device``.
    Returns (tensor of the original dtype, bytes_read)."""
    dev = resolve_device(device)
    want = max(r.planes_for_rel_error(rel_error), r.min_planes())
    rows, got, nbytes = [], 0, 0
    with obs_trace.span("ckpt.decompress", n_bits=r.n_bits, want=want):
        for g, seg in zip(r.group_planes, r.groups):
            if got >= want:
                break
            w = seg.meta["n_words"]
            rows.append(ll.decompress_group(seg, device=dev, backend=backend)
                        .view(np.int32).reshape(-1, w))
            nbytes += seg.stored_bytes
            got += g
        planes = torch.from_numpy(np.concatenate(rows, axis=0)).to(dev)
    with obs_trace.span("ckpt.decode_planes", rows=got):
        out = _decode(r, planes, design, backend, dev)
    return out.reshape(r.shape), nbytes


def _decode(r: ExactRefactored, planes: torch.Tensor, design: str,
            backend: str, dev: torch.device) -> torch.Tensor:
    """Plane rows -> the flat tensor of ``r``'s dtype (rows past the
    fetched prefix read as zeros)."""
    n = int(np.prod(r.shape)) if r.shape else 1
    if r.n_bits == 64:
        p = planes.shape[0]
        hi = kops.decode_bitplanes(planes[:min(p, 32)], 32, n, design,
                                   backend, device=dev)
        lo = (kops.decode_bitplanes(planes[32:], 32, n, design, backend,
                                    device=dev)
              if p > 32 else torch.zeros_like(hi))
        out = torch.stack((lo, hi), dim=1).view(torch.float64)
    else:
        raw = kops.decode_bitplanes(planes, r.n_bits, n, design, backend,
                                    device=dev)
        if r.n_bits == 16:
            # [0, 2**16) -> the int16 of the same bits, in range, so exact
            raw = (raw - ((raw & 0x8000) << 1)).to(torch.int16)
        out = raw.view(TORCH_DTYPES[r.dtype])
    return out


# ------------------------------------------------------------ serialization --

def exact_to_bytes(r: ExactRefactored) -> bytes:
    parts = [struct.pack("<I", 0x4D445231)]
    db = r.dtype.encode()
    parts.append(struct.pack("<i", len(db)) + db)
    parts.append(struct.pack("<iii", r.n_bits, r.n_exp, len(r.shape)))
    if r.shape:
        parts.append(struct.pack(f"<{len(r.shape)}q", *r.shape))
    parts.append(struct.pack("<i", len(r.groups)))
    for g, gp in zip(r.groups, r.group_planes):
        gb = g.to_bytes()
        parts.append(struct.pack("<iq", gp, len(gb)) + gb)
    return b"".join(parts)


def exact_from_bytes(buf: bytes) -> ExactRefactored:
    off = 4
    (ld,) = struct.unpack_from("<i", buf, off)
    off += 4
    dtype = buf[off:off + ld].decode()
    off += ld
    n_bits, n_exp, nd = struct.unpack_from("<iii", buf, off)
    off += 12
    shape = struct.unpack_from(f"<{nd}q", buf, off) if nd else ()
    off += 8 * nd
    (ng,) = struct.unpack_from("<i", buf, off)
    off += 4
    groups, gp = [], []
    for _ in range(ng):
        g_planes, lg = struct.unpack_from("<iq", buf, off)
        off += struct.calcsize("<iq")
        groups.append(ll.Segment.from_bytes(buf[off:off + lg]))
        off += lg
        gp.append(g_planes)
    return ExactRefactored(dtype=dtype, shape=tuple(int(s) for s in shape),
                           n_bits=n_bits, n_exp=n_exp, group_planes=gp,
                           groups=groups)
