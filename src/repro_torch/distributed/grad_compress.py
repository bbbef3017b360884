"""Progressive gradient compression (the paper's encoder on the wire).

A port of ``repro.distributed.grad_compress``.  Two pieces:

1. ``compressed_psum``: a mean over a mesh axis that transmits only the top
   ``planes`` bitplanes in its gather phase:
       reduce_scatter(fp32) -> exponent-align -> bitplane encode ->
       all_gather(packed planes, (1 + planes)/32 of the bytes) -> decode
   It runs on each rank (the reference's ``shard_map`` body) and returns
   (result, this rank's truncation residual) for error feedback;
2. ``ef_quantize``: error-feedback bitplane truncation for the optimizer
   path (a gradient truncated to its sign and top ``planes`` magnitude
   planes, the truncation error carried to the next step).

The planes are in the ``register_block`` format.  ``compressed_psum``'s
planes cross the wire: on a CUDA tensor they go through the
``rb_encode``/``rb_decode`` kernels (``kernels.ops``, backend ``auto``).
``ef_quantize`` keeps no planes: on a CUDA (or ``meta``) tensor it is the
``ef_amax`` and ``ef_apply`` kernels (``kernels.optim``), one pass for the
leaf's maximum and one that quantizes it, bit-identical to encoding and
decoding the planes; on the CPU, or with ``backend="torch"``, it encodes
and decodes them with the plain bitplane versions (its plain path).

Bit-identity with the reference (XLA on the CPU): the scale is the
reference's inexact ``exp2(MAG_BITS - e)`` (``core/align.py``'s table),
``torch.round`` rounds half to even like ``jnp.round``, the float ->
uint32 conversion saturates like XLA's, and subnormal inputs, sums and
decoded values are flushed to zero as XLA's CPU arithmetic flushes them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.align import _sat_u32, exp2_int, flush_subnormal
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import optim as _kopt
from repro_torch.kernels.ops import decode_bitplanes_batch, encode_bitplanes

MAG_BITS = 23  # exact fp32 quantization bound (see core/align.py)
_U32 = 0xFFFFFFFF


def _encode_planes(x: torch.Tensor, planes: int, backend: str = "auto"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 vector -> (packed sign plane + top ``planes`` magnitude
    planes, (1 + planes, W) uint32 words in int32 storage; exponent e, an
    int32 scalar)."""
    x = flush_subnormal(x)
    amax = torch.max(torch.abs(x))
    _, e = torch.frexp(amax)
    e = torch.where(amax > 0, e, torch.zeros_like(e)).to(torch.int32)
    q = torch.round(x * exp2_int(MAG_BITS - e))
    sign = (q < 0).to(torch.int32)
    # keep only the top `planes` magnitude bits before encoding
    mag_top = ((_sat_u32(torch.abs(q)).to(torch.int64) & _U32)
               >> (MAG_BITS - planes)).to(torch.int32)
    mag_planes = encode_bitplanes(mag_top, planes, "register_block", backend,
                                  device=x.device)
    sign_plane = encode_bitplanes(sign, 1, "register_block", backend,
                                  device=x.device)
    return torch.cat([sign_plane, mag_planes], dim=0), e


def _decode_planes(packed: torch.Tensor, e: torch.Tensor, n: int,
                   planes: int, backend: str = "auto") -> torch.Tensor:
    """``_encode_planes``'s planes -> the float32 values they keep, each
    magnitude at the midpoint of its truncated tail."""
    return _decode_planes_batch(packed[None], e.reshape(1), n, planes,
                                backend)[0]


def _decode_planes_batch(packed: torch.Tensor, e: torch.Tensor, n: int,
                         planes: int, backend: str = "auto") -> torch.Tensor:
    """(B, 1 + planes, W) planes and their B exponents -> (B, n) values:
    one decode launch for the B sign planes and one for the B magnitude
    plane sets."""
    dev = packed.device
    sign = decode_bitplanes_batch(packed[:, :1], 1, n, "register_block",
                                  backend, device=dev)
    mag = decode_bitplanes_batch(packed[:, 1:], planes, n, "register_block",
                                 backend, device=dev).to(torch.int64) & _U32
    tail = MAG_BITS - planes
    mag = mag << tail
    if tail > 0:
        mag = mag + (1 << (tail - 1))  # midpoint decode
    scale = exp2_int(MAG_BITS - e.reshape(-1, 1))
    val = flush_subnormal(mag.to(torch.float32) / scale)
    return torch.where(sign != 0, -val, val)


def ef_quantize(x: torch.Tensor, residual: torch.Tensor, planes: int,
                backend: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Bitplane-truncate ``x + residual`` to ``planes`` (1 .. 23) magnitude
    planes; returns (q, new residual), float32 tensors of ``x``'s shape on
    its device.  ``backend`` ``"auto"``/``"cuda"``: the ``ef_amax`` and
    ``ef_apply`` kernels on a CUDA or ``meta`` tensor; the CPU and
    ``"torch"``: the planes' plain path."""
    if not 1 <= planes <= MAG_BITS:
        raise ValueError(f"planes must be in 1..{MAG_BITS}, got {planes}")
    if _kopt.use_operators(x, backend):
        return _kopt.ef_quantize(x.float().contiguous(),
                                 residual.float().contiguous(), planes)
    total = flush_subnormal(flush_subnormal(x.float())
                            + flush_subnormal(residual.float()))
    flat = total.reshape(-1)
    packed, e = _encode_planes(flat, planes, backend)
    q = _decode_planes(packed, e, flat.shape[0], planes,
                       backend).reshape(x.shape)
    return q, flush_subnormal(total - q)


def compressed_psum(x: torch.Tensor, axis, planes: int = 8,
                    backend: str = "auto"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """On each rank of ``axis`` of the current mesh: the mean of ``x`` over
    the axis, transmitting only ``planes`` magnitude planes (and the sign
    plane) in the gather phase.

    Returns (reduced, residual): ``reduced`` has ``x``'s shape, float32, and
    is the same on every rank; ``residual`` is THIS rank's truncation error
    on its reduce-scatter shard (for error feedback)."""
    if not 1 <= planes <= MAG_BITS:
        raise ValueError(f"planes must be in 1..{MAG_BITS}, got {planes}")
    n_dev = shd.axis_size(axis)
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % (n_dev * 4096)
    flat = torch.nn.functional.pad(flat, (0, pad))
    # phase 1: reduce-scatter raw fp32 (wire = S*(n-1)/n, unavoidable for sum)
    shard = flush_subnormal(shd.psum_scatter(flat.reshape(n_dev, -1), axis)
                            / n_dev)
    n_local = shard.numel()
    # phase 2: encode the shard, all-gather only the packed planes
    packed, e = _encode_planes(shard, planes, backend)
    e_all = shd.all_gather(e, axis)                            # (n,)
    packed_all = shd.all_gather(packed, axis)                  # (n, P+1, W)
    decoded = _decode_planes_batch(packed_all, e_all, n_local, planes,
                                   backend)
    # this rank's shard of the gathered result is its own decode
    mine = decoded[shd.axis_index(axis)]
    residual = flush_subnormal(shard - mine)
    out = decoded.reshape(-1)[:x.numel()].reshape(x.shape)
    return out, residual


def make_compressed_allreduce(mesh, axis, planes: int = 8,
                              backend: str = "auto"):
    """``f(x_block) -> (mean over the axis, residual)`` on ``mesh``: each
    rank passes its row block of the axis-sharded array (the reference's
    ``in_specs=P(axis)``) and gets the reduced block back."""
    def f(x_block: torch.Tensor):
        with shd.use_mesh(mesh):
            return compressed_psum(x_block, axis, planes, backend)
    return f
