"""Progressive gradient compression: the error-feedback half.

A port of ``repro.distributed.grad_compress``'s ``ef_quantize`` (and its
``_encode_planes``/``_decode_planes``): a gradient is bitplane-truncated to
its sign and top ``planes`` magnitude planes, in the ``register_block``
format, and the truncation error is carried to the next step.  On a CUDA
tensor the planes go through the ``rb_encode``/``rb_decode`` kernels
(``kernels.ops``, backend ``auto``); on the CPU, or with
``backend="torch"``, through their plain versions.

The reference's ``compressed_psum`` and ``make_compressed_allreduce`` are
``shard_map`` collectives over a mesh axis and wait for the mesh-bound
paths.

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
from repro_torch.kernels.ops import decode_bitplanes, encode_bitplanes

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
    dev = packed.device
    sign = decode_bitplanes(packed[:1], 1, n, "register_block", backend,
                            device=dev)
    mag = decode_bitplanes(packed[1:], planes, n, "register_block", backend,
                           device=dev).to(torch.int64) & _U32
    tail = MAG_BITS - planes
    mag = mag << tail
    if tail > 0:
        mag = mag + (1 << (tail - 1))  # midpoint decode
    val = flush_subnormal(mag.to(torch.float32) / exp2_int(MAG_BITS - e))
    return torch.where(sign != 0, -val, val)


def ef_quantize(x: torch.Tensor, residual: torch.Tensor, planes: int,
                backend: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Bitplane-truncate ``x + residual`` to ``planes`` (1 .. 23) magnitude
    planes; returns (q, new residual), float32 tensors of ``x``'s shape on
    its device."""
    if not 1 <= planes <= MAG_BITS:
        raise ValueError(f"planes must be in 1..{MAG_BITS}, got {planes}")
    total = flush_subnormal(flush_subnormal(x.float())
                            + flush_subnormal(residual.float()))
    flat = total.reshape(-1)
    packed, e = _encode_planes(flat, planes, backend)
    q = _decode_planes(packed, e, flat.shape[0], planes,
                       backend).reshape(x.shape)
    return q, flush_subnormal(total - q)
