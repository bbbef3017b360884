"""Dispatch wrappers for the bitplane kernels.

Backend selection:
  'auto'   -> the CUDA kernel for CUDA tensors, the plain torch version for
              CPU and ``meta`` tensors
  'cuda'   -> always the CUDA kernel (raises on a CPU tensor; on a ``meta``
              tensor the kernel's operator runs its fake: the output's
              shape, no launch, which is how a cost model counts a kernel)
  'torch'  -> the plain torch version (``kernels.ref``), an explicit choice

Every design has its CUDA kernels (``kernels.bitplane``): on a CUDA tensor
'auto'/'cuda' launch them and never fall back to the plain version; on CPU
tensors every design runs the plain version.  ``locality`` and ``shuffle``
encode through different kernels into one format, which ``loc_decode``
decodes for both.

Every entry point takes ``device=``: numpy or torch input is placed there
first; ``None`` means ``cuda`` (see ``repro_torch.device``).  A batch form is
ONE kernel launch with a batch grid axis; a sharded form splits a batch's
rows over the devices of a mesh, one batch launch per mesh entry.

``tiles_per_block`` and ``unroll`` are accepted so that the signatures (and
``config_kwargs``) match ``repro.kernels.ops``.  In the reference they pick a
Pallas blocking and a transpose variant, neither of which changes a bit of
the output; the CUDA kernel has one blocking and one transpose, so here they
are ignored.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import DeviceLike, as_u32_bits
from repro_torch.kernels import bitplane as _bp
from repro_torch.kernels import ref as _ref
from repro_torch.tune.config import BACKENDS

DESIGNS = ("register_block", "locality", "shuffle")
_ENCODE_KERNELS = {"register_block": _bp.encode_register_block_cuda,
                   "locality": _bp.encode_locality_cuda,
                   "shuffle": _bp.encode_shuffle_cuda}
_DECODE_KERNELS = {"register_block": _bp.decode_register_block_cuda,
                   "locality": _bp.decode_locality_cuda,
                   "shuffle": _bp.decode_locality_cuda}
_DEFAULT_BACKEND = "auto"


def _use_kernel(t: torch.Tensor, backend: str, design: str) -> bool:
    """True -> launch the CUDA kernel; False -> run the plain version."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of "
                         f"{BACKENDS})")
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}")
    if backend == "torch":
        return False
    if t.device.type == "cuda":
        return True
    if backend == "cuda" and t.device.type == "meta":
        return True
    if backend == "cuda":
        raise ValueError(f"backend='cuda' needs a CUDA tensor, got "
                         f"{t.device}")
    return False


def config_kwargs(config) -> dict:
    """Kernel-facing kwargs of a ``repro_torch.tune.RefactorConfig``
    (duck-typed so this module stays import-light): expand with ``**`` into
    any encode/decode call below."""
    return {"design": config.design, "backend": config.backend,
            "tiles_per_block": config.tiles_per_block,
            "unroll": config.unroll}


def encode_bitplanes_batch(mags, num_planes: int,
                           design: str = "register_block",
                           backend: str = _DEFAULT_BACKEND,
                           tiles_per_block: int = 8,
                           unroll: str = "butterfly", *,
                           device: DeviceLike = None) -> torch.Tensor:
    """(B, N) uint32 magnitudes -> (B, num_planes, W): one launch for B
    same-length encodes (the fused write engine's per-bucket call)."""
    mags = as_u32_bits(mags, device)
    if mags.dim() != 2:
        raise ValueError(f"expected (B, N) magnitudes, got {tuple(mags.shape)}")
    if _use_kernel(mags, backend, design):
        return _ENCODE_KERNELS[design](mags.contiguous(), num_planes)
    return _ref.encode(mags, num_planes, design)


def encode_bitplanes(mag, num_planes: int, design: str = "register_block",
                     backend: str = _DEFAULT_BACKEND,
                     tiles_per_block: int = 8, unroll: str = "butterfly", *,
                     device: DeviceLike = None) -> torch.Tensor:
    """(N,) uint32 magnitudes -> (num_planes, W) packed planes (MSB-first)."""
    mag = as_u32_bits(mag, device)
    return encode_bitplanes_batch(mag.reshape(1, -1), num_planes, design,
                                  backend, device=mag.device)[0]


def decode_bitplanes_batch(planes, num_planes_total: int, n: int,
                           design: str = "register_block",
                           backend: str = _DEFAULT_BACKEND,
                           tiles_per_block: int = 8,
                           unroll: str = "butterfly", *,
                           device: DeviceLike = None) -> torch.Tensor:
    """(B, P, W) plane prefixes -> (B, n): one launch for B same-shape
    decodes."""
    planes = as_u32_bits(planes, device)
    if planes.dim() != 3:
        raise ValueError(f"expected (B, P, W) planes, got "
                         f"{tuple(planes.shape)}")
    if not planes.shape[1] <= num_planes_total <= 32:
        raise ValueError(f"{planes.shape[1]} rows with num_planes_total="
                         f"{num_planes_total}")
    if n > 32 * planes.shape[2]:
        raise ValueError(f"n={n} does not fit {planes.shape[2]} words")
    if _use_kernel(planes, backend, design):
        return _DECODE_KERNELS[design](planes.contiguous(),
                                       num_planes_total, n)
    return _ref.decode(planes, num_planes_total, n, design)


def decode_bitplanes(planes, num_planes_total: int, n: int,
                     design: str = "register_block",
                     backend: str = _DEFAULT_BACKEND,
                     tiles_per_block: int = 8, unroll: str = "butterfly", *,
                     device: DeviceLike = None) -> torch.Tensor:
    """(P, W) plane prefix -> (n,) uint32 magnitudes truncated to P planes."""
    planes = as_u32_bits(planes, device)
    return decode_bitplanes_batch(planes[None], num_planes_total, n, design,
                                  backend, device=planes.device)[0]


def _shard_batch(fn, batch, mesh, axis: str, device: DeviceLike):
    """Split ``batch``'s rows into one equal block per entry of ``mesh`` and
    run ``fn`` on each block on that entry's device (on its current stream),
    with no collective and no host round trip.  Returns the blocks' results
    as a tuple in mesh order."""
    from repro_torch.core import sharded as shd  # local: keep graph flat

    if axis != shd.CHUNK_AXIS:
        raise ValueError(f"the port's meshes have one axis, "
                         f"{shd.CHUNK_AXIS!r}; got {axis!r}")
    devices = shd.chunk_devices(shd.resolve_mesh(mesh, device), device)
    batch = as_u32_bits(batch, devices[0])
    size = len(devices)
    if int(batch.shape[0]) % size != 0:
        raise ValueError(
            f"batch dim {batch.shape[0]} not divisible by mesh axis "
            f"{axis!r} of size {size}")
    rows = int(batch.shape[0]) // size
    return tuple(fn(batch[k * rows:(k + 1) * rows].to(dev), dev)
                 for k, dev in enumerate(devices))


def encode_bitplanes_sharded(mags, num_planes: int,
                             design: str = "register_block",
                             backend: str = _DEFAULT_BACKEND,
                             tiles_per_block: int = 8,
                             unroll: str = "butterfly", *,
                             mesh, axis: str = "chunk",
                             device: DeviceLike = None
                             ) -> Tuple[torch.Tensor, ...]:
    """``encode_bitplanes_batch`` sharded over a mesh: the (B, N) rows are
    split into ``len(mesh)`` equal blocks, and block ``k`` is encoded on
    mesh entry ``k``'s device.  Returns the row-sharded result as a tuple of
    (B / len(mesh), num_planes, W) blocks in mesh order, each on its device;
    ``torch.cat`` of the blocks (on one device) is bit-identical to the
    unsharded batch op.  B must divide by the mesh size.  ``mesh`` is a
    device list (one card may appear several times: the blocks then run in
    turn on its current stream) or a count (``core.sharded.resolve_mesh``);
    ``device`` places numpy input and resolves an int mesh."""
    return _shard_batch(
        lambda m, dev: encode_bitplanes_batch(m, num_planes, design, backend,
                                              device=dev),
        mags, mesh, axis, device)


def decode_bitplanes_sharded(planes, num_planes_total: int, n: int,
                             design: str = "register_block",
                             backend: str = _DEFAULT_BACKEND,
                             tiles_per_block: int = 8,
                             unroll: str = "butterfly", *,
                             mesh, axis: str = "chunk",
                             device: DeviceLike = None
                             ) -> Tuple[torch.Tensor, ...]:
    """``decode_bitplanes_batch`` sharded over a mesh: (B, P, W) plane
    prefixes split into one block of rows per mesh entry, each decoded on
    its entry's device.  Returns the (B / len(mesh), n) blocks in mesh
    order, as ``encode_bitplanes_sharded`` does.  B must divide by the mesh
    size."""
    return _shard_batch(
        lambda p, dev: decode_bitplanes_batch(p, num_planes_total, n, design,
                                              backend, device=dev),
        planes, mesh, axis, device)


def decode_bitplanes_offset(planes, num_planes_total: int, n: int,
                            plane_offset: int,
                            design: str = "register_block",
                            backend: str = _DEFAULT_BACKEND,
                            tiles_per_block: int = 8,
                            unroll: str = "butterfly", *,
                            device: DeviceLike = None) -> torch.Tensor:
    """Decode a plane-group slice that sits ``plane_offset`` rows into the
    MSB-first stack: row ``j`` carries magnitude bit ``num_planes_total - 1
    - (plane_offset + j)``.  The result holds ONLY those bits, so OR-ing the
    decodes of disjoint slices reproduces the full-stack decode exactly.

    Implemented as a truncated-total decode: shifting the total by the offset
    shifts every row's bit position identically."""
    return decode_bitplanes(planes, num_planes_total - plane_offset, n,
                            design, backend, device=device)


def decode_bitplanes_offset_batch(planes, num_planes_total: int, n: int,
                                  plane_offset: int,
                                  design: str = "register_block",
                                  backend: str = _DEFAULT_BACKEND,
                                  tiles_per_block: int = 8,
                                  unroll: str = "butterfly", *,
                                  device: DeviceLike = None) -> torch.Tensor:
    """(B, P, W) same-offset plane-group slices -> (B, n) partial magnitudes:
    the batched form of ``decode_bitplanes_offset`` (one launch)."""
    return decode_bitplanes_batch(planes, num_planes_total - plane_offset, n,
                                  design, backend, device=device)
