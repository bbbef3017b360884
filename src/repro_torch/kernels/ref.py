"""Plain PyTorch versions of the bitplane formats (the kernels' oracles).

Two on-disk FORMATS exist (the paper's three *execution* designs map onto
them -- ``shuffle`` shares the ``locality`` format):

``locality``  word ``w`` of plane ``j`` holds bit ``(Bm-1-j)`` of elements
              ``32w .. 32w+31`` (consecutive elements -> bit lanes).

``register_block``  elements are processed in tiles of 32x128 = 4096; within
              tile ``t`` the element at (slot i, lane l), i.e. flat index
              ``4096 t + 128 i + l``, contributes bit ``i`` of word
              ``128 t + l``.  ``TILE_LANE = 128`` is a FORMAT constant: the
              CUDA kernel keeps it so the bytes match the reference package.

Planes are stored MSB-first: plane 0 carries bit (num_planes-1), so a
*prefix* of planes is exactly a precision-truncated representation.

Every function takes leading batch dimensions: magnitudes ``(..., N)`` ->
planes ``(..., P, W)`` and back.  Values are uint32 bit patterns in int32
storage; the bit work runs in int64 because torch's CPU backend has no
uint32 shifts.  These are the plain versions the CPU path runs and the
CUDA kernels are held against; nothing on the card's main path calls them.
"""
from __future__ import annotations

import numpy as np
import torch

TILE_SUB = 32      # slots per lane (bits per packed word)
TILE_LANE = 128    # lanes per tile (format constant)
TILE = TILE_SUB * TILE_LANE  # 4096 elements per tile

_MASK32 = 0xFFFFFFFF


def padded_words(n: int, design: str = "register_block") -> int:
    """Number of uint32 words per plane for an n-element input.

    All designs pad N to a whole 4096-element tile so the three formats have
    identical plane sizes."""
    n_pad = n + ((-n) % TILE)
    return n_pad // 32


def _u64(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return x.to(torch.int64) & _MASK32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 bit patterns (wraps)."""
    return x.to(torch.int32)


def _pad_last(x: torch.Tensor, multiple: int) -> torch.Tensor:
    rem = (-x.shape[-1]) % multiple
    if rem:
        x = torch.nn.functional.pad(x, (0, rem))
    return x


def _check_planes(num_planes: int) -> None:
    if not 1 <= num_planes <= 32:
        raise ValueError(f"num_planes must be in [1, 32], got {num_planes}")


# ---------------------------------------------------------------- locality --

def encode_locality(mag: torch.Tensor, num_planes: int) -> torch.Tensor:
    """(..., N) -> (..., num_planes, W), consecutive-element words."""
    _check_planes(num_planes)
    lead = mag.shape[:-1]
    x = _pad_last(_u64(mag), TILE).reshape(*lead, -1, 32)  # (..., W, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=mag.device)
    planes = []
    for j in range(num_planes):
        b = num_planes - 1 - j
        bits = (x >> b) & 1
        planes.append((bits << shifts).sum(dim=-1))
    return _i32(torch.stack(planes, dim=-2))


def decode_locality(planes: torch.Tensor, num_planes_total: int,
                    n: int) -> torch.Tensor:
    """(..., P, W) prefix -> (..., n) magnitudes truncated to the top P
    planes."""
    lead, (p, w) = planes.shape[:-2], planes.shape[-2:]
    pw = _u64(planes)
    shifts = torch.arange(32, dtype=torch.int64, device=planes.device)
    out = torch.zeros(*lead, w, 32, dtype=torch.int64, device=planes.device)
    for j in range(p):
        b = num_planes_total - 1 - j
        bits = (pw[..., j, :, None] >> shifts) & 1
        out |= bits << b
    return _i32(out.reshape(*lead, -1)[..., :n])


# ---------------------------------------------------------- register_block --

def encode_register_block(mag: torch.Tensor, num_planes: int) -> torch.Tensor:
    """(..., N) -> (..., num_planes, W), lane-strided interleave."""
    _check_planes(num_planes)
    lead = mag.shape[:-1]
    x = _pad_last(_u64(mag), TILE).reshape(*lead, -1, TILE_SUB, TILE_LANE)
    shifts = torch.arange(TILE_SUB, dtype=torch.int64,
                          device=mag.device)[:, None]  # slot i -> bit i
    planes = []
    for j in range(num_planes):
        b = num_planes - 1 - j
        bits = (x >> b) & 1                                # (..., T, 32, 128)
        words = (bits << shifts).sum(dim=-2)               # (..., T, 128)
        planes.append(words.reshape(*lead, -1))
    return _i32(torch.stack(planes, dim=-2))


def decode_register_block(planes: torch.Tensor, num_planes_total: int,
                          n: int) -> torch.Tensor:
    lead, (p, w) = planes.shape[:-2], planes.shape[-2:]
    t = w // TILE_LANE
    pw = _u64(planes).reshape(*lead, p, t, TILE_LANE)
    shifts = torch.arange(TILE_SUB, dtype=torch.int64,
                          device=planes.device)[:, None]
    out = torch.zeros(*lead, t, TILE_SUB, TILE_LANE, dtype=torch.int64,
                      device=planes.device)
    for j in range(p):
        b = num_planes_total - 1 - j
        bits = (pw[..., j, :, None, :] >> shifts) & 1     # (..., T, 32, 128)
        out |= bits << b
    return _i32(out.reshape(*lead, -1)[..., :n])


ENCODERS = {"locality": encode_locality, "shuffle": encode_locality,
            "register_block": encode_register_block}
DECODERS = {"locality": decode_locality, "shuffle": decode_locality,
            "register_block": decode_register_block}


def encode(mag: torch.Tensor, num_planes: int,
           design: str = "register_block") -> torch.Tensor:
    return ENCODERS[design](mag, num_planes)


def decode(planes: torch.Tensor, num_planes_total: int, n: int,
           design: str = "register_block") -> torch.Tensor:
    return DECODERS[design](planes, num_planes_total, n)


# NumPy twin used by tests as an independent oracle --------------------------

def encode_np(mag: np.ndarray, num_planes: int, design: str = "register_block") -> np.ndarray:
    mag = np.asarray(mag, dtype=np.uint32)
    n_pad = len(mag) + ((-len(mag)) % TILE)
    x = np.zeros(n_pad, dtype=np.uint32)
    x[: len(mag)] = mag
    out = np.zeros((num_planes, n_pad // 32), dtype=np.uint32)
    for j in range(num_planes):
        b = num_planes - 1 - j
        bits = (x >> b) & 1
        if design == "register_block":
            br = bits.reshape(-1, TILE_SUB, TILE_LANE)
            words = np.zeros((br.shape[0], TILE_LANE), dtype=np.uint32)
            for i in range(TILE_SUB):
                words |= br[:, i, :].astype(np.uint32) << i
            out[j] = words.reshape(-1)
        else:
            br = bits.reshape(-1, 32)
            words = np.zeros(br.shape[0], dtype=np.uint32)
            for i in range(32):
                words |= br[:, i].astype(np.uint32) << i
            out[j] = words
    return out
