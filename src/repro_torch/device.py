"""Device placement rules shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU:

* ``device=None`` means ``"cuda"``;
* numpy input and torch input are both placed on the resolved device;
* with no card present, any device other than the CPU raises
  ``RuntimeError`` -- nothing continues quietly on the CPU.

Integer bit patterns (bitplane words, magnitudes) travel as ``int32``
tensors holding the uint32 bits: torch's CPU backend lacks shifts and
scatter-adds for ``uint32``, so plain bit work widens to ``int64`` and the
kernels take the ``int32`` storage through ``data_ptr()``.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises ``RuntimeError`` when a CUDA device is
    asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return dev


def as_float32(x, device: DeviceLike = None) -> torch.Tensor:
    """numpy or torch input -> float32 tensor on the resolved device."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    # np.array copies and keeps 0-d arrays 0-d (ascontiguousarray would not)
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)


def as_u32_bits(x, device: DeviceLike = None) -> torch.Tensor:
    """Integer numpy or torch input -> int32 tensor holding the uint32 bit
    pattern of each value (values wrap modulo 2**32), on the device."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.int32:
            return x.to(dev)
        if x.dtype == torch.uint32:
            return x.contiguous().view(torch.int32).to(dev)
        if x.dtype in (torch.uint8, torch.int8, torch.int16, torch.int64,
                       torch.bool):
            return (x.to(torch.int64) & 0xFFFFFFFF).to(torch.int32).to(dev)
        raise TypeError(f"expected an integer tensor, got {x.dtype}")
    a = np.asarray(x)
    if a.dtype.kind not in "biu":
        raise TypeError(f"expected an integer array, got {a.dtype}")
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32)
                            ).to(dev)
