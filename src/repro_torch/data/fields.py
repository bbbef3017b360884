"""Synthetic scientific-field generator (NYX / JHTDB / Miranda proxies).

Real datasets are not available offline; benchmarks use spectral Gaussian
random fields with a tunable power-spectrum slope.  Steeper slopes give
smoother, more compressible fields (Miranda-like); shallower slopes approach
white noise (hard to compress).  The DC mode is zeroed and the spectrum uses
Hermitian-symmetric synthesis (irfftn), so fields are real with ~zero mean.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def gaussian_field(shape: Sequence[int], slope: float = -2.0, seed: int = 0,
                   dtype=np.float32) -> np.ndarray:
    """Real Gaussian random field with isotropic power spectrum ~ k^slope."""
    shape = tuple(shape)
    rng = np.random.default_rng(seed)
    # rfftn frequency grid
    freqs = [np.fft.fftfreq(s) for s in shape[:-1]] + [np.fft.rfftfreq(shape[-1])]
    k2 = np.zeros(tuple(len(f) for f in freqs))
    for i, f in enumerate(freqs):
        sl = [None] * len(freqs)
        sl[i] = slice(None)
        k2 = k2 + np.square(f)[tuple(sl)]
    k = np.sqrt(k2)
    amp = np.zeros_like(k)
    nz = k > 0
    amp[nz] = k[nz] ** (slope / 2.0)  # power ~ k^slope -> amplitude k^(slope/2)
    noise = rng.normal(size=k.shape) + 1j * rng.normal(size=k.shape)
    x = np.fft.irfftn(amp * noise, s=shape, axes=tuple(range(len(shape))))
    x = x / (np.abs(x).max() + 1e-30)
    return x.astype(dtype)


def velocity_field(shape: Sequence[int], seed: int = 0,
                   slope: float = -5.0 / 3.0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Three-component turbulence-like velocity field (Kolmogorov slope)."""
    return (gaussian_field(shape, slope, seed),
            gaussian_field(shape, slope, seed + 1),
            gaussian_field(shape, slope, seed + 2))


# dataset proxies with the paper's dimensions (Table 1), scaled by `factor`
DATASETS = {
    "nyx": dict(shape=(512, 512, 512), n_vars=6, slope=-1.8),
    "letkf": dict(shape=(98, 1200, 1200), n_vars=3, slope=-2.2),
    "miranda": dict(shape=(256, 384, 384), n_vars=3, slope=-3.0),
    "isabel": dict(shape=(100, 500, 500), n_vars=3, slope=-2.0),
    "jhtdb": dict(shape=(1024, 2048, 2048), n_vars=3, slope=-5.0 / 3.0),
}


def dataset_proxy(name: str, factor: int = 8, n_vars: int | None = None,
                  seed: int = 0):
    """Shrunk-by-``factor`` stand-in for a paper dataset (per-axis divide)."""
    spec = DATASETS[name]
    shape = tuple(max(s // factor, 16) for s in spec["shape"])
    nv = n_vars if n_vars is not None else spec["n_vars"]
    return [gaussian_field(shape, spec["slope"], seed + 7 * i) for i in range(nv)]
