"""Hopper CUDA kernels for the bitplane formats of all three designs.

The kernels live in ``csrc/bitplane.cu`` (the note there says which TPU
kernels they replace, what bounds them and what the design does about it):
``rb_encode``/``rb_decode`` for ``register_block``, ``loc_encode`` and
``shuffle_encode`` for the ``locality`` and ``shuffle`` designs, and
``loc_decode`` for the format those two share.
They are compiled by ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at first use, into ``build/repro_torch_kernels/`` at the
root of the checkout, and loaded with ``ctypes``.  The library name carries
a hash of the source, so an edited source is rebuilt.  Nothing is compiled
or loaded when this module is imported: the CPU tests import it on a
machine with no ``nvcc`` and no card.

Each wrapper checks device, dtype, shape and contiguity, raises on what the
kernel does not take, allocates the output with ``torch.empty``, launches on
the current stream, raises if ``cudaGetLastError()`` is not 0, and adds one
to its ``launches`` counter.  There is no fallback: a kernel that does not
build or launch raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.ref import TILE, TILE_LANE

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "bitplane.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_BATCH = 65535         # gridDim.y
ENCODE_SYMBOLS = ("rb_encode", "loc_encode", "shuffle_encode")
DECODE_SYMBOLS = ("rb_decode", "loc_decode")

_lock = threading.Lock()
# launches counters are read-modify-written by any thread that decodes
# (concurrent sessions of a store service)
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}     # path, seconds, built (False: reused), ptxas log


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    t0 = time.perf_counter()
    log = ""
    built = False
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                               capture_output=True, text=True)
            log = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
            os.replace(tmp, lib)  # atomic: concurrent builds agree
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        built = True
    BUILD_INFO.update(path=str(lib), seconds=time.perf_counter() - t0,
                      built=built, log=log)
    return lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build(SOURCES[0])))
            vp, ll_, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            for name in ENCODE_SYMBOLS:
                fn = getattr(lib, name)
                fn.argtypes = [vp, vp, ll_, ll_, i, i, ll_, vp]
                fn.restype = i
            for name in DECODE_SYMBOLS:
                fn = getattr(lib, name)
                fn.argtypes = [vp, vp, ll_, i, i, i, ll_, vp]
                fn.restype = i
            _lib = lib
    return _lib


def _check_common(t: torch.Tensor, ndim: int, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"{what}: expected int32/uint32 storage, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    if t.shape[0] > MAX_BATCH:
        raise ValueError(f"{what}: batch {t.shape[0]} exceeds {MAX_BATCH}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _encode(wrapper, symbol: str, mags: torch.Tensor,
            num_planes: int) -> torch.Tensor:
    """(B, N) magnitudes -> (B, num_planes, W) through ``symbol``, one launch
    for the whole batch; ``wrapper.launches`` counts it.  An empty input
    launches nothing and counts nothing."""
    _check_common(mags, 2, symbol)
    if not 1 <= num_planes <= 32:
        raise ValueError(f"num_planes must be in [1, 32], got {num_planes}")
    b, n = mags.shape
    words = (n + (-n) % TILE) // 32
    out = torch.empty((b, num_planes, words), dtype=torch.int32,
                      device=mags.device)
    if b == 0 or words == 0:
        return out
    fn = getattr(load(), symbol)
    with torch.cuda.device(mags.device):
        stream = torch.cuda.current_stream(mags.device).cuda_stream
        err = fn(mags.data_ptr(), out.data_ptr(), n, n, b, num_planes, words,
                 stream)
    _raise_on(err, symbol)
    with _count_lock:
        wrapper.launches += 1
    return out


def _decode(wrapper, symbol: str, planes: torch.Tensor,
            num_planes_total: int, n: int) -> torch.Tensor:
    """(B, P', W) plane prefixes -> (B, n) through ``symbol``, one launch
    for the whole batch; ``wrapper.launches`` counts it.  An empty output
    launches nothing and counts nothing."""
    _check_common(planes, 3, symbol)
    b, rows, words = planes.shape
    if not 1 <= num_planes_total <= 32:
        raise ValueError(f"num_planes_total must be in [1, 32], got "
                         f"{num_planes_total}")
    if rows > num_planes_total:
        raise ValueError(f"{rows} plane rows exceed the total "
                         f"{num_planes_total}")
    if words % TILE_LANE:
        raise ValueError(f"plane width {words} is not a multiple of "
                         f"{TILE_LANE}")
    if not 0 <= n <= 32 * words:
        raise ValueError(f"n={n} does not fit {words} words per plane")
    out = torch.empty((b, n), dtype=torch.int32, device=planes.device)
    if b == 0 or n == 0:
        return out
    fn = getattr(load(), symbol)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = fn(planes.data_ptr(), out.data_ptr(), n, b, rows,
                 num_planes_total, words, stream)
    _raise_on(err, symbol)
    with _count_lock:
        wrapper.launches += 1
    return out


def encode_register_block_cuda(mags: torch.Tensor,
                               num_planes: int) -> torch.Tensor:
    """(B, N) uint32 magnitudes (int32 storage) -> (B, num_planes, W) plane
    words in the ``register_block`` format, W = ceil(N / 4096) * 128."""
    return _encode(encode_register_block_cuda, "rb_encode", mags, num_planes)


def decode_register_block_cuda(planes: torch.Tensor, num_planes_total: int,
                               n: int) -> torch.Tensor:
    """(B, P', W) ``register_block`` plane prefixes -> (B, n) magnitudes
    with plane j at bit ``num_planes_total - 1 - j``."""
    return _decode(decode_register_block_cuda, "rb_decode", planes, num_planes_total, n)


def encode_locality_cuda(mags: torch.Tensor, num_planes: int) -> torch.Tensor:
    """(B, N) magnitudes -> (B, num_planes, W) consecutive-element plane
    words (the ``locality`` format): a thread per word, which reads its 32
    elements from a per-warp shared tile and transposes their bits in
    registers (or gathers each plane's bits directly, for few planes)."""
    return _encode(encode_locality_cuda, "loc_encode", mags, num_planes)


def encode_shuffle_cuda(mags: torch.Tensor, num_planes: int) -> torch.Tensor:
    """The ``locality`` format's words, formed by exchange across a warp's
    lanes (the ``shuffle`` design): a 32x32 bit-matrix butterfly of five
    ``__shfl_xor_sync`` per word for all planes.  The same output as
    ``encode_locality_cuda``."""
    return _encode(encode_shuffle_cuda, "shuffle_encode", mags, num_planes)


def decode_locality_cuda(planes: torch.Tensor, num_planes_total: int,
                         n: int) -> torch.Tensor:
    """(B, P', W) ``locality``/``shuffle`` plane prefixes -> (B, n)
    magnitudes with plane j at bit ``num_planes_total - 1 - j``."""
    return _decode(decode_locality_cuda, "loc_decode", planes, num_planes_total, n)


WRAPPERS = (encode_register_block_cuda, decode_register_block_cuda,
            encode_locality_cuda, encode_shuffle_cuda, decode_locality_cuda)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


reset_launches()
