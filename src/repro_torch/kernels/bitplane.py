"""Hopper CUDA kernels for the bitplane formats of all three designs.

The kernels live in ``csrc/bitplane.cu`` (the note there says which TPU
kernels they replace, what bounds them and what the design does about it):
``rb_encode``/``rb_decode`` for ``register_block``, ``loc_encode`` and
``shuffle_encode`` for the ``locality`` and ``shuffle`` designs, and
``loc_decode`` for the format those two share.
Every source of ``SOURCES`` (these, ``csrc/scan.cu``, the SSM scans of
``kernels/scan.py``, ``csrc/optim.cu``, the optimizer path of
``kernels/optim.py``, and ``csrc/lossless.cu``, Algorithm 2's lossless
codec of ``kernels/lossless.py``) is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use, all at once (one ``nvcc``
each), into ``build/repro_torch_kernels/`` at the root of the checkout,
and loaded with ``ctypes``.  A library's name carries a hash of its
source, so an edited source is rebuilt.  Nothing is compiled or loaded
when this module is imported: the CPU tests import it on a machine with
no ``nvcc`` and no card.

Each kernel is an operator of the dispatcher, ``torch.ops.repro_torch.<name>``
(a ``torch.library.custom_op``): its CUDA implementation allocates the
output with ``torch.empty``, launches on the current stream, raises if
``cudaGetLastError()`` is not 0 and adds one to its wrapper's ``launches``
counter; its fake (``register_fake``) gives the output's shape and dtype, so
that the operator also runs on ``meta`` tensors, launching nothing.  A
dispatch mode (``launch.op_analysis.OpAnalysis``) thus sees each launch as
one operator, at its operand and result bytes, on the card and on ``meta``
alike.  A CUDA call that no dispatch mode observes launches directly,
without the dispatcher's Python round trips; an observed one goes through
the operator below the autograd layers (the operands are integer bit
patterns, which carry no gradient).  Each wrapper checks device (CUDA or
``meta``), dtype, shape and contiguity and raises on what the kernel does
not take.  There is no fallback: a kernel that does not build or launch
raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.kernels.ref import TILE, TILE_LANE

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "bitplane.cu", _CSRC / "scan.cu", _CSRC / "optim.cu",
           _CSRC / "lossless.cu")
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
_libs: Dict[str, ctypes.CDLL] = {}
# per source stem: path, seconds, built (False: reused), ptxas log; and
# "seconds": the wall of the whole build
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build(src: Path) -> Tuple[Path, dict]:
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
    return lib, dict(path=str(lib), seconds=time.perf_counter() - t0,
                     built=built, log=log)


def load() -> ctypes.CDLL:
    """Build (if needed) and load every kernel library, the sources
    compiled at once; returns the bitplane library.  Raises on failure."""
    with _lock:
        if not _libs:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(SOURCES)) as ex:
                built = list(ex.map(_build, SOURCES))
            libs = {src.stem: ctypes.CDLL(str(path))
                    for src, (path, _) in zip(SOURCES, built)}
            lib = libs["bitplane"]
            vp, ll_, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            for name in ENCODE_SYMBOLS:
                fn = getattr(lib, name)
                fn.argtypes = [vp, vp, ll_, ll_, i, i, ll_, vp]
                fn.restype = i
            for name in DECODE_SYMBOLS:
                fn = getattr(lib, name)
                fn.argtypes = [vp, vp, ll_, i, i, i, ll_, vp]
                fn.restype = i
            BUILD_INFO.update({src.stem: info
                               for src, (_, info) in zip(SOURCES, built)})
            BUILD_INFO["seconds"] = time.perf_counter() - t0
            _libs.update(libs)
    return _libs["bitplane"]


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of the source ``csrc/<stem>.cu`` (built and
    loaded with the others at first use)."""
    load()
    return _libs[stem]


def _check_common(t: torch.Tensor, ndim: int, what: str) -> None:
    if t.device.type not in ("cuda", "meta"):
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


def _words(n: int) -> int:
    return (n + (-n) % TILE) // 32


def _count(symbol: str) -> None:
    with _count_lock:
        _COUNTED[symbol].launches += 1


def _launch_encode(symbol: str, mags: torch.Tensor,
                   num_planes: int) -> torch.Tensor:
    """The CUDA implementation of an encode operator: one launch for the
    whole batch, counted.  An empty input launches nothing and counts
    nothing."""
    b, n = mags.shape
    words = _words(n)
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
    _count(symbol)
    return out


def _launch_decode(symbol: str, planes: torch.Tensor, num_planes_total: int,
                   n: int) -> torch.Tensor:
    """The CUDA implementation of a decode operator: one launch for the
    whole batch, counted.  An empty output launches nothing and counts
    nothing."""
    b, rows, words = planes.shape
    out = torch.empty((b, n), dtype=torch.int32, device=planes.device)
    if b == 0 or n == 0:
        return out
    fn = getattr(load(), symbol)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = fn(planes.data_ptr(), out.data_ptr(), n, b, rows,
                 num_planes_total, words, stream)
    _raise_on(err, symbol)
    _count(symbol)
    return out


def _define(symbol: str, encode: bool):
    """Register ``repro_torch::<symbol>`` (its CUDA implementation and its
    fake) and return its ``OpOverload``."""
    name = f"repro_torch::{symbol}"
    if encode:
        @torch.library.custom_op(name, mutates_args=(), device_types="cuda")
        def op(mags: torch.Tensor, num_planes: int) -> torch.Tensor:
            return _launch_encode(symbol, mags, num_planes)

        @op.register_fake
        def _(mags, num_planes):
            b, n = mags.shape
            return mags.new_empty((b, num_planes, _words(n)),
                                  dtype=torch.int32)
    else:
        @torch.library.custom_op(name, mutates_args=(), device_types="cuda")
        def op(planes: torch.Tensor, num_planes_total: int,
               n: int) -> torch.Tensor:
            return _launch_decode(symbol, planes, num_planes_total, n)

        @op.register_fake
        def _(planes, num_planes_total, n):
            return planes.new_empty((planes.shape[0], n), dtype=torch.int32)
    return getattr(torch.ops.repro_torch, symbol).default


_OPS = {**{s: _define(s, True) for s in ENCODE_SYMBOLS},
        **{s: _define(s, False) for s in DECODE_SYMBOLS}}


_LAUNCH = {**{s: functools.partial(_launch_encode, s) for s in ENCODE_SYMBOLS},
           **{s: functools.partial(_launch_decode, s) for s in DECODE_SYMBOLS}}


def _call(symbol: str, *args):
    """Through the operator wherever something observes the dispatcher (a
    dispatch mode, such as ``launch.op_analysis.OpAnalysis``, or a ``meta``
    tensor); a CUDA tensor that nothing observes launches directly, since
    the dispatcher's Python round trips would cost the call about 20 us
    on the host and do nothing for it."""
    if args[0].device.type == "cuda" and _get_current_dispatch_mode() is None:
        return _LAUNCH[symbol](*args)
    # below the autograd layers: integer bit patterns carry no gradient,
    # and each of those layers would cost the call a Python round trip
    with torch._C._AutoDispatchBelowADInplaceOrView():
        return _OPS[symbol](*args)


def _encode(symbol: str, mags: torch.Tensor,
            num_planes: int) -> torch.Tensor:
    """(B, N) magnitudes -> (B, num_planes, W) through the operator
    ``symbol``."""
    _check_common(mags, 2, symbol)
    if not 1 <= num_planes <= 32:
        raise ValueError(f"num_planes must be in [1, 32], got {num_planes}")
    return _call(symbol, mags, num_planes)


def _decode(symbol: str, planes: torch.Tensor, num_planes_total: int,
            n: int) -> torch.Tensor:
    """(B, P', W) plane prefixes -> (B, n) through the operator
    ``symbol``."""
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
    return _call(symbol, planes, num_planes_total, n)


def encode_register_block_cuda(mags: torch.Tensor,
                               num_planes: int) -> torch.Tensor:
    """(B, N) uint32 magnitudes (int32 storage) -> (B, num_planes, W) plane
    words in the ``register_block`` format, W = ceil(N / 4096) * 128."""
    return _encode("rb_encode", mags, num_planes)


def decode_register_block_cuda(planes: torch.Tensor, num_planes_total: int,
                               n: int) -> torch.Tensor:
    """(B, P', W) ``register_block`` plane prefixes -> (B, n) magnitudes
    with plane j at bit ``num_planes_total - 1 - j``."""
    return _decode("rb_decode", planes, num_planes_total, n)


def encode_locality_cuda(mags: torch.Tensor, num_planes: int) -> torch.Tensor:
    """(B, N) magnitudes -> (B, num_planes, W) consecutive-element plane
    words (the ``locality`` format): a thread per word, which reads its 32
    elements from a per-warp shared tile and transposes their bits in
    registers (or gathers each plane's bits directly, for few planes)."""
    return _encode("loc_encode", mags, num_planes)


def encode_shuffle_cuda(mags: torch.Tensor, num_planes: int) -> torch.Tensor:
    """The ``locality`` format's words, formed by exchange across a warp's
    lanes (the ``shuffle`` design): a 32x32 bit-matrix butterfly of five
    ``__shfl_xor_sync`` per word for all planes.  The same output as
    ``encode_locality_cuda``."""
    return _encode("shuffle_encode", mags, num_planes)


def decode_locality_cuda(planes: torch.Tensor, num_planes_total: int,
                         n: int) -> torch.Tensor:
    """(B, P', W) ``locality``/``shuffle`` plane prefixes -> (B, n)
    magnitudes with plane j at bit ``num_planes_total - 1 - j``."""
    return _decode("loc_decode", planes, num_planes_total, n)


WRAPPERS = (encode_register_block_cuda, decode_register_block_cuda,
            encode_locality_cuda, encode_shuffle_cuda, decode_locality_cuda)
# every kernel's wrapper by its symbol, the SSM scans', the optimizer
# path's and the lossless codec's too (kernels/scan.py, kernels/optim.py and
# kernels/lossless.py add them): one record of launches
_COUNTED = dict(zip(("rb_encode", "rb_decode", "loc_encode",
                     "shuffle_encode", "loc_decode"), WRAPPERS))


def add_counters(wrappers) -> None:
    """Keep the launches of ``wrappers`` ({symbol: wrapper}) in this
    module's record (``launches()``, ``reset_launches()``)."""
    with _count_lock:
        for symbol, fn in wrappers.items():
            fn.launches = 0
            _COUNTED[symbol] = fn


# each kernel operator's workspace, by operator (``torch.ops.repro_torch.
# <name>.default``): a function of the operator's arguments giving
# {name: shape} (a buffer of its first input's dtype) or {name: (shape,
# dtype)} of the buffers its CUDA implementation allocates beyond its
# outputs and frees when it returns (``kernels/scan.py`` adds the scan
# backwards', ``kernels/optim.py`` ``ef_quantize``'s, ``kernels/lossless.py``
# the lossless codec's tile totals);
# ``launch.op_analysis.OpAnalysis`` counts them
WORKSPACE: Dict[object, object] = {}


def add_workspace(table) -> None:
    """Declare the workspace of the operators of ``table`` ({operator:
    function of its arguments -> {name: shape}})."""
    WORKSPACE.update(table)


def launches() -> Dict[str, int]:
    """Every kernel's launches since the last reset, by symbol."""
    with _count_lock:
        return {s: fn.launches for s, fn in _COUNTED.items()}


def reset_launches() -> None:
    with _count_lock:
        for fn in _COUNTED.values():
            fn.launches = 0


reset_launches()


# ------------------------------------------------------ device activities --
# what one call puts on the device, read off a CUDA graph captured from it
# through the driver API: its kernel, copy and memset nodes (CUgraphNodeType
# 0, 1 and 2), so that no activity is lost as a profiler's buffer can lose it

_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}
_KERNEL_PARAMS_BYTES = 128   # CUDA_KERNEL_NODE_PARAMS_v2 is 72
_KERNEL_PARAMS_KERN = 56     # its CUkernel's offset


def demangle(name: str) -> str:
    """``ns::name`` of an Itanium-mangled function name (its nested
    identifiers, without arguments), else ``name``."""
    if not name.startswith("_Z"):
        return name
    i, parts = 3 if name[2:3] == "N" else 2, []
    while i < len(name) and name[i].isdigit():
        j = i
        while j < len(name) and name[j].isdigit():
            j += 1
        n = int(name[i:j])
        parts.append(name[j:j + n])
        i = j + n
    return "::".join("(anonymous namespace)" if p.startswith("_GLOBAL__N")
                     else p for p in parts) or name


def _kernel_name(cu: ctypes.CDLL, node: int) -> str:
    """A kernel node's function name, "kernel" where the driver cannot
    name it."""
    params = (ctypes.c_byte * _KERNEL_PARAMS_BYTES)()
    name = ctypes.c_char_p()
    if cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params) == 0:
        func = ctypes.c_void_p.from_buffer(params, 0).value
        kern = ctypes.c_void_p.from_buffer(params, _KERNEL_PARAMS_KERN).value
        for getter, handle in (("cuFuncGetName", func),
                               ("cuKernelGetName", kern)):
            if handle and hasattr(cu, getter) and getattr(cu, getter)(
                    ctypes.byref(name), ctypes.c_void_p(handle)) == 0:
                return demangle(name.value.decode())
    return "kernel"


def device_activities(fn) -> Dict[str, int]:
    """The device activities of one call of ``fn``, {name: count}: its
    kernels by name, its copies ("memcpy") and sets ("memset"), as a CUDA
    graph captured from the call on the current device holds them.  ``fn``
    is called once before, uncaptured, and must be capturable.  A wrapper
    adds to its ``launches`` also for the captured call, which runs
    nothing."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    err = cu.cuGraphGetNodes(graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    if err == 0:
        err = cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    out: Dict[str, int] = {}
    kind = ctypes.c_int()
    for node in nodes[:n.value]:
        err = cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if err != 0:
            raise RuntimeError(f"cuGraphNodeGetType failed: CUresult {err}")
        if kind.value in _NODE_KINDS:
            name = _NODE_KINDS[kind.value]
            if name == "kernel":
                name = _kernel_name(cu, node)
            out[name] = out.get(name, 0) + 1
    g.reset()
    return out
