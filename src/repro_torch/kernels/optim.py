"""Hopper CUDA kernels for the training step's optimizer path:
error-feedback gradient truncation (``ef_quantize``) and AdamW's update.

The kernels live in ``csrc/optim.cu`` (the note there says what they
replace in the reference, what bounds them and what the design does about
it): ``ef_amax`` and ``ef_apply``, the two passes of one ``ef_quantize``
of a leaf, and ``adamw_update``, one pass a leaf.  They are built with the
other kernels (``bitplane.load``: ``nvcc`` for ``sm_90a`` at first use,
every source at once) and loaded with ``ctypes``.  Nothing is compiled or
loaded when this module is imported.

Two operators of the dispatcher, ``torch.ops.repro_torch.ef_quantize`` and
``torch.ops.repro_torch.adamw_update`` (``torch.library.custom_op``s), as
the other kernels are: the CUDA implementation allocates the outputs (and
``ef_quantize``'s workspace, one float32 word a block of ``ef_amax``,
declared in ``bitplane.WORKSPACE`` so that ``OpAnalysis`` counts it),
launches on the current stream, raises if ``cudaGetLastError()`` is not 0
and adds one to the kernel's ``launches`` (the record of
``bitplane.launches()``: ``ef_quantize`` counts one ``ef_amax`` and one
``ef_apply``); the fake gives the outputs' shapes and dtypes, so that the
operators run on ``meta``; the CPU implementation is the plain version.
A CUDA call that no dispatch mode observes launches directly.

The plain versions: ``ef_quantize_ref`` computes the kernels' formula
(``csrc/optim.cu``) in torch, element by element, and is held bit-identical
to ``distributed.grad_compress``'s plane path (which encodes and decodes
the planes), and so to the reference; ``adamw_update_ref`` is
``optim.adamw._upd``.  ``distributed.grad_compress.ef_quantize`` and
``optim.adamw.update`` take the operators on CUDA and ``meta`` tensors
(``use_operators``) and keep their plain paths on the CPU and with
``backend="torch"``.  On a CUDA tensor the operators launch or raise:
there is no fallback.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.core.align import (_exp2_table, _sat_u32, exp2_int,
                                    flush_subnormal)
from repro_torch.kernels import bitplane as _bp
from repro_torch.tune.config import BACKENDS

THREADS = 256            # csrc/optim.cu kThreads
MAX_BLOCKS = 8 * 132     # 8 blocks of THREADS on each of the H100's SMs
MAG_BITS = 23
SYMBOLS = ("ef_amax", "ef_apply", "adamw_update")
PARAM_DTYPES = (torch.float32, torch.bfloat16)

_lock = threading.Lock()
_ready = False


def _lib() -> ctypes.CDLL:
    global _ready
    lib = _bp.library("optim")
    with _lock:
        if not _ready:
            vp, ll_, i, f = (ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_int, ctypes.c_float)
            lib.ef_amax.argtypes = [vp, vp, vp, ll_, i, vp]
            lib.ef_apply.argtypes = [vp, vp, vp, i, vp, vp, vp, ll_, i, i,
                                     vp]
            lib.adamw_update.argtypes = ([vp] * 11 + [ll_, i] + [f] * 6
                                         + [i, vp])
            for name in SYMBOLS:
                getattr(lib, name).restype = i
            _ready = True
    return lib


def _on_operators(t: torch.Tensor) -> bool:
    """Whether a tensor on ``t``'s device takes the operators under
    ``backend="auto"``: the card and ``meta``; the CPU keeps the plain
    paths (the dry run's real world routes its CPU tensors through the
    operators, whose CPU kernels are the plain versions)."""
    return t.device.type in ("cuda", "meta")


def use_operators(t: torch.Tensor, backend: str) -> bool:
    """True: the operators; False: the caller's plain path.  ``"torch"``
    is the plain path everywhere; ``"cuda"`` raises on a CPU tensor."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of "
                         f"{BACKENDS})")
    if backend == "torch":
        return False
    if backend == "cuda" and t.device.type not in ("cuda", "meta"):
        raise ValueError(f"backend='cuda' needs a CUDA tensor, got "
                         f"{t.device}")
    return _on_operators(t)


def blocks(n: int) -> int:
    """The grid of a pass over ``n`` values: a thread for every 4 values up
    to MAX_BLOCKS blocks, then grid-stride."""
    return max(1, min(-(-n // (4 * THREADS)), MAX_BLOCKS))


def _f32(x: float) -> float:
    """The float32 value torch's binary operators give the Python scalar
    ``x`` beside a float32 tensor (a wrapped number cast once)."""
    return float(np.float32(x))


def _check(what: str, ts, dtypes) -> None:
    dev = ts[0].device
    if dev.type not in ("cuda", "meta", "cpu"):
        raise ValueError(f"{what}: expected CUDA, meta or CPU tensors, got "
                         f"{dev}")
    for t, allowed in zip(ts, dtypes):
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
        if t.dtype not in allowed:
            raise TypeError(f"{what}: expected one of {allowed}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def _check_leaf(what: str, ts, dtypes) -> None:
    _check(what, ts, dtypes)
    for t in ts[1:]:
        if t.shape != ts[0].shape:
            raise ValueError(f"{what}: shapes {tuple(ts[0].shape)} and "
                             f"{tuple(t.shape)}")
    if ts[0].numel() == 0:
        raise ValueError(f"{what}: empty input")


def _check_planes(planes: int) -> None:
    if not 1 <= planes <= MAG_BITS:
        raise ValueError(f"planes must be in 1..{MAG_BITS}, got {planes}")


def _run(symbol: str, like: torch.Tensor, *args) -> None:
    """Launch ``symbol`` with ``args`` (tensors as pointers; ctypes converts
    the rest by the symbol's argtypes) on ``like``'s device and current
    stream; raise on a failed launch, count a good one."""
    fn = getattr(_lib(), symbol)
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        err = fn(*vals, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")
    _bp._count(symbol)


# ------------------------------------------------------- the ef workspace --

def ef_workspace(x, r, planes):
    """``ef_amax``'s maxima, one float32 word a block, which ``ef_apply``
    reads."""
    return {"amax_part": (blocks(x.numel()),)}


# ------------------------------------------------ CUDA implementations --

def _launch_ef_amax(x, r):
    part = x.new_empty(ef_workspace(x, r, 1)["amax_part"])
    _run("ef_amax", x, x, r, part, x.numel(), part.numel())
    return part


def _launch_ef_apply(x, r, part, planes):
    q, r_out = torch.empty_like(x), torch.empty_like(x)
    _run("ef_apply", x, x, r, part, part.numel(), _exp2_table(x.device), q,
         r_out, x.numel(), planes, blocks(x.numel()))
    return q, r_out


def _launch_ef_quantize(x, r, planes):
    return _launch_ef_apply(x, r, _launch_ef_amax(x, r), planes)


def _launch_adamw(p, g, m, v, scale, lr, c1, c2, b1, b2, eps, weight_decay):
    new_p, new_m, new_v = (torch.empty_like(t) for t in (p, m, v))
    bf16 = sum(1 << i for i, t in enumerate((p, g, m))
               if t.dtype == torch.bfloat16)
    _run("adamw_update", p, p, g, m, v, scale, lr, c1, c2, new_p, new_m,
         new_v, p.numel(), bf16, _f32(b1), _f32(1 - b1), _f32(b2),
         _f32(1 - b2), _f32(eps), _f32(weight_decay), blocks(p.numel()))
    return new_p, new_m, new_v


# --------------------------------------------------------- plain versions --

def _ef_total(x, r):
    return flush_subnormal(flush_subnormal(x) + flush_subnormal(r))


def ef_amax_ref(x, r):
    """``ef_amax``'s maximum: max |flush(flush(x) + flush(r))| (NaN if any
    is NaN)."""
    return torch.max(torch.abs(_ef_total(x, r)))


def ef_quantize_ref(x, r, planes):
    """The kernels' formula in torch (``csrc/optim.cu``): (q, flush(total -
    q)) with q the sign and the magnitude bits that the sign plane and the
    top ``planes`` magnitude planes keep, decoded at the midpoint of the
    truncated tail."""
    total = _ef_total(x, r)
    amax = torch.max(torch.abs(total))
    _, e = torch.frexp(amax)
    e = torch.where(amax > 0, e, torch.zeros_like(e))
    scale = exp2_int(MAG_BITS - e)
    k = torch.round(total * scale)
    mag = _sat_u32(torch.abs(k)).to(torch.int64) & 0xFFFFFFFF
    tail = MAG_BITS - planes
    keep = ((1 << MAG_BITS) - 1) & ~((1 << tail) - 1)
    half = (1 << (tail - 1)) if tail else 0
    val = flush_subnormal(((mag & keep) + half).to(torch.float32) / scale)
    q = torch.where(k < 0, -val, val)
    return q, flush_subnormal(total - q)


def adamw_update_ref(p, g, m, v, scale, lr, c1, c2, b1, b2, eps,
                     weight_decay):
    """``optim.adamw._upd`` with these hyper-parameters."""
    from repro_torch.optim import adamw
    cfg = adamw.AdamWConfig(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return adamw._upd(p, g, m, v, scale, lr, c1, c2, cfg, m.dtype)


# -------------------------------------------------------------- operators --

Tensor = torch.Tensor


def _define():
    ns = "repro_torch::"

    @torch.library.custom_op(ns + "ef_quantize", mutates_args=(),
                             device_types="cuda")
    def ef_op(x: Tensor, r: Tensor, planes: int) -> Tuple[Tensor, Tensor]:
        return _launch_ef_quantize(x, r, planes)

    @torch.library.custom_op(ns + "adamw_update", mutates_args=(),
                             device_types="cuda")
    def adamw_op(p: Tensor, g: Tensor, m: Tensor, v: Tensor, scale: Tensor,
                 lr: Tensor, c1: Tensor, c2: Tensor, b1: float, b2: float,
                 eps: float, weight_decay: float
                 ) -> Tuple[Tensor, Tensor, Tensor]:
        return _launch_adamw(p, g, m, v, scale, lr, c1, c2, b1, b2, eps,
                             weight_decay)

    ef_op.register_fake(lambda x, r, planes: (torch.empty_like(x),
                                              torch.empty_like(x)))
    adamw_op.register_fake(
        lambda p, g, m, v, *args: tuple(torch.empty_like(t)
                                        for t in (p, m, v)))
    ef_op.register_kernel("cpu")(ef_quantize_ref)
    adamw_op.register_kernel("cpu")(adamw_update_ref)
    return {"ef_quantize": torch.ops.repro_torch.ef_quantize.default,
            "adamw_update": torch.ops.repro_torch.adamw_update.default}


_OPS = _define()
_LAUNCH = {"ef_quantize": _launch_ef_quantize, "adamw_update": _launch_adamw}
_bp.add_workspace({_OPS["ef_quantize"]: ef_workspace})


def _call(name: str, *args):
    """Through the operator wherever something observes the dispatcher or
    the tensors lie on the CPU; a CUDA call that nothing observes launches
    directly (``bitplane._call``)."""
    if args[0].device.type == "cuda" and _get_current_dispatch_mode() is None:
        return _LAUNCH[name](*args)
    with torch._C._AutoDispatchBelowADInplaceOrView():
        return _OPS[name](*args)


# --------------------------------------------------------------- wrappers --

def ef_quantize(x: torch.Tensor, r: torch.Tensor, planes: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``x`` and residual ``r`` of one shape -> (q, new residual):
    ``ef_amax`` then ``ef_apply`` on the card (the fake on ``meta``, the
    plain version on the CPU)."""
    _check_leaf("ef_quantize", (x, r), ((torch.float32,),) * 2)
    _check_planes(planes)
    return _call("ef_quantize", x, r, int(planes))


def ef_amax(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The ``ef_amax`` kernel alone, on the card: the (``blocks(N)``,)
    float32 maxima that ``ef_apply`` reduces (their largest is
    ``ef_amax_ref``'s value)."""
    _check_leaf("ef_amax", (x, r), ((torch.float32,),) * 2)
    if x.device.type != "cuda":
        raise ValueError(f"ef_amax: expected CUDA tensors, got {x.device}")
    return _launch_ef_amax(x, r)


def ef_apply(x: torch.Tensor, r: torch.Tensor, part: torch.Tensor,
             planes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``ef_apply`` kernel alone, on the card, from ``ef_amax``'s
    maxima ``part``: (q, new residual)."""
    _check_leaf("ef_apply", (x, r), ((torch.float32,),) * 2)
    _check("ef_apply", (x, part), ((torch.float32,),) * 2)
    _check_planes(planes)
    if x.device.type != "cuda" or part.dim() != 1 or part.numel() < 1:
        raise ValueError("ef_apply: expected CUDA tensors and ef_amax's "
                         "1-d maxima")
    return _launch_ef_apply(x, r, part, int(planes))


def adamw_update(p, g, m, v, scale, lr, c1, c2, b1: float, b2: float,
                 eps: float, weight_decay: float):
    """One AdamW step of a leaf: parameters ``p`` and gradient ``g``
    (float32 or bfloat16 each), moments ``m`` and ``v`` (both float32 or
    both bfloat16), and the 0-d float32 clip factor, learning rate and bias
    corrections -> (new p, new m, new v) in the dtypes they came in."""
    _check_leaf("adamw_update", (p, g, m, v),
                (PARAM_DTYPES, PARAM_DTYPES, PARAM_DTYPES, (m.dtype,)))
    _check("adamw_update", (p, scale, lr, c1, c2),
           (PARAM_DTYPES,) + ((torch.float32,),) * 4)
    if any(s.dim() != 0 for s in (scale, lr, c1, c2)):
        raise ValueError("adamw_update: scale, lr, c1, c2 must be 0-d")
    return _call("adamw_update", p, g, m, v, scale, lr, c1, c2, float(b1),
                 float(b2), float(eps), float(weight_decay))


WRAPPERS = (ef_amax, ef_apply, adamw_update)
_bp.add_counters(dict(zip(SYMBOLS, WRAPPERS)))
