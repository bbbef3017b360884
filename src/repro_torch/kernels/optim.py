"""Hopper CUDA kernels for the training step's optimizer path:
error-feedback gradient truncation (``ef_quantize``), AdamW's update and
the sums of squares of AdamW's global norm.

The kernels live in ``csrc/optim.cu`` (the note there says what they
replace in the reference, what bounds them and what the design does about
it): ``ef_amax`` and ``ef_apply``, the two passes of one ``ef_quantize``
of a leaf; ``adamw_update``, one pass a leaf; and ``global_sumsq``, one
pass over every leaf of a gradient tree in a fixed order (chunks of
``SUM_CHUNK`` values, each summed by a block, then each leaf's chunks by
a block).  They are built with the other kernels (``bitplane.load``:
``nvcc`` for ``sm_90a`` at first use, every source at once) and loaded
with ``ctypes``.  Nothing is compiled or loaded when this module is
imported.

Three operators of the dispatcher, ``torch.ops.repro_torch.ef_quantize``,
``torch.ops.repro_torch.adamw_update`` and
``torch.ops.repro_torch.global_sumsq`` (``torch.library.custom_op``s), as
the other kernels are: the CUDA implementation allocates the outputs (and
the workspace: ``ef_quantize``'s, one float32 word a block of
``ef_amax``; ``global_sumsq``'s, a float64 partial a chunk; declared in
``bitplane.WORKSPACE`` so that ``OpAnalysis`` counts it), launches on the
current stream, raises if ``cudaGetLastError()`` is not 0 and adds one to
the kernel's ``launches`` (the record of ``bitplane.launches()``:
``ef_quantize`` counts one ``ef_amax`` and one ``ef_apply``;
``global_sumsq`` one a block of ``SUM_LEAVES`` leaves that holds a
value); the fake gives the outputs' shapes and dtypes, so that the
operators run on ``meta``; the CPU implementation is the plain version.
A CUDA call that no dispatch mode observes launches directly.

The plain versions: ``ef_quantize_ref`` computes the kernels' formula
(``csrc/optim.cu``) in torch, element by element, and is held bit-identical
to ``distributed.grad_compress``'s plane path (which encodes and decodes
the planes), and so to the reference; ``adamw_update_ref`` is
``optim.adamw._upd``; ``global_sumsq_ref`` is ``optim.adamw``'s chain (a
float64 copy of each leaf, squared and summed in torch's order), which
the kernel's fixed order meets within rounding (``global_sumsq_tiled``
follows the kernel's order on the CPU).
``distributed.grad_compress.ef_quantize``, ``optim.adamw.update`` and
``optim.adamw.global_norm`` take the operators on CUDA and ``meta``
tensors (``use_operators``) and keep their plain paths on the CPU and
with ``backend="torch"``.  On a CUDA tensor the operators launch or
raise: there is no fallback.
"""
from __future__ import annotations

import ctypes
import threading
from typing import List, Tuple

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
SUM_CHUNK = 65536        # kSumChunk: the values a global_sumsq block sums
SUM_LEAVES = 64          # kSumLeaves: leaves an argument block
SYMBOLS = ("ef_amax", "ef_apply", "adamw_update", "global_sumsq")
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
            lib.global_sumsq.argtypes = [ctypes.POINTER(ll_),
                                         ctypes.POINTER(ll_),
                                         ctypes.POINTER(i), i, vp, vp, vp]
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


def sumsq_workspace(leaves):
    """``global_sumsq``'s partials: one float64 a chunk of ``SUM_CHUNK``
    values of each leaf."""
    return {"partials": ((sum(-(-g.numel() // SUM_CHUNK) for g in leaves),),
                         torch.float64)}


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


def _launch_sumsq(leaves):
    dev = leaves[0].device
    out = torch.empty((len(leaves),), dtype=torch.float64, device=dev)
    shape, dt = sumsq_workspace(leaves)["partials"]
    partials = torch.empty(shape, dtype=dt, device=dev)
    lib = _lib()
    chunk = 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k0 in range(0, len(leaves), SUM_LEAVES):
            blk = leaves[k0:k0 + SUM_LEAVES]
            k = len(blk)
            ns = [g.numel() for g in blk]
            err = lib.global_sumsq(
                (ctypes.c_longlong * k)(*[g.data_ptr() for g in blk]),
                (ctypes.c_longlong * k)(*ns),
                (ctypes.c_int * k)(*[int(g.dtype == torch.bfloat16)
                                     for g in blk]),
                k, partials.data_ptr() + 8 * chunk,
                out.data_ptr() + 8 * k0, stream)
            if err != 0:
                raise RuntimeError(f"global_sumsq launch failed: cudaError "
                                   f"{err}")
            held = sum(-(-n // SUM_CHUNK) for n in ns)
            if held:
                _bp._count("global_sumsq")
            chunk += held
    return out


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


def global_sumsq_ref(leaves):
    """Each leaf's sum of squares in float64, ``optim.adamw``'s chain."""
    from repro_torch.optim import adamw
    return torch.stack(adamw._sumsq_plain(leaves))


def _tree_sum(x):
    """The kernels' fixed tree over the last axis (32 or 8 values): halves
    added, the lower half first."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _block_sum(v):
    """``block_sum_fixed`` over the last axis (``THREADS`` threads): each
    warp's tree, then the tree over the warps."""
    warps = _tree_sum(v.reshape(*v.shape[:-1], THREADS // 32, 32))
    return _tree_sum(warps)


def _thread_sums(v, width):
    """Each thread's float64 sum of the (rows, THREADS * k * width) values
    ``v``: vector (it * THREADS + thread) of ``width`` values at step it,
    added in order from 0.0: (rows, THREADS)."""
    rows = v.shape[0]
    seq = v.view(rows, -1, THREADS, width).permute(0, 2, 1, 3).reshape(
        rows, THREADS, -1)
    acc = torch.zeros((rows, THREADS), dtype=torch.float64)
    for i in range(seq.shape[2]):
        acc = acc + seq[:, :, i]
    return acc


def global_sumsq_tiled(leaves):
    """``global_sumsq`` as its kernels compute it, on the CPU: each leaf cut
    into chunks of ``SUM_CHUNK`` values (the last zero-padded); a chunk's
    thread sums of squares (``_thread_sums`` over 16-byte vectors: 4
    float32 or 8 bfloat16 values) and the block's tree give its partial;
    each leaf's partials, thread i taking partials i, i + ``THREADS``,
    ..., and the tree give its sum.  (L,) float64."""
    out = []
    for g in leaves:
        x = g.reshape(-1)
        chunks = -(-x.numel() // SUM_CHUNK)
        if not chunks:
            out.append(torch.zeros((), dtype=torch.float64))
            continue
        x = torch.nn.functional.pad(x.double(), (0, chunks * SUM_CHUNK
                                                 - x.numel()))
        part = _block_sum(_thread_sums(torch.square(x).view(chunks, -1),
                                       16 // g.element_size()))
        part = torch.nn.functional.pad(part, (0, -chunks % THREADS))
        out.append(_block_sum(_thread_sums(part.view(1, -1), 1))[0])
    return torch.stack(out)


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

    @torch.library.custom_op(ns + "global_sumsq", mutates_args=(),
                             device_types="cuda")
    def sumsq_op(leaves: List[Tensor]) -> Tensor:
        return _launch_sumsq(leaves)

    ef_op.register_fake(lambda x, r, planes: (torch.empty_like(x),
                                              torch.empty_like(x)))
    sumsq_op.register_fake(lambda leaves: leaves[0].new_empty(
        (len(leaves),), dtype=torch.float64))
    adamw_op.register_fake(
        lambda p, g, m, v, *args: tuple(torch.empty_like(t)
                                        for t in (p, m, v)))
    ef_op.register_kernel("cpu")(ef_quantize_ref)
    adamw_op.register_kernel("cpu")(adamw_update_ref)
    sumsq_op.register_kernel("cpu")(global_sumsq_ref)
    return {"ef_quantize": torch.ops.repro_torch.ef_quantize.default,
            "adamw_update": torch.ops.repro_torch.adamw_update.default,
            "global_sumsq": torch.ops.repro_torch.global_sumsq.default}


_OPS = _define()
_LAUNCH = {"ef_quantize": _launch_ef_quantize, "adamw_update": _launch_adamw,
           "global_sumsq": _launch_sumsq}
_bp.add_workspace({_OPS["ef_quantize"]: ef_workspace,
                   _OPS["global_sumsq"]: sumsq_workspace})


def _call(name: str, *args):
    """Through the operator wherever something observes the dispatcher or
    the tensors lie on the CPU; a CUDA call that nothing observes launches
    directly (``bitplane._call``)."""
    first = args[0][0] if isinstance(args[0], list) else args[0]
    if first.device.type == "cuda" and _get_current_dispatch_mode() is None:
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


def global_sumsq(leaves) -> torch.Tensor:
    """Each of the leaves' (at least one; float32 or bfloat16, contiguous,
    on one device, any shape, empty allowed) sum of squares in float64, as
    a (L,) tensor: on the card summed in the kernels' fixed order, the
    same bits on every call."""
    leaves = list(leaves)
    if not leaves:
        raise ValueError("global_sumsq: no leaves")
    _check("global_sumsq", leaves, (PARAM_DTYPES,) * len(leaves))
    return _call("global_sumsq", leaves)


WRAPPERS = (ef_amax, ef_apply, adamw_update, global_sumsq)
_bp.add_counters(dict(zip(SYMBOLS, WRAPPERS)))
