"""Hopper CUDA kernels for the SSM scans: RWKV6's wkv and Mamba's selective
scan, forward and backward.

The kernels live in ``csrc/scan.cu`` (the note there says what they replace
in the reference, what bounds them and what the design does about it):
``wkv6_fwd``/``wkv6_bwd`` for ``models.ssm.rwkv_time_mix_apply`` and
``mamba_scan_fwd``/``mamba_scan_bwd`` for ``models.ssm.mamba_apply``, each
the counterpart of one compiled ``lax.scan`` of the reference.  They are
built with the bitplane kernels (``bitplane.load``: ``nvcc`` for
``sm_90a`` at first use, every source at once) and loaded with ``ctypes``.
Nothing is compiled or loaded when this module is imported.

Each kernel is an operator of the dispatcher, ``torch.ops.repro_torch.<name>``
(a ``torch.library.custom_op``), as the bitplane kernels are: its CUDA
implementation allocates its outputs and the backward's workspace (the
shapes ``*_bwd_workspace`` give, declared in ``bitplane.WORKSPACE`` so that
``OpAnalysis`` counts them) with ``torch.empty``, launches on the current
stream, raises if ``cudaGetLastError()`` is not 0 and adds one to its
wrapper's ``launches`` (the record of ``bitplane.launches()``); its fake
gives every output's shape, the kept chunk states included, so that it runs
on ``meta`` and ``launch.op_analysis.OpAnalysis`` counts its bytes; its CPU
implementation is its plain version (below).  A CUDA call that no dispatch mode observes
launches directly.  Each has a FLOP formula (``register_flop_formula``)
equal to what ``FlopCounterMode`` counts for the loop's ``einsum``s, so the
dry run's FLOPs stay the loop's count: the forward's, and for the backward
the loop's backward plus, where the loop chunks (a length that is a
multiple of ``chunk`` longer than one chunk), its checkpointed recompute
(less what ``checkpoint`` skips: the products after a chunk's last saved
tensor).  The kernels' own recompute, which runs at every length, is
counted only so far.

``wkv6`` and ``mamba_scan`` are the differentiable scans the models call: a
``torch.autograd.Function`` whose forward keeps only its inputs and the
states entering each chunk of ``chunk`` steps (``ssm.REMAT_CHUNK``), and
whose backward is the backward kernel, which recomputes each chunk from its
kept state (the reference's ``jax.checkpoint`` around its inner scan).
Without autograd the forward keeps no state.

The plain versions, which only the tests and ``chip_smoke.py`` call: the
forwards run ``models.ssm._steps`` with the layers' own step functions (the
loop the CPU runs, held bit-identical to the reference), the backwards
(``wkv6_bwd_ref``, ``mamba_scan_bwd_ref``) are explicit reverse recurrences
in torch that mirror the kernels' math.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import bitplane as _bp

HEAD = 64                 # RWKV6's head size (K = V), the kernel's only one
MAX_CHUNK = 64            # csrc/scan.cu kMaxChunk
MAX_STATE = 32            # the selective scan's largest d_state
BWD_THREADS = 128         # csrc/scan.cu kBwdThreads
CLUSTER = 8               # csrc/scan.cu kCluster
SYMBOLS = ("wkv6_fwd", "wkv6_bwd", "mamba_scan_fwd", "mamba_scan_bwd")

_lock = threading.Lock()
_ready = False


def _lib() -> ctypes.CDLL:
    global _ready
    lib = _bp.library("scan")
    with _lock:
        if not _ready:
            vp, i = ctypes.c_void_p, ctypes.c_int
            for name, n_ptrs, n_ints in (("wkv6_fwd", 9, 5),
                                         ("wkv6_bwd", 15, 4),
                                         ("mamba_scan_fwd", 9, 6),
                                         ("mamba_scan_bwd", 17, 5)):
                fn = getattr(lib, name)
                fn.argtypes = [vp] * n_ptrs + [i] * n_ints + [vp]
                fn.restype = i
            lib.mamba_scan_fwd_split.argtypes = [i] + [vp] * 9 + [i] * 6 + [vp]
            lib.mamba_scan_fwd_split.restype = i
            lib.mamba_scan_tiles.argtypes = [i, i]
            lib.mamba_scan_tiles.restype = i
            lib.mamba_scan_fwd_pick.argtypes = [i, i, i]
            lib.mamba_scan_fwd_pick.restype = i
            _ready = True
    return lib


def _chunks(t: int, chunk: int) -> int:
    return -(-t // chunk)


def _check(what: str, ts, chunk: int) -> None:
    dev = ts[0].device
    if dev.type not in ("cuda", "meta", "cpu"):
        raise ValueError(f"{what}: expected CUDA, meta or CPU tensors, got "
                         f"{dev}")
    dtypes = ((torch.float32,) if dev.type != "cpu"
              else (torch.float32, torch.float64))
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
        if t.dtype not in dtypes or t.dtype != ts[0].dtype:
            raise TypeError(f"{what}: expected {ts[0].dtype} in {dtypes} "
                            f"for every tensor, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    if ts[0].numel() == 0:
        raise ValueError(f"{what}: empty input {tuple(ts[0].shape)}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"{what}: chunk {chunk} outside [1, {MAX_CHUNK}]")


def _shape(what: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _check_wkv6(what, r, k, v, w, u, state, chunk, states=None, dout=None):
    ts = (r, k, v, w, u, state) + tuple(t for t in (states, dout)
                                        if t is not None)
    _check(what, ts, chunk)
    if r.dim() != 4 or r.shape[3] != HEAD:
        raise ValueError(f"{what}: r must be (B, S, H, {HEAD}), got "
                         f"{tuple(r.shape)}")
    b, s, h, _ = r.shape
    for t in (k, v, w) + ((dout,) if dout is not None else ()):
        _shape(what, t, r.shape)
    _shape(what, u, (h, HEAD))
    _shape(what, state, (b, h, HEAD, HEAD))
    if states is not None:
        _shape(what, states, (b, _chunks(s, chunk), h, HEAD, HEAD))


def _check_mamba(what, x, dt, bm, cm, a, state, chunk, states=None,
                 dy=None):
    ts = (x, dt, bm, cm, a, state) + tuple(t for t in (states, dy)
                                           if t is not None)
    _check(what, ts, chunk)
    if x.dim() != 3 or a.dim() != 2:
        raise ValueError(f"{what}: x must be (B, S, D) and A (D, N), got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    b, s, d = x.shape
    n = a.shape[1]
    if not 1 <= n <= MAX_STATE or a.shape[0] != d:
        raise ValueError(f"{what}: A must be ({d}, N) with N in [1, "
                         f"{MAX_STATE}], got {tuple(a.shape)}")
    for t in (dt,) + ((dy,) if dy is not None else ()):
        _shape(what, t, x.shape)
    _shape(what, bm, (b, s, n))
    _shape(what, cm, (b, s, n))
    _shape(what, state, (b, d, n))
    if states is not None:
        _shape(what, states, (b, _chunks(s, chunk), d, n))


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _run(symbol: str, like: torch.Tensor, *args, kernel=None) -> None:
    """Launch ``symbol`` with ``args`` (tensors as pointers, ints as ints)
    on ``like``'s device and current stream; raise on a failed launch,
    count a good one as a launch of ``kernel`` (``symbol`` by default)."""
    fn = getattr(_lib(), symbol)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
            for a in args]
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        err = fn(*ptrs, stream)
    _raise_on(err, symbol)
    _bp._count(kernel or symbol)


# ------------------------------------------------------- the fakes' shapes --

def _wkv6_fwd_empty(r, s0, chunk, keep):
    b, s, h, _ = r.shape
    return (torch.empty_like(r), torch.empty_like(s0),
            r.new_empty((b, _chunks(s, chunk) if keep else 0, h, HEAD, HEAD)))


def _wkv6_bwd_empty(r, u, ds_final):
    return (*(torch.empty_like(r) for _ in range(4)), torch.empty_like(u),
            torch.empty_like(ds_final))


def _mamba_fwd_empty(x, a, h0, chunk, keep):
    b, s, d = x.shape
    return (torch.empty_like(x), torch.empty_like(h0),
            x.new_empty((b, _chunks(s, chunk) if keep else 0, d,
                         a.shape[1])))


def _mamba_bwd_empty(x, bm, a, dh_final):
    return (torch.empty_like(x), torch.empty_like(x), torch.empty_like(bm),
            torch.empty_like(bm), torch.empty_like(a),
            torch.empty_like(dh_final))


# ------------------------------------------------ the backwards' workspace --
# What a backward's CUDA implementation allocates beyond its outputs and
# frees when it returns, by name and shape (float32, as its inputs), from
# the operator's inputs: the launcher allocates exactly this, and
# ``launch.op_analysis.OpAnalysis`` counts it, through ``WORKSPACE``, as
# live for the length of the call.

def _mamba_tiles(d: int, n: int) -> int:
    """The clusters of blocks across ``d`` channels in the selective scan's
    backward (``csrc/scan.cu`` ``bwd_tiles``: kBwdThreads / L channels a
    block, kCluster blocks a cluster)."""
    lanes = 8 if n <= 8 else (16 if n <= 16 else 32)
    blocks = -(-d // (BWD_THREADS // lanes))
    return -(-blocks // CLUSTER)


def wkv6_bwd_workspace(r, k, v, w, u, states, dout, ds_final, chunk):
    """``du_part``: du of each batch row, summed over rows in a fixed
    order."""
    b, _, h, _ = r.shape
    return {"du_part": (b, h, HEAD)}


def mamba_scan_bwd_workspace(x, dt, bm, cm, a, states, dy, dh_final, chunk):
    """dB and dC partials of every step, one set a cluster of blocks, and
    dA of each batch row, all summed in a fixed order."""
    b, s, d = x.shape
    n = a.shape[1]
    tiles = _mamba_tiles(d, n)
    return {"part_db": (b, tiles, s, n), "part_dc": (b, tiles, s, n),
            "part_da": (b, d, n)}


def _workspace(fn, *args):
    """The workspace of a call as tensors like its first input."""
    return {name: args[0].new_empty(shape)
            for name, shape in fn(*args).items()}


# ------------------------------------------------ CUDA implementations --

def _launch_wkv6_fwd(r, k, v, w, u, s0, chunk, keep):
    out, s_final, states = _wkv6_fwd_empty(r, s0, chunk, keep)
    b, s, h, _ = r.shape
    _run("wkv6_fwd", r, r, k, v, w, u, s0, out, s_final, states, b, s, h,
         chunk, int(keep))
    return out, s_final, states


def _launch_wkv6_bwd(r, k, v, w, u, states, dout, ds_final, chunk):
    dr, dk, dv, dw, du, ds0 = _wkv6_bwd_empty(r, u, ds_final)
    b, s, h, _ = r.shape
    ws = _workspace(wkv6_bwd_workspace, r, k, v, w, u, states, dout,
                    ds_final, chunk)
    _run("wkv6_bwd", r, r, k, v, w, u, states, dout, ds_final, dr, dk, dv,
         dw, ws["du_part"], du, ds0, b, s, h, chunk)
    return dr, dk, dv, dw, du, ds0


def _launch_mamba_fwd(x, dt, bm, cm, a, h0, chunk, keep, split=None):
    y, h_final, states = _mamba_fwd_empty(x, a, h0, chunk, keep)
    b, s, d = x.shape
    dims = (b, s, d, a.shape[1], chunk, int(keep))
    if split is None:
        _run("mamba_scan_fwd", x, x, dt, bm, cm, a, h0, y, h_final, states,
             *dims)
    else:
        _run("mamba_scan_fwd_split", x, split, x, dt, bm, cm, a, h0, y,
             h_final, states, *dims, kernel="mamba_scan_fwd")
    return y, h_final, states


def _launch_mamba_bwd(x, dt, bm, cm, a, states, dy, dh_final, chunk):
    dx, ddt, db, dc, da, dh0 = _mamba_bwd_empty(x, bm, a, dh_final)
    b, s, d = x.shape
    n = a.shape[1]
    ws = _workspace(mamba_scan_bwd_workspace, x, dt, bm, cm, a, states, dy,
                    dh_final, chunk)
    _run("mamba_scan_bwd", x, x, dt, bm, cm, a, states, dy, dh_final, dx,
         ddt, ws["part_db"], ws["part_dc"], ws["part_da"], db, dc, da, dh0,
         b, s, d, n, chunk)
    return dx, ddt, db, dc, da, dh0


# --------------------------------------------------------- plain versions --

def wkv6_fwd_ref(r, k, v, w, u, s0, chunk, keep):
    """``models.ssm._steps`` with ``_rwkv_step`` over each chunk of ``chunk``
    steps (the same steps as one loop over the whole, so the same bits):
    ``(out, s_final, states)``, ``states`` the state entering each chunk
    (none without ``keep``)."""
    from repro_torch.models import ssm
    step = functools.partial(ssm._rwkv_step, u[None, :, :, None])
    outs, kept, S = [], [], s0
    for lo in range(0, r.shape[1], chunk):
        if keep:
            kept.append(S)
        S, y = ssm._steps(step, S, *(t[:, lo:lo + chunk]
                                     for t in (r, k, v, w)))
        outs.append(y)
    states = (torch.stack(kept, 1) if keep else
              _wkv6_fwd_empty(r, s0, chunk, False)[2])
    return torch.cat(outs, 1), S, states


def wkv6_bwd_ref(r, k, v, w, u, states, dout, ds_final, chunk):
    """The wkv's gradients ``(dr, dk, dv, dw, du, ds0)`` by the reverse
    recurrence of ``csrc/scan.cu``: each chunk's states recomputed from the
    kept one, then walked back with ``dS`` (the gradient of the state
    entering the step after)."""
    b, s, h, _ = r.shape
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    uu = u[None, :, :, None]
    dS = ds_final.clone()
    for c in reversed(range(states.shape[1])):
        lo = c * chunk
        S = states[:, c]
        seen = []
        for t in range(lo, min(lo + chunk, s)):
            seen.append(S)
            S = (w[:, t, :, :, None] * S
                 + k[:, t, :, :, None] * v[:, t, :, None, :])
        for t in reversed(range(lo, min(lo + chunk, s))):
            S = seen[t - lo]
            rt, kt, vt, wt, gt = (x[:, t] for x in (r, k, v, w, dout))
            kv = kt[..., :, None] * vt[..., None, :]
            A = rt[..., :, None] * gt[..., None, :]
            dr[:, t] = ((S + uu * kv) * gt[..., None, :]).sum(-1)
            dkv = uu * A + dS
            dk[:, t] = (dkv * vt[..., None, :]).sum(-1)
            dv[:, t] = (dkv * kt[..., :, None]).sum(-2)
            dw[:, t] = (dS * S).sum(-1)
            du += (A * kv).sum((0, 3))
            dS = A + wt[..., :, None] * dS
    return dr, dk, dv, dw, du, dS


def mamba_scan_fwd_ref(x, dt, bm, cm, a, h0, chunk, keep):
    """``models.ssm._steps`` with ``_mamba_step`` over each chunk:
    ``(y, h_final, states)`` as :func:`wkv6_fwd_ref` gives them."""
    from repro_torch.models import ssm
    step = functools.partial(ssm._mamba_step, a)
    ys, kept, h = [], [], h0
    for lo in range(0, x.shape[1], chunk):
        if keep:
            kept.append(h)
        h, y = ssm._steps(step, h, *(t[:, lo:lo + chunk]
                                     for t in (x, dt, bm, cm)))
        ys.append(y)
    states = (torch.stack(kept, 1) if keep else
              _mamba_fwd_empty(x, a, h0, chunk, False)[2])
    return torch.cat(ys, 1), h, states


def mamba_scan_bwd_ref(x, dt, bm, cm, a, states, dy, dh_final, chunk):
    """The selective scan's gradients ``(dx, ddt, dB, dC, dA, dh0)`` by the
    reverse recurrence of ``csrc/scan.cu``, ``g`` the gradient of the state
    a step leaves."""
    s = x.shape[1]
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    db, dc = torch.empty_like(bm), torch.empty_like(cm)
    da = torch.zeros_like(a)
    g = dh_final.clone()
    for c in reversed(range(states.shape[1])):
        lo = c * chunk
        seen = [states[:, c]]
        for t in range(lo, min(lo + chunk, s)):
            e = torch.exp(dt[:, t, :, None] * a[None])
            seen.append(e * seen[-1] + (dt[:, t] * x[:, t])[..., None]
                        * bm[:, t, None, :])
        for t in reversed(range(lo, min(lo + chunk, s))):
            e = torch.exp(dt[:, t, :, None] * a[None])
            g = g + dy[:, t, :, None] * cm[:, t, None, :]
            dc[:, t] = (dy[:, t, :, None] * seen[t - lo + 1]).sum(1)
            db[:, t] = (g * (dt[:, t] * x[:, t])[..., None]).sum(1)
            gb = (g * bm[:, t, None, :]).sum(-1)
            q = g * seen[t - lo] * e
            ddt[:, t] = gb * x[:, t] + (q * a).sum(-1)
            dx[:, t] = gb * dt[:, t]
            da += (q * dt[:, t, :, None]).sum(0)
            g = g * e
    return dx, ddt, db, dc, da, g


# -------------------------------------------------------------- operators --

Tensor = torch.Tensor
_T3 = Tuple[Tensor, Tensor, Tensor]
_T6 = Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]


def _define():
    ns = "repro_torch::"

    @torch.library.custom_op(ns + "wkv6_fwd", mutates_args=(),
                             device_types="cuda")
    def wkv6_fwd_op(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                    s0: Tensor, chunk: int, keep: bool) -> _T3:
        return _launch_wkv6_fwd(r, k, v, w, u, s0, chunk, keep)

    @torch.library.custom_op(ns + "wkv6_bwd", mutates_args=(),
                             device_types="cuda")
    def wkv6_bwd_op(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                    states: Tensor, dout: Tensor, ds_final: Tensor,
                    chunk: int) -> _T6:
        return _launch_wkv6_bwd(r, k, v, w, u, states, dout, ds_final, chunk)

    @torch.library.custom_op(ns + "mamba_scan_fwd", mutates_args=(),
                             device_types="cuda")
    def mamba_fwd_op(x: Tensor, dt: Tensor, bm: Tensor, cm: Tensor,
                     a: Tensor, h0: Tensor, chunk: int, keep: bool) -> _T3:
        return _launch_mamba_fwd(x, dt, bm, cm, a, h0, chunk, keep)

    @torch.library.custom_op(ns + "mamba_scan_bwd", mutates_args=(),
                             device_types="cuda")
    def mamba_bwd_op(x: Tensor, dt: Tensor, bm: Tensor, cm: Tensor,
                     a: Tensor, states: Tensor, dy: Tensor, dh_final: Tensor,
                     chunk: int) -> _T6:
        return _launch_mamba_bwd(x, dt, bm, cm, a, states, dy, dh_final,
                                 chunk)

    wkv6_fwd_op.register_fake(
        lambda r, k, v, w, u, s0, chunk, keep:
        _wkv6_fwd_empty(r, s0, chunk, keep))
    wkv6_bwd_op.register_fake(
        lambda r, k, v, w, u, states, dout, ds_final, chunk:
        _wkv6_bwd_empty(r, u, ds_final))
    mamba_fwd_op.register_fake(
        lambda x, dt, bm, cm, a, h0, chunk, keep:
        _mamba_fwd_empty(x, a, h0, chunk, keep))
    mamba_bwd_op.register_fake(
        lambda x, dt, bm, cm, a, states, dy, dh_final, chunk:
        _mamba_bwd_empty(x, bm, a, dh_final))
    # the CPU runs the plain versions (below the autograd layers: each is
    # called from a Function's forward or backward)
    for op, ref in ((wkv6_fwd_op, wkv6_fwd_ref), (wkv6_bwd_op, wkv6_bwd_ref),
                    (mamba_fwd_op, mamba_scan_fwd_ref),
                    (mamba_bwd_op, mamba_scan_bwd_ref)):
        op.register_kernel("cpu")(ref)
    return {s: getattr(torch.ops.repro_torch, s).default for s in SYMBOLS}


_OPS = _define()
_LAUNCH = {"wkv6_fwd": _launch_wkv6_fwd, "wkv6_bwd": _launch_wkv6_bwd,
           "mamba_scan_fwd": _launch_mamba_fwd,
           "mamba_scan_bwd": _launch_mamba_bwd}
_bp.add_workspace({_OPS["wkv6_bwd"]: wkv6_bwd_workspace,
                   _OPS["mamba_scan_bwd"]: mamba_scan_bwd_workspace})


def _recomputes(s: int, chunk: int) -> bool:
    """Whether the loop recomputes its steps in the backward: chunks under
    ``checkpoint`` (``ssm._scan``'s rule)."""
    return s % chunk == 0 and s > chunk


def _wkv6_flops(r) -> int:
    b, s, h, k = r
    return 2 * b * s * h * k * k          # a (1, K) x (K, V) bmm a step


def _mamba_flops(x, n) -> int:
    b, s, d = x
    return 2 * b * s * d * n              # a (D, N) x (N, 1) bmm a step


register_flop_formula(torch.ops.repro_torch.wkv6_fwd)(
    lambda r, *args, out_shape=None: _wkv6_flops(r))
register_flop_formula(torch.ops.repro_torch.wkv6_bwd)(
    lambda r, k, v, w, u, states, dout, ds_final, chunk, out_shape=None:
    (3 if _recomputes(r[1], chunk) else 2) * _wkv6_flops(r))
register_flop_formula(torch.ops.repro_torch.mamba_scan_fwd)(
    lambda x, dt, bm, *args, out_shape=None: _mamba_flops(x, bm[2]))

@register_flop_formula(torch.ops.repro_torch.mamba_scan_bwd)
def _mamba_bwd_flops(x, dt, bm, cm, a, states, dy, dh_final, chunk,
                     out_shape=None) -> int:
    """The loop's backward (2x its forward) and, where it chunks, the
    checkpoint's recompute, which stops at the last tensor the backward
    saved: a chunk's last ``y`` product (after its last state) is not
    recomputed."""
    fwd = _mamba_flops(x, bm[2])
    if not _recomputes(x[1], chunk):
        return 2 * fwd
    b, s, d = x
    return 3 * fwd - (s // chunk) * _mamba_flops((b, 1, d), bm[2])


def _call(symbol: str, *args):
    """Through the operator wherever something observes the dispatcher (a
    dispatch mode, a ``meta`` tensor) or the tensors lie on the CPU (its
    plain version); a CUDA call that nothing observes launches directly
    (``bitplane._call``)."""
    if args[0].device.type == "cuda" and _get_current_dispatch_mode() is None:
        return _LAUNCH[symbol](*args)
    with torch._C._AutoDispatchBelowADInplaceOrView():
        return _OPS[symbol](*args)


# --------------------------------------------------------------- wrappers --

def wkv6_fwd(r, k, v, w, u, s0, chunk: int, keep: bool):
    """r, k, v, w: (B, S, H, 64); u: (H, 64); s0: (B, H, 64, 64) ->
    ``(out (B, S, H, 64), s_final, states)``, ``states`` (B, ceil(S /
    chunk), H, 64, 64) with ``keep`` (the state entering each chunk), else
    (B, 0, H, 64, 64)."""
    _check_wkv6("wkv6_fwd", r, k, v, w, u, s0, chunk)
    return _call("wkv6_fwd", r, k, v, w, u, s0, chunk, bool(keep))


def wkv6_bwd(r, k, v, w, u, states, dout, ds_final, chunk: int):
    """``wkv6_fwd``'s inputs, its kept ``states`` and the gradients of
    ``out`` and ``s_final`` -> ``(dr, dk, dv, dw, du, ds0)``."""
    _check_wkv6("wkv6_bwd", r, k, v, w, u, ds_final, chunk, states, dout)
    return _call("wkv6_bwd", r, k, v, w, u, states, dout, ds_final, chunk)


def mamba_scan_fwd(x, dt, bm, cm, a, h0, chunk: int, keep: bool):
    """x, dt: (B, S, D); bm, cm: (B, S, N); a: (D, N); h0: (B, D, N) ->
    ``(y (B, S, D), h_final, states)``, ``states`` (B, ceil(S / chunk), D,
    N) with ``keep``, else (B, 0, D, N)."""
    _check_mamba("mamba_scan_fwd", x, dt, bm, cm, a, h0, chunk)
    return _call("mamba_scan_fwd", x, dt, bm, cm, a, h0, chunk, bool(keep))


def mamba_scan_fwd_at_split(split: int, x, dt, bm, cm, a, h0, chunk: int,
                            keep: bool):
    """``mamba_scan_fwd`` on the card with ``split`` (1 or 2) states a
    thread, whatever the kernel's own rule (``fwd_split``) would pick: for
    timing both splits at one shape (``chip_smoke.py`` phase 20 (a), the
    card tests); the models never call it."""
    _check_mamba("mamba_scan_fwd_at_split", x, dt, bm, cm, a, h0, chunk)
    if split not in (1, 2) or x.device.type != "cuda":
        raise ValueError(f"mamba_scan_fwd_at_split: split {split} on "
                         f"{x.device}: expected 1 or 2 on a CUDA device")
    return _launch_mamba_fwd(x, dt, bm, cm, a, h0, chunk, bool(keep), split)


def mamba_scan_bwd(x, dt, bm, cm, a, states, dy, dh_final, chunk: int):
    """``mamba_scan_fwd``'s inputs, its kept ``states`` and the gradients of
    ``y`` and ``h_final`` -> ``(dx, ddt, dB, dC, dA, dh0)``."""
    _check_mamba("mamba_scan_bwd", x, dt, bm, cm, a, dh_final, chunk, states,
                 dy)
    return _call("mamba_scan_bwd", x, dt, bm, cm, a, states, dy, dh_final,
                 chunk)


WRAPPERS = (wkv6_fwd, wkv6_bwd, mamba_scan_fwd, mamba_scan_bwd)
PLAIN = dict(zip(SYMBOLS, (wkv6_fwd_ref, wkv6_bwd_ref, mamba_scan_fwd_ref,
                           mamba_scan_bwd_ref)))
_bp.add_counters(dict(zip(SYMBOLS, WRAPPERS)))


# ------------------------------------------------------ differentiable --

class _Scan(torch.autograd.Function):
    """A scan's forward kernel (``fwd``, keeping the chunk states) and its
    backward kernel (``bwd``, from the inputs and those states alone)."""

    @staticmethod
    def forward(ctx, fwd, bwd, chunk, *args):
        out, final, states = fwd(*args, chunk, True)
        ctx.save_for_backward(*args[:5], states)
        ctx.bwd, ctx.chunk = bwd, chunk
        return out, final

    @staticmethod
    def backward(ctx, d_out, d_final):
        return (None, None, None, *ctx.bwd(
            *ctx.saved_tensors, d_out.contiguous(), d_final.contiguous(),
            ctx.chunk))


def _scan(fwd, bwd, args, chunk):
    args = tuple(t.contiguous() for t in args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _Scan.apply(fwd, bwd, chunk, *args)
    return fwd(*args, chunk, False)[:2]


def wkv6(r, k, v, w, u, s0, chunk: int):
    """RWKV6's wkv over the sequence: ``(out (B, S, H, 64), s_final)``,
    differentiable in every input (the backward kernel on the card)."""
    return _scan(wkv6_fwd, wkv6_bwd, (r, k, v, w, u, s0), chunk)


def mamba_scan(x, dt, bm, cm, a, h0, chunk: int):
    """Mamba's selective scan: ``(y (B, S, D), h_final (B, D, N))``,
    differentiable in every input."""
    return _scan(mamba_scan_fwd, mamba_scan_bwd, (x, dt, bm, cm, a, h0),
                 chunk)
