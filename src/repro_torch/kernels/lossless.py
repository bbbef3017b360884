"""Hopper CUDA kernels for Algorithm 2's lossless codec.

The kernels live in ``csrc/lossless.cu`` (the note there says which of the
reference's jitted passes each replaces, what bounds it and what its design
does about it): ``lossless_stats`` (a bucket's histograms and RLE run
counts), ``huffman_pack``, ``huffman_decode``, ``rle_scan`` and
``rle_expand``.  They are built with the other kernels (``bitplane.load``:
``nvcc`` for ``sm_90a`` at first use, every source at once) and loaded
with ``ctypes``.  Nothing is compiled or loaded when this module is
imported.

The write side's kernels fill the card and read the symbols once:
``lossless_stats`` takes tiles of 4,096 to 16,384 symbols by the rule of
``stats_tiling`` and merges a row's tiles in thread block clusters (a row
of one cluster stored directly, more summed by the last cluster to
arrive); ``huffman_pack`` is one pass with a decoupled look-back over
tickets of one to four chunks (``pack_group``: as few tickets as fill the
card at once), each stream word stored once by the ticket whose bits
start in it (that word's earlier bits rebuilt from the symbols before
the ticket's chunks) and the cap's zero tail stored in pieces no ticket
waits for; ``rle_scan`` is one pass with a decoupled look-back over tiles
of ``RLE_BREAK`` symbols, whose runs each warp ranks 32 symbols a step
and writes at consecutive slots.

The read side's two kernels work in parallel within a chunk or a tile:
``huffman_decode`` splits each chunk's bits among up to 256 lanes that
walk their spans, resynchronise (a lane restarts where its left
neighbour stopped; a chunk still moving after a few rounds takes entry
tables) and write their symbols after a scan of the counts, with a serial
walk in the same kernel for any chunk whose parallel result cannot be
proved right; ``rle_expand`` is one pass with a decoupled look-back over
tiles of runs.  Each decode launch adds its chunks, its serially walked
chunks and its synchronisation rounds to a per-device record
(``decode_walks()``).

Five operators of the dispatcher, ``torch.ops.repro_torch.<name>``
(``torch.library.custom_op``s), as the other kernels are: the CUDA
implementation allocates the outputs and the scratch (declared in
``bitplane.WORKSPACE``, so that ``OpAnalysis`` counts it), launches its
passes on the current stream, raises if ``cudaGetLastError()`` is not 0
and adds one to the kernel's ``launches`` (the record of
``bitplane.launches()``: one a call, whatever its passes; an empty call
launches nothing and counts nothing); the fake gives the outputs' shapes
and dtypes, so that the operators run on ``meta``; the CPU implementation
is the plain version.  A CUDA call that no dispatch mode observes launches
directly.  On a CUDA tensor the operators launch or raise: there is no
fallback.

The plain versions are the eager passes of ``core/lossless.py``
(``_huffman_pack_plain``, ``_huffman_unpack_plain``, ``_rle_scan_plain``,
``_rle_expand_plain``) and ``core/lossless_batch.py``
(``_group_stats_plain``), held to the reference by the CPU tests.  Each
operator's outputs are theirs, byte for byte, but for ``rle_scan``: its
lengths are uint16 bits in int16 storage (the host keeps them as uint16),
and only a row's first ``nruns`` value and length slots are defined.  The
device parts of ``core/lossless.py`` take the operators on CUDA and
``meta`` tensors (``use_kernel``) and keep the plain passes on the CPU and
with ``backend="torch"``.

Beside each kernel, a small torch reference that follows its
decomposition (``lossless_stats_tiled``, ``huffman_pack_tiled``,
``huffman_decode_stepwise``, ``rle_scan_tiled``, ``rle_expand_tiled``), so
that the CPU tests reach the tiling's edges; the read side's take the
kernels' lanes, primary-table bits, tile and slices as parameters.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.core import lossless as ll
from repro_torch.kernels import bitplane as _bp
from repro_torch.tune.config import BACKENDS

CHUNK = ll.CHUNK                 # csrc/lossless.cu kChunk
RLE_BREAK = ll.RLE_BREAK         # kRleBreak
RLE_PIECE = 512                  # kRlePiece: a warp's symbols a segment row
LUT_SIZE = 1 << ll.MAX_CODE_LEN  # kLut
EXPAND_TILE = 4096               # kExpTile: runs a tile of rle_expand
STATS_MAX_TILE = 16384           # kStatsMaxTile: symbols a stats block
STATS_MIN_TILE = 4096            # kStatsMinTile
STATS_BLOCKS = 264               # kStatsBlocks: two blocks an SM (132)
MAX_CLUSTER = 8                  # kMaxCluster: a stats cluster's blocks
PACK_THREADS = 256               # kPackThreads: 16 symbols a thread
PACK_GROUP = 4                   # kPackGroup: chunks a pack ticket, at most
PACK_BLOCKS = 132 * 6            # kPackBlocks: pack blocks the card holds
PACK_WORDS = PACK_GROUP * CHUNK * ll.MAX_CODE_LEN // 32 + 8   # kPackWords
PRIMARY_BITS = 11                # kPrimBits: the decode's primary table
LONG = 0xFFFF                    # kLong: a primary entry to look past
LANES = (32, 64, 128, 256)       # a decode block's lanes (kMaxLanes 256)
LANE_BITS = 64                   # kLaneBits: a decode lane's span, at least
TABLE_ROUND = 4                  # kTableRound: entry tables from this round
SYMBOLS = ("lossless_stats", "huffman_pack", "huffman_decode", "rle_scan",
           "rle_expand")
_MASK32 = 0xFFFFFFFF

_lock = threading.Lock()
_ready = False


def _lib() -> ctypes.CDLL:
    global _ready
    lib = _bp.library("lossless")
    with _lock:
        if not _ready:
            vp, ll_, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.lossless_stats.argtypes = [vp, ll_, ll_, vp, vp, vp, vp]
            lib.huffman_pack.argtypes = [vp, ll_, ll_, vp, vp, vp, vp, vp,
                                         vp, ll_, vp]
            lib.huffman_decode.argtypes = [vp, ll_, ll_, vp, i, vp, vp, vp,
                                           vp, i, vp, ll_, vp]
            lib.rle_scan.argtypes = [vp, ll_, ll_, vp, vp, vp, vp, vp]
            lib.rle_expand.argtypes = [vp, vp, ll_, ll_, vp, i, vp, ll_, vp]
            for name in SYMBOLS:
                getattr(lib, name).restype = i
            _ready = True
    return lib


def use_kernel(where, backend: str) -> bool:
    """True: the kernel operators; False: the plain passes.  ``where`` is
    a tensor or a device.  The card and ``meta`` take the operators under
    ``"auto"`` and ``"cuda"``; the CPU keeps the plain passes under
    ``"auto"`` and raises under ``"cuda"``; ``"torch"`` is the plain passes
    everywhere (``kernels/ops.py`` ``_use_kernel``'s rule, ``meta``
    counted as the card's)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of "
                         f"{BACKENDS})")
    dev = where.device if isinstance(where, torch.Tensor) else \
        torch.device(where)
    if backend == "torch":
        return False
    if dev.type in ("cuda", "meta"):
        return True
    if backend == "cuda":
        raise ValueError(f"backend='cuda' needs a CUDA tensor, got {dev}")
    return False


def _chunks(n: int) -> int:
    return -(-n // CHUNK)


def _tiles(n: int, tile: int) -> int:
    return -(-n // tile)


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


# ------------------------------------------------------------ workspace --
# each operator's scratch by name: (shape, dtype), a function of the
# operator's arguments (``bitplane.WORKSPACE``)

def stats_tiling(b: int, s: int) -> Tuple[int, int, int]:
    """``lossless_stats``' launch at (B, S): (symbols a block, blocks a
    cluster, clusters a row).  The tile is ``STATS_MAX_TILE``, halved
    while the launch would have fewer than ``STATS_BLOCKS`` blocks, down to
    ``STATS_MIN_TILE``; a cluster is the row's tiles rounded up to a power
    of two, at most ``MAX_CLUSTER`` (``csrc/lossless.cu`` ``stats_tile``,
    ``stats_cluster``)."""
    tile = STATS_MAX_TILE
    while tile > STATS_MIN_TILE and b * _tiles(s, tile) < STATS_BLOCKS:
        tile //= 2
    t, k = _tiles(s, tile), 1
    while k < MAX_CLUSTER and k < t:
        k *= 2
    return tile, k, _tiles(t, k)


def lossless_stats_workspace(syms):
    """Where a row has more than one cluster: each row's sums (its 256
    bins and run starts, then its count of arrived clusters); else
    nothing."""
    b, s = syms.shape
    if stats_tiling(b, s)[2] <= 1:
        return {}
    return {"sums": ((b, 258), torch.int64)}


def pack_group(b: int, s: int) -> int:
    """``huffman_pack``'s chunks a ticket at (B, S): 1, doubled up to
    ``PACK_GROUP`` while the launch would have more than ``PACK_BLOCKS``
    tickets (``csrc/lossless.cu`` ``pack_group``)."""
    g = 1
    while g < PACK_GROUP and b * _tiles(_chunks(s), g) > PACK_BLOCKS:
        g *= 2
    return g


def huffman_pack_workspace(syms, lens_tab, codes_tab):
    """Each ticket's status word for the look-back, then the blocks'
    ticket counter."""
    b, s = syms.shape
    return {"status": ((b * _tiles(_chunks(s), pack_group(b, s)) + 1,),
                       torch.int64)}


def rle_scan_workspace(syms):
    """Each tile's status word for the look-back, then the blocks' ticket
    counter."""
    b, s = syms.shape
    return {"status": ((b * _tiles(s, RLE_BREAK) + 1,), torch.int64)}


def huffman_decode_workspace(words, chunk_offs, lut_sym, lut_len, n_syms):
    """Each row's primary table (uint16 bits in int16 storage)."""
    return {"primary": ((words.shape[0], 1 << PRIMARY_BITS), torch.int16)}


def rle_expand_workspace(values, lengths, n):
    """Each tile's status word, then the blocks' ticket counter."""
    b, r = values.shape
    return {"status": ((b * _tiles(r, EXPAND_TILE) + 1,), torch.int64)}


def _scratch(fn, *args):
    like = args[0]
    return [torch.empty(shape, dtype=dt, device=like.device)
            for shape, dt in fn(*args).values()]


# ------------------------------------------------- CUDA implementations --

def _launch_stats(syms):
    b, s = syms.shape
    if not (b and s):
        return (torch.zeros((b, 256), dtype=torch.int64, device=syms.device),
                torch.zeros((b,), dtype=torch.int64, device=syms.device))
    hist = torch.empty((b, 256), dtype=torch.int64, device=syms.device)
    nruns = torch.empty((b,), dtype=torch.int64, device=syms.device)
    (sums,) = _scratch(lossless_stats_workspace, syms) or (None,)
    _run("lossless_stats", syms, syms, b, s, hist, nruns, sums)
    return hist, nruns


def _launch_pack(syms, lens_tab, codes_tab):
    b, s = syms.shape
    cap = s * ll.MAX_CODE_LEN // 32 + 2
    shapes = (((b, cap), torch.int32), ((b,), torch.int64),
              ((b, _chunks(s)), torch.int64))
    if not (b and s):
        return tuple(torch.zeros(sh, dtype=dt, device=syms.device)
                     for sh, dt in shapes)
    words, total, offs = (torch.empty(sh, dtype=dt, device=syms.device)
                          for sh, dt in shapes)
    (status,) = _scratch(huffman_pack_workspace, syms, lens_tab, codes_tab)
    _run("huffman_pack", syms, syms, b, s, lens_tab, codes_tab, status,
         offs, total, words, cap)
    return words, total, offs


# ----------------------------------------------------------- the walks --
# each device's record of the decode's walks: chunks, chunks walked
# serially, synchronisation rounds (walks after a lane's first), the most
# rounds of one chunk; one int64 tensor of four a device, added to by
# every launch there

WALKS = ("chunks", "serial", "rounds", "max_rounds")
_walks_lock = threading.Lock()
_WALKS = {}


def _walks(device: torch.device) -> torch.Tensor:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    with _walks_lock:
        if index not in _WALKS:
            _WALKS[index] = torch.zeros(len(WALKS), dtype=torch.int64,
                                        device=torch.device("cuda", index))
        return _WALKS[index]


def decode_walks() -> dict:
    """The decode's walks on every device since the last reset (waits for
    the devices' work): {"chunks", "serial", "rounds", "max_rounds"}."""
    with _walks_lock:
        recs = [t.cpu() for t in _WALKS.values()]
    got = dict.fromkeys(WALKS, 0)
    for rec in recs:
        for i, k in enumerate(WALKS):
            got[k] = max(got[k], int(rec[i])) if k == "max_rounds" else \
                got[k] + int(rec[i])
    return got


def reset_decode_walks() -> None:
    with _walks_lock:
        for t in _WALKS.values():
            t.zero_()


def _launch_decode(words, chunk_offs, lut_sym, lut_len, n_syms, lanes=0):
    """``lanes``: a chunk's lanes (``LANES``), 0 for the kernel's rule."""
    b, n_words = words.shape
    out = torch.empty((b, n_syms), dtype=torch.uint8, device=words.device)
    if b and n_syms:
        (prim,) = _scratch(huffman_decode_workspace, words, chunk_offs,
                           lut_sym, lut_len, n_syms)
        _run("huffman_decode", words, words, b, n_words, chunk_offs,
             chunk_offs.shape[1], lut_sym, lut_len, prim,
             _walks(words.device), lanes, out, n_syms)
    return out


def _launch_rle_scan(syms):
    b, s = syms.shape
    values = torch.empty((b, s), dtype=torch.uint8, device=syms.device)
    lengths = torch.empty((b, s), dtype=torch.int16, device=syms.device)
    if not (b and s):
        return values, lengths, torch.zeros((b,), dtype=torch.int64,
                                            device=syms.device)
    nruns = torch.empty((b,), dtype=torch.int64, device=syms.device)
    (status,) = _scratch(rle_scan_workspace, syms)
    _run("rle_scan", syms, syms, b, s, status, values, lengths, nruns)
    return values, lengths, nruns


def _launch_rle_expand(values, lengths, n, slices=0):
    """``slices``: blocks a tile (1 .. 256), 0 for the kernel's rule."""
    b, r = values.shape
    out = torch.empty((b, n), dtype=torch.uint8, device=values.device)
    if b and n:
        (status,) = _scratch(rle_expand_workspace, values, lengths, n)
        _run("rle_expand", values, values, lengths, b, r, status, slices,
             out, n)
    return out


# ---------------------------------------------------------- CPU kernels --
# the plain versions, at the operators' output types

def _stats_plain(syms):
    from repro_torch.core import lossless_batch as lb
    return lb._group_stats_plain(syms)


def _rle_scan_plain(syms):
    b, s = syms.shape
    if not s:
        return (torch.empty((b, 0), dtype=torch.uint8),
                torch.empty((b, 0), dtype=torch.int16),
                torch.zeros((b,), dtype=torch.int64))
    values, lengths, nruns = ll._rle_scan_plain(syms)
    return values, lengths.to(torch.int16), nruns


# -------------------------------------------------------------- operators --

Tensor = torch.Tensor


def _define():
    ns = "repro_torch::"

    @torch.library.custom_op(ns + "lossless_stats", mutates_args=(),
                             device_types="cuda")
    def stats_op(syms: Tensor) -> Tuple[Tensor, Tensor]:
        return _launch_stats(syms)

    @torch.library.custom_op(ns + "huffman_pack", mutates_args=(),
                             device_types="cuda")
    def pack_op(syms: Tensor, lens_tab: Tensor,
                codes_tab: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        return _launch_pack(syms, lens_tab, codes_tab)

    @torch.library.custom_op(ns + "huffman_decode", mutates_args=(),
                             device_types="cuda")
    def decode_op(words: Tensor, chunk_offs: Tensor, lut_sym: Tensor,
                  lut_len: Tensor, n_syms: int) -> Tensor:
        return _launch_decode(words, chunk_offs, lut_sym, lut_len, n_syms)

    @torch.library.custom_op(ns + "rle_scan", mutates_args=(),
                             device_types="cuda")
    def rle_scan_op(syms: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        return _launch_rle_scan(syms)

    @torch.library.custom_op(ns + "rle_expand", mutates_args=(),
                             device_types="cuda")
    def rle_expand_op(values: Tensor, lengths: Tensor, n: int) -> Tensor:
        return _launch_rle_expand(values, lengths, n)

    def new(like, shape, dtype):
        return like.new_empty(shape, dtype=dtype)

    stats_op.register_fake(lambda syms: (
        new(syms, (syms.shape[0], 256), torch.int64),
        new(syms, (syms.shape[0],), torch.int64)))
    pack_op.register_fake(lambda syms, lens_tab, codes_tab: (
        new(syms, (syms.shape[0], syms.shape[1] * ll.MAX_CODE_LEN // 32 + 2),
            torch.int32),
        new(syms, (syms.shape[0],), torch.int64),
        new(syms, (syms.shape[0], _chunks(syms.shape[1])), torch.int64)))
    decode_op.register_fake(lambda words, chunk_offs, lut_sym, lut_len,
                            n_syms: new(words, (words.shape[0], n_syms),
                                        torch.uint8))
    rle_scan_op.register_fake(lambda syms: (
        new(syms, tuple(syms.shape), torch.uint8),
        new(syms, tuple(syms.shape), torch.int16),
        new(syms, (syms.shape[0],), torch.int64)))
    rle_expand_op.register_fake(lambda values, lengths, n: new(
        values, (values.shape[0], n), torch.uint8))

    stats_op.register_kernel("cpu")(_stats_plain)
    pack_op.register_kernel("cpu")(
        lambda *args: ll._huffman_pack_plain(*args))
    decode_op.register_kernel("cpu")(
        lambda *args: ll._huffman_unpack_plain(*args))
    rle_scan_op.register_kernel("cpu")(_rle_scan_plain)
    rle_expand_op.register_kernel("cpu")(
        lambda *args: ll._rle_expand_plain(*args))
    return {name: getattr(torch.ops.repro_torch, name).default
            for name in SYMBOLS}


_OPS = _define()
_LAUNCH = {"lossless_stats": _launch_stats, "huffman_pack": _launch_pack,
           "huffman_decode": _launch_decode, "rle_scan": _launch_rle_scan,
           "rle_expand": _launch_rle_expand}
_bp.add_workspace({_OPS["lossless_stats"]: lossless_stats_workspace,
                   _OPS["huffman_pack"]: huffman_pack_workspace,
                   _OPS["huffman_decode"]: huffman_decode_workspace,
                   _OPS["rle_scan"]: rle_scan_workspace,
                   _OPS["rle_expand"]: rle_expand_workspace})


def _call(name: str, *args):
    """Through the operator wherever something observes the dispatcher or
    the tensors lie on the CPU; a CUDA call that nothing observes launches
    directly (``bitplane._call``)."""
    if args[0].device.type == "cuda" and _get_current_dispatch_mode() is None:
        return _LAUNCH[name](*args)
    with torch._C._AutoDispatchBelowADInplaceOrView():
        return _OPS[name](*args)


def _check(what: str, t: torch.Tensor, dtypes, ndim: int = 2) -> None:
    if t.device.type not in ("cuda", "meta", "cpu"):
        raise ValueError(f"{what}: expected a CUDA, meta or CPU tensor, got "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: expected one of {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: inputs must be contiguous")


def _same_rows(what: str, first: torch.Tensor, *others, cols) -> None:
    """``others`` on ``first``'s device with its rows, and ``cols[i]``
    columns where that is not None."""
    for t, c in zip(others, cols):
        if t.device != first.device:
            raise ValueError(f"{what}: tensors on {first.device} and "
                             f"{t.device}")
        if t.shape[0] != first.shape[0] or (c is not None
                                            and t.shape[1] != c):
            raise ValueError(f"{what}: shapes {tuple(first.shape)} and "
                             f"{tuple(t.shape)}")


# --------------------------------------------------------------- wrappers --

def lossless_stats(syms: torch.Tensor):
    """(B, S) uint8 rows -> (histograms (B, 256) int64, RLE run counts
    (B,) int64), ``_group_stats_batch``'s."""
    _check("lossless_stats", syms, (torch.uint8,))
    return _call("lossless_stats", syms)


def huffman_pack(syms: torch.Tensor, lens_tab: torch.Tensor,
                 codes_tab: torch.Tensor):
    """(B, S) uint8 symbols and (B, 256) int64 code lengths (0 .. 16, a
    codebook's; on the card a length past 16 places no bit and counts as
    0) and codes -> (words (B, S * 16 // 32 + 2) uint32 bits in int32
    storage, total_bits (B,) int64, chunk_offs (B, ceil(S / CHUNK))
    int64)."""
    _check("huffman_pack", syms, (torch.uint8,))
    for t in (lens_tab, codes_tab):
        _check("huffman_pack", t, (torch.int64,))
    _same_rows("huffman_pack", syms, lens_tab, codes_tab, cols=(256, 256))
    return _call("huffman_pack", syms, lens_tab, codes_tab)


def huffman_decode(words: torch.Tensor, chunk_offs: torch.Tensor,
                   lut_sym: torch.Tensor, lut_len: torch.Tensor,
                   n_syms: int) -> torch.Tensor:
    """(B, L) words (uint32 bits in int32 storage; a word past L reads as
    zero), (B, C) int64 chunk start bits, C >= ceil(n_syms / CHUNK), and
    (B, 2**16) uint8 peek tables -> (B, n_syms) uint8."""
    _check("huffman_decode", words, (torch.int32,))
    _check("huffman_decode", chunk_offs, (torch.int64,))
    for t in (lut_sym, lut_len):
        _check("huffman_decode", t, (torch.uint8,))
    _same_rows("huffman_decode", words, chunk_offs, lut_sym, lut_len,
               cols=(None, LUT_SIZE, LUT_SIZE))
    if n_syms < 0 or chunk_offs.shape[1] < _chunks(n_syms):
        raise ValueError(f"huffman_decode: {chunk_offs.shape[1]} chunk "
                         f"offsets for {n_syms} symbols")
    return _call("huffman_decode", words, chunk_offs, lut_sym, lut_len,
                 int(n_syms))


def rle_scan(syms: torch.Tensor):
    """(B, S) uint8 -> (values (B, S) uint8, lengths (B, S) int16 holding
    uint16 bits, nruns (B,) int64); a row's first nruns slots are its
    runs."""
    _check("rle_scan", syms, (torch.uint8,))
    return _call("rle_scan", syms)


def rle_expand(values: torch.Tensor, lengths: torch.Tensor,
               n: int) -> torch.Tensor:
    """(B, R) uint8 run values and int32 lengths (zero-length runs allowed)
    -> (B, n) uint8."""
    _check("rle_expand", values, (torch.uint8,))
    _check("rle_expand", lengths, (torch.int32,))
    _same_rows("rle_expand", values, lengths, cols=(values.shape[1],))
    if n < 0 or (n and not values.shape[1]):
        raise ValueError(f"rle_expand: {values.shape[1]} runs for {n} "
                         "symbols")
    return _call("rle_expand", values, lengths, int(n))


WRAPPERS = (lossless_stats, huffman_pack, huffman_decode, rle_scan,
            rle_expand)
_bp.add_counters(dict(zip(SYMBOLS, WRAPPERS)))


# ------------------------------------------------------ tiled references --
# each kernel's decomposition in torch, on the CPU (tests)

class _LookBack:
    """A row's status words as a kernel's decoupled look-back sees them,
    tiles in ticket order: a tile publishes its sum, sums its
    predecessors' words back to the nearest inclusive one, and publishes
    its inclusive sum, which lands ``lag`` tiles late here, so that
    look-backs cross aggregates."""

    def __init__(self, lag=2):
        self.status, self.late, self.lag = {}, [], lag

    def __call__(self, t, tsum):
        """Tile t's exclusive prefix."""
        self.status[t] = ("agg", tsum)
        acc, look = 0, t - 1
        while look >= 0:
            flag, v = self.status[look]
            acc += v
            if flag == "inc":
                break
            look -= 1
        self.late.append((t, acc + tsum))
        while len(self.late) > self.lag:
            done, v = self.late.pop(0)
            self.status[done] = ("inc", v)
        return acc


def lossless_stats_tiled(syms):
    """``lossless_stats`` as its kernel computes it: the tiles of
    ``stats_tiling``, each tile's histogram and run starts (a tile's first
    symbol against the symbol before it), summed over a cluster's blocks
    (those past the row's tiles count nothing, and a block's counts fit
    its uint32 totals); a row of one cluster is that sum, a row of more
    the sum of its clusters'."""
    b, s = syms.shape
    tile, k, clusters = stats_tiling(b, s)
    blocks = clusters * k
    x = syms.to(torch.int64)
    prev = torch.cat([x[:, :1] ^ 255, x[:, :-1]], dim=1)
    starts = (x != prev) | (torch.arange(s) % RLE_BREAK == 0)
    block = torch.arange(s) // tile
    tot = torch.zeros((b, blocks, 257), dtype=torch.int64)
    for r in range(b):
        tot[r, :, :256] = torch.bincount(block * 256 + x[r],
                                         minlength=blocks * 256
                                         ).view(blocks, 256)
    tot[:, :, 256] = F.pad(starts, (0, blocks * tile - s)).view(
        b, blocks, tile).sum(2)
    if int(tot.max()) >= 1 << 32:
        raise AssertionError("a block's count past uint32")
    row = tot.view(b, clusters, k, 257).sum(2).sum(1)
    return row[:, :256].contiguous(), row[:, 256].contiguous()


def _head_bits(lens, msb, first, o):
    """The bits of word o >> 5 before bit o (``huffman_pack``'s warp 0):
    the codes of the symbols before ``first`` end at bit o; 32 symbols a
    step back until they cover the word's head.  ``lens``, ``msb``: the
    row's code lengths and MSB-aligned codes."""
    lo, end, i0, head = (o >> 5) << 5, o, first - 32, 0
    while True:
        i = torch.arange(i0, i0 + 32)
        inside = i >= 0
        ln = torch.where(inside, lens[i.clamp(min=0)], 0)
        m = torch.where(inside, msb[i.clamp(min=0)], 0)
        suf = ln.flip(0).cumsum(0).flip(0)   # this and later symbols'
        start = end - suf
        d = start - lo
        part = torch.where(d >= 0, m >> d.clamp(min=0),
                           (m << (-d).clamp(min=0)) & _MASK32)
        hit = (m != 0) & (start + ln > lo) & (start < lo + 32)
        for v in part[hit].tolist():
            head |= v
        end -= int(suf[0])
        i0 -= 32
        if end <= lo or i0 + 32 <= 0:
            return head


def huffman_pack_tiled(syms, lens_tab, codes_tab, lag=2):
    """``huffman_pack`` as its kernel computes it: tickets in order over
    (row, group of ``pack_group`` chunks); each thread's 16 codes a chunk
    turned into words from the group's first bit and ORed into the group's
    tile; the group's first bit o from the look-back (``_LookBack``); the
    words [o / 32, o' / 32) stored (the row's last group: through its last
    partial word), the tile's words shifted to bit o, the first after the
    bits before o rebuilt from the symbols before the group
    (``_head_bits``); and the cap's zeros [T, the T before).  Raises unless
    every word of the cap is stored exactly once.  (words, total_bits,
    chunk_offs) as the operator's."""
    b, s = syms.shape
    cap = s * ll.MAX_CODE_LEN // 32 + 2
    c = _chunks(s)
    group = pack_group(b, s)
    idx = syms.to(torch.int64)
    lens = torch.gather(lens_tab.to(torch.int64), 1, idx)
    codes = torch.gather(codes_tab.to(torch.int64), 1, idx) & _MASK32
    # code_entry: a length past MAX_CODE_LEN places no bit and counts as 0
    lens = torch.where((lens > 0) & (lens <= ll.MAX_CODE_LEN), lens, 0)
    msb = torch.where(lens > 0, (codes << (32 - lens)) & _MASK32, 0)
    words = torch.zeros((b, cap), dtype=torch.int64)
    stores = torch.zeros((b, cap), dtype=torch.int64)
    offs = torch.zeros((b, c), dtype=torch.int64)
    total = torch.zeros(b, dtype=torch.int64)
    slots = torch.arange(10)[None, :]   # a thread's words: at most 9
    for r in range(b):
        look = _LookBack(lag)
        for gi, c0 in enumerate(range(0, c, group)):
            nc = min(group, c - c0)
            first = c0 * CHUNK
            pad = (0, nc * CHUNK - min(nc * CHUNK, s - first))
            ln = F.pad(lens[r, first:first + nc * CHUNK], pad).view(
                nc, PACK_THREADS, 16)
            m = F.pad(msb[r, first:first + nc * CHUNK], pad).view(
                nc, PACK_THREADS, 16)
            bits = ln.sum(2)                       # (chunk, thread)
            sub = torch.cumsum(bits.sum(1), 0) - bits.sum(1)
            tot = int(bits.sum())
            # each thread's words, from the first its bits touch, its bits
            # counted from the group's first
            p = (sub[:, None] + torch.cumsum(bits, 1) - bits).view(-1)
            bits, ln, m = bits.view(-1), ln.view(-1, 16), m.view(-1, 16)
            pos = p[:, None] + torch.cumsum(ln, 1) - ln
            slot = (pos >> 5) - (p[:, None] >> 5)
            sh = pos & 31
            tw = torch.zeros((len(p), 11), dtype=torch.int64)
            tw.scatter_add_(1, slot, m >> sh)        # disjoint bits: add = OR
            tw.scatter_add_(1, slot + 1, torch.where(
                sh > 0, (m << (32 - sh)) & _MASK32, 0))
            nw = ((p + bits + 31) >> 5) - (p >> 5)
            live = (slots < nw[:, None]) & (bits[:, None] > 0)
            ti = (p[:, None] >> 5) + slots
            tile = torch.zeros(PACK_WORDS, dtype=torch.int64)
            tile.index_add_(0, ti[live], tw[:, :10][live])
            o = look(gi, tot)
            f, sh = o >> 5, o & 31
            last = c0 + nc == c
            e = min(cap, ((o + tot + 31) >> 5) if last else (o + tot) >> 5)
            shifted = tile[:e - f]
            if sh and e > f:
                before = torch.cat([torch.tensor(
                    [_head_bits(lens[r], msb[r], first, o) >> (32 - sh)]),
                    tile[:e - f - 1]])
                shifted = ((before << (32 - sh)) & _MASK32) | (shifted >> sh)
            words[r, f:e] = shifted
            stores[r, f:e] += 1
            after = max(s - first - nc * CHUNK, 0)
            t_lo = min(cap, (o + tot + 16 * after + 31) >> 5)
            t_hi = cap if gi == 0 else min(cap, (o + 16 * (s - first) + 31)
                                           >> 5)
            if t_hi > t_lo:
                words[r, t_lo:t_hi] = 0
                stores[r, t_lo:t_hi] += 1
            offs[r, c0:c0 + nc] = o + sub
            if last:
                total[r] = o + tot
    if not bool((stores == 1).all()):
        raise AssertionError("a word of the cap stored other than once")
    return words.to(torch.int32), total, offs


def decode_primary(lut_sym, lut_len, k=PRIMARY_BITS):
    """The decode's primary tables (B, 2**k) int64: entry q is the peek
    table's ``sym | len << 8`` where its 2**(16 - k) peeks q << (16 - k)
    ... all agree and len <= k, else ``LONG`` (look the peek up in the full
    table)."""
    b = lut_sym.shape[0]
    sub = 1 << (ll.MAX_CODE_LEN - k)
    s = lut_sym.to(torch.int64).view(b, 1 << k, sub)
    n = lut_len.to(torch.int64).view(b, 1 << k, sub)
    s0, n0 = s[:, :, 0], n[:, :, 0]
    same = ((s == s0[..., None]).all(2) & (n == n0[..., None]).all(2)
            & (n0 <= k))
    return torch.where(same, s0 | n0 << 8, torch.full_like(s0, LONG))


class _Stream:
    """A bucket's words as the decode reads them (zero past a row's L),
    with its primary and full tables."""

    def __init__(self, words, lut_sym, lut_len, k):
        b = words.shape[0]
        self.w = torch.cat([words.to(torch.int64) & _MASK32,
                            torch.zeros((b, 2), dtype=torch.int64)], dim=1)
        self.last = self.w.shape[1] - 1
        self.k = k
        self.prim = decode_primary(lut_sym, lut_len, k)
        # the longest code a row's walk can meet: its longest direct entry,
        # or 16 where a longer code is read from the full table
        top = (self.prim >> 8).max(1).values
        self.longest = torch.where(top > k, 16, top.clamp(min=1))
        self.full = (lut_sym.to(torch.int64) & 0xFF) | (
            lut_len.to(torch.int64) << 8)

    def entry(self, row, pos):
        """(sym | len << 8) of the code at bit ``pos`` of ``row``."""
        i = pos >> 5
        pair = (self.w[row, i.clamp(max=self.last)] << 32) | self.w[
            row, (i + 1).clamp(max=self.last)]
        peek = (pair >> (48 - (pos & 31))) & 0xFFFF
        e = self.prim[row, peek >> (ll.MAX_CODE_LEN - self.k)]
        return torch.where((e >> 8) > self.k, self.full[row, peek], e)

    def walk(self, row, pos, stop, tail, out=None, dest=None, slot=None,
             limit=None):
        """Lanes walking from ``pos`` while before ``stop`` (a zero length
        walked over as one bit): (end, codes, met a zero length).  From bit
        ``tail[i]`` on, lane i's words are zero: every code there is the
        table's entry 0, counted rather than walked where its length is
        not 0.  With ``out``: lane i's symbols at out[dest[i], slot[i]
        ...] while below ``limit[i]``."""
        pos, cnt = pos.clone(), torch.zeros_like(pos)
        zero = torch.zeros_like(pos, dtype=torch.bool)
        e0 = self.entry(row, torch.full_like(pos, 1 << 40))
        len0 = e0 >> 8
        act = pos < stop
        if out is not None:
            act &= slot < limit
        while bool(act.any()):
            jump = act & (pos >= tail) & (len0 > 0)
            for i in jump.nonzero().squeeze(1).tolist():
                more = -(-int(stop[i] - pos[i]) // int(len0[i]))
                if out is not None:
                    more = min(more, int(limit[i] - slot[i] - cnt[i]))
                    at = int(slot[i] + cnt[i])
                    out[dest[i], at:at + more] = e0[i] & 0xFF
                cnt[i] += more
                pos[i] += more * len0[i]
                act[i] = False
            idx = act.nonzero().squeeze(1)
            if not len(idx):
                break
            e = self.entry(row[idx], pos[idx])
            ln = e >> 8
            zero[idx] |= ln == 0
            if out is not None:
                out[dest[idx], slot[idx] + cnt[idx]] = e & 0xFF
            cnt[idx] += 1
            pos[idx] += ln.clamp(min=1)
            act[idx] = pos[idx] < stop[idx]
            if out is not None:
                act[idx] &= slot[idx] + cnt[idx] < limit[idx]
        return pos, cnt, zero

    def serial(self, row, pos, count):
        """The reference's walk of ``count`` codes a chunk from ``pos``
        (a zero length stays), as (chunks, max count) symbols."""
        steps = int(count.max())
        out = torch.zeros((len(pos), steps), dtype=torch.int64)
        pos = pos.clone()
        for j in range(steps):
            e = self.entry(row, pos)
            out[:, j] = e & 0xFF
            pos = pos + (e >> 8)
        return out


def huffman_decode_stepwise(words, chunk_offs, lut_sym, lut_len, n_syms,
                            lanes=32, k=PRIMARY_BITS, stats=False):
    """``huffman_decode`` as its kernel computes it, every chunk's lanes in
    lock step.  The primary table of the top ``k`` bits (``decode_primary``)
    and the full table past it; chunk c's bits [off[c], E) split into
    ``lanes`` spans (E: off[c + 1]; the last chunk's off + 16 * count,
    capped at the row's words; the staged words' zero tail all the last
    lane's; spans of ``LANE_BITS`` at least, the first lanes idle where
    they would be shorter; spans start at multiples of a codebook's one
    length); each lane walks its span, restarts where its left neighbour
    stopped until no start moves (a chunk still moving at round
    ``TABLE_ROUND`` takes entry tables instead: each lane's exits from
    every entry its true start can have, chained from the chunk's start),
    and writes its symbols at the exclusive scan of the counts.  A chunk
    whose synchronised walk met a zero length, or whose counts or last
    code miss (for the last chunk: fewer than its count) is walked
    serially, code by code.  Words past a row's end read as zero.  With
    ``stats``: also {"rounds": (B, chunks) synchronisation rounds,
    "serial": (B, chunks) bool}."""
    b, n_words = words.shape
    used = min(_chunks(n_syms), chunk_offs.shape[1])
    st = _Stream(words, lut_sym, lut_len, k)
    offs = chunk_offs[:, :used + 1].to(torch.int64) & _MASK32
    off = offs[:, :used]
    c_idx = torch.arange(used, dtype=torch.int64)
    count = (n_syms - c_idx * CHUNK).clamp(max=CHUNK).expand(b, used)
    last = (c_idx == used - 1).expand(b, used)
    end = torch.where(last, torch.minimum(off + 16 * count,
                                          torch.tensor(32 * n_words)),
                      F.pad(offs[:, 1:], (0, used + 1 - offs.shape[1])))
    parallel = (end > off) & (end - off <= CHUNK * ll.MAX_CODE_LEN)
    lens = st.prim >> 8
    present = lens > 0
    qmin = torch.where(present, lens, 255).min(1).values
    qmax = torch.where(present, lens, 0).max(1).values
    quantum = torch.where((qmin == qmax) & (qmax <= k), qmin, 1)
    rounds = torch.zeros((b, used), dtype=torch.int64)
    ok = torch.zeros((b, used), dtype=torch.bool)
    out = torch.zeros((b, used, CHUNK), dtype=torch.int64)
    lane = torch.arange(lanes, dtype=torch.int64)
    rq, cq = parallel.nonzero(as_tuple=True)
    q = len(rq)
    if q:
        g = quantum[rq][:, None]
        o, e = off[rq, cq][:, None], end[rq, cq][:, None]
        # the zero tail: from the word after the staged words' last non-zero
        wlo = o >> 5
        k_at = wlo + torch.arange(CHUNK * ll.MAX_CODE_LEN // 32 + 4)
        nstage = ((e - 1) >> 5) - wlo + 4
        staged = st.w[rq[:, None], k_at.clamp(max=st.last)]
        nz = torch.where((staged != 0) & (k_at - wlo < nstage), k_at + 1,
                         wlo).max(1, keepdim=True).values
        tail = 32 * nz
        split = torch.maximum(torch.minimum(tail, e), o)
        units = (split - o) // g
        # the last ``act`` lanes share the spans, LANE_BITS at least each;
        # the others hold empty spans at the chunk's start
        act = (units * g // LANE_BITS).clamp(1, lanes)
        i = lane - (lanes - act)
        start = torch.where(i >= 0, o + units * i // act * g, o)
        stop = torch.where(i + 1 == act, e, torch.where(
            i >= 0, o + units * (i + 1) // act * g, o))
        row = rq[:, None].expand(-1, lanes).reshape(-1)
        tail = tail.expand(-1, lanes).reshape(-1)
        start, stop = start.reshape(-1), stop.reshape(-1)
        p, cnt, zero = st.walk(row, start, stop, tail)
        nominal = start.clone()
        lm = st.longest[rq]
        done = torch.zeros(q, dtype=torch.bool)
        lost = torch.zeros(q, dtype=torch.bool)
        while True:               # until no lane's start moves
            s2, p2 = start.view(q, lanes), p.view(q, lanes)
            ns = torch.cat([s2[:, :1], p2[:, :-1]], dim=1).reshape(-1)
            moved = (ns != start) & ~done[:, None].expand(-1, lanes
                                                          ).reshape(-1)
            chunk_moved = moved.view(q, lanes).any(1)
            if not bool(chunk_moved.any()):
                break
            rounds[rq, cq] += chunk_moved.to(torch.int64)
            table = chunk_moved & (rounds[rq, cq] == TABLE_ROUND)
            for c in table.nonzero().flatten().tolist():
                # still moving: every lane's exits from each entry its true
                # start can have, chained from the chunk's start
                sl = slice(c * lanes, (c + 1) * lanes)
                m = int(lm[c])
                exits = torch.stack([st.walk(
                    row[sl], nominal[sl] + f, stop[sl], tail[sl])[0]
                    - stop[sl] for f in range(m)])
                entry, f = [], 0
                for j in range(lanes):
                    entry.append(f)
                    if f >= 0:
                        f = int(exits[f, j]) if int(exits[f, j]) < m else -1
                entry = torch.tensor(entry)
                lost[c] = bool((entry < 0).any())
                start[sl] = nominal[sl] + entry.clamp(min=0)
                p[sl], cnt[sl], zero[sl] = st.walk(row[sl], start[sl],
                                                   stop[sl], tail[sl])
                done[c] = True
            moved &= ~table[:, None].expand(-1, lanes).reshape(-1)
            start = torch.where(moved, ns, start)
            idx = moved.nonzero().squeeze(1)
            p[idx], cnt[idx], zero[idx] = st.walk(row[idx], start[idx],
                                                  stop[idx], tail[idx])
        c2 = cnt.view(q, lanes)
        total = c2.sum(1)
        want = count[rq, cq]
        good = ~zero.view(q, lanes).any(1) & ~lost & torch.where(
            last[rq, cq], total >= want,
            (total == want) & (p.view(q, lanes)[:, -1] == e[:, 0]))
        ok[rq, cq] = good
        base = (torch.cumsum(c2, 1) - c2).reshape(-1)
        lim = want[:, None].expand(-1, lanes).reshape(-1)
        wr = good[:, None].expand(-1, lanes).reshape(-1) & (base < lim)
        idx = wr.nonzero().squeeze(1)
        tile = torch.zeros((q, CHUNK), dtype=torch.int64)
        st.walk(row[idx], start[idx], stop[idx], tail[idx], tile,
                idx // lanes, base[idx], lim[idx])
        out[rq[good], cq[good]] = tile[good]
    rs, cs = (~ok).nonzero(as_tuple=True)
    if len(rs):
        sym = st.serial(rs, off[rs, cs], count[rs, cs])
        out[rs, cs, :sym.shape[1]] = sym
    dec = (out.reshape(b, -1)[:, :n_syms] & 0xFF).to(torch.uint8)
    if stats:
        return dec, {"rounds": rounds, "serial": ~ok}
    return dec


def rle_scan_tiled(syms, lag=2):
    """``rle_scan`` as its kernel computes it: tickets in order over (row,
    tile of ``RLE_BREAK``); each 16-symbol segment's run starts (the
    neighbour differs, or the tile's first symbol) summed over each warp's
    ``RLE_PIECE``-symbol piece into its count and last start; the pieces
    scanned in order to each one's first slot and the start before it; the
    tile's first slot from the look-back (``_LookBack``); each start
    written at its piece's first slot plus the starts before it in the
    piece, with the length of the run before it (its start less the start
    before it: in the piece, else the piece's start before), and the
    tile's last start writing its own length (the tile's end less it).
    Raises unless every value and length slot below a row's nruns is
    written exactly once and no other is.  Slots past a row's nruns are
    0."""
    b, s = syms.shape
    tiles = _tiles(s, RLE_BREAK)
    pieces = RLE_BREAK // RLE_PIECE
    values = torch.zeros((b, s), dtype=torch.uint8)
    lengths = torch.zeros((b, s), dtype=torch.int64)
    writes = torch.zeros((2, b, s), dtype=torch.int64)
    nruns = torch.zeros(b, dtype=torch.int64)
    at = torch.arange(RLE_BREAK)
    for r in range(b):
        look = _LookBack(lag)
        for t in range(tiles):
            t0 = t * RLE_BREAK
            n = min(RLE_BREAK, s - t0)
            x = F.pad(syms[r, t0:t0 + n].to(torch.int64),
                      (0, RLE_BREAK - n))
            prev = torch.cat([torch.tensor([256]), x[:-1]])
            starts = (x != prev) & (at < n)
            # each segment's count and last start, then each piece's
            seg_n = starts.view(-1, 16).sum(1)
            seg_last = torch.where(starts, at, -1).view(-1, 16).max(1).values
            piece_n = seg_n.view(pieces, -1).sum(1)
            piece_last = seg_last.view(pieces, -1).max(1).values
            piece_first = torch.cumsum(piece_n, 0) - piece_n
            piece_prev = torch.cat([torch.tensor([-1]), torch.cummax(
                piece_last, 0).values[:-1]])
            total, tile_last = int(piece_n.sum()), int(piece_last.max())
            base = look(t, total)
            # each start's slot and the start before it, piece by piece
            sv = starts.view(pieces, RLE_PIECE)
            rank = (piece_first[:, None] + torch.cumsum(sv, 1) - sv.long()
                    ).view(-1)
            upto = torch.cummax(torch.where(sv, at.view(pieces, -1), -1),
                                1).values
            inside = F.pad(upto[:, :-1], (1, 0), value=-1)
            before = torch.where(inside >= 0, inside,
                                 piece_prev[:, None]).view(-1)
            pos = starts.nonzero().flatten()
            slot = base + rank[pos]
            values[r, slot] = x[pos].to(torch.uint8)
            writes[0, r].index_add_(0, slot, torch.ones_like(slot))
            more = rank[pos] > 0
            lengths[r, slot[more] - 1] = pos[more] - before[pos[more]]
            writes[1, r].index_add_(0, slot[more] - 1,
                                    torch.ones_like(slot[more]))
            lengths[r, base + rank[tile_last]] = n - tile_last
            writes[1, r, base + rank[tile_last]] += 1
            if t + 1 == tiles:
                nruns[r] = base + total
    live = torch.arange(s)[None, :] < nruns[:, None]
    if not bool((writes == live.long()[None]).all()):
        raise AssertionError("a run slot written other than once")
    return values, lengths.to(torch.int16), nruns


def rle_expand_tiled(values, lengths, n, tile=EXPAND_TILE, slices=1,
                     lag=2):
    """``rle_expand`` as its kernel computes it: blocks take tickets in
    order (row, tile, slice); a tile's first slice looks back
    (``_LookBack``, its inclusive word ``lag`` tickets late); each slice
    writes its share of the tile's bytes [prefix, prefix + sum) of [0, n)
    (the row's last tile on to n), each byte's run found in the tile's
    ends (upper bound, clamped to the tile's last run)."""
    b, r = values.shape
    tiles = _tiles(r, tile)
    lens = lengths.to(torch.int64)
    out = torch.zeros((b, n), dtype=torch.uint8)
    for row in range(b):
        look = _LookBack(lag)
        for t in range(tiles):
            j0 = t * tile
            ends = torch.cumsum(lens[row, j0:j0 + tile], 0)
            tsum = int(ends[-1])
            acc = look(t, tsum)
            lo = max(acc, 0)
            hi = min(n, n if t + 1 == tiles else acc + tsum)
            for s in range(slices):
                s_lo = lo + (hi - lo) * s // slices
                s_hi = lo + (hi - lo) * (s + 1) // slices
                if s_hi <= s_lo:
                    continue
                pos = torch.arange(s_lo, s_hi, dtype=torch.int64) - acc
                j = torch.searchsorted(ends, pos, right=True).clamp(
                    max=len(ends) - 1)
                out[row, s_lo:s_hi] = values[row, j0 + j]
    return out
