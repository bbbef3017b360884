"""Lossless encoding of packed bitplane groups (paper §5).

A port of ``repro.core.lossless``.  Three codecs + the Algorithm-2 hybrid
selector:

* **Huffman** — canonical, length-limited (<=16 bit codes, zlib-style Kraft
  fixup).  Encode is the GPU-parallel formulation: per-symbol code lengths ->
  prefix-sum bit offsets -> two disjoint scatter-adds (adds of disjoint bits
  equal ORs) into the packed word stream.  Decode is chunk-parallel: bit
  offsets of every CHUNK-th symbol are stored in the segment header, and
  every chunk of every row advances through a 2^16 peek-LUT in lock step.
* **RLE** — scan-based: run breaks via neighbor comparison (+ forced breaks
  every 32768 symbols so lengths fit uint16), run starts via scatter-min,
  decode via cumsum + searchsorted.
* **DC** — direct copy.

The codebook build, the estimators, ``exact_stored_bytes``, the ``Segment``
framing and the Algorithm-2 decision are host numpy, copied from the
reference.  The device parts are torch ops on rows ``(B, S)`` -- the batched
engine (``core.lossless_batch``) calls them on whole buckets, the per-group
codecs here on one row -- with the bit work in int64 (torch's CPU backend
has no uint32 shifts or scatter-adds).

The per-group codecs place their data on ``device`` (``None`` means
``cuda``; see ``repro_torch.device``).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

CHUNK = 4096          # symbols per parallel-decode chunk
MAX_CODE_LEN = 16     # length-limited canonical Huffman
RLE_BREAK = 32768     # forced run break so lengths fit in uint16

# Bit offsets are uint32 in the stored format; a group whose packed stream
# could reach 2**32 bits would overflow them, so groups are capped at the
# largest symbol count that cannot overflow even if every symbol takes the
# maximum code length.
MAX_GROUP_SYMS = ((1 << 32) - 1) // MAX_CODE_LEN

_MASK32 = 0xFFFFFFFF


def _check_group_size(n: int) -> None:
    if n > MAX_GROUP_SYMS:
        raise ValueError(
            f"group of {n} symbols exceeds MAX_GROUP_SYMS={MAX_GROUP_SYMS} "
            "(uint32 bit offsets would overflow); use smaller chunks")


# ---------------------------------------------------------------- codebook --

def build_codebook(hist: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical, length-limited Huffman codebook from a 256-bin histogram.

    Returns (lengths uint8[256], codes uint32[256]); absent symbols get len 0.

    Two-queue Huffman (one sort, then O(n) merges) instead of a heap — the
    codebook build sits on the per-chunk write path (one per huffman group),
    and the heap formulation was the single hottest host-side item there.
    Output is bit-identical to the retired heap build of the reference
    package: the heap pops min ``(freq, idx)`` where leaves carry idx < 256 and internal nodes idx >= 256 in
    creation order, so a freq tie always resolves leaf-first and, between
    internal nodes, in FIFO creation order — exactly what popping from a
    (freq, symbol)-sorted leaf queue and a FIFO internal queue reproduces
    (internal freqs are non-decreasing in creation order, the classic
    two-queue invariant).
    """
    hist = np.asarray(hist, dtype=np.int64)
    present = np.nonzero(hist)[0]
    lengths = np.zeros(256, dtype=np.uint8)
    if len(present) == 0:
        return lengths, np.zeros(256, dtype=np.uint32)
    if len(present) == 1:
        lengths[present[0]] = 1
    else:
        freqs = hist[present]
        order = np.argsort(freqs, kind="stable")  # (freq, symbol) ascending
        lf = freqs[order].tolist()
        n_leaves = len(lf)
        leaf_sym = present[order].tolist()
        qf: List[int] = []          # internal-node freqs (non-decreasing)
        kids: List[Tuple[int, int]] = []
        li = qi = nq = 0
        # inlined two-queue pops (this loop runs ~2x255 times per group on
        # the write hot path): node id is the leaf symbol (< 256) or 256 +
        # internal creation index; <= prefers the leaf on a freq tie (leaf
        # id < internal id, matching the heap's (freq, idx) order)
        for _ in range(n_leaves - 1):
            if qi >= nq or (li < n_leaves and lf[li] <= qf[qi]):
                f1, i1 = lf[li], leaf_sym[li]; li += 1
            else:
                f1, i1 = qf[qi], 256 + qi; qi += 1
            if qi >= nq or (li < n_leaves and lf[li] <= qf[qi]):
                f2, i2 = lf[li], leaf_sym[li]; li += 1
            else:
                f2, i2 = qf[qi], 256 + qi; qi += 1
            qf.append(f1 + f2)
            kids.append((i1, i2))
            nq += 1
        # depths top-down: children are created strictly before their parent,
        # so a reverse pass sees every parent's depth before its children's
        depth = [0] * len(kids)
        for k in range(len(kids) - 1, -1, -1):
            d = depth[k] + 1
            for c in kids[k]:
                if c < 256:
                    lengths[c] = d
                else:
                    depth[c - 256] = d
        # length-limit + Kraft fixup
        lengths[present] = np.minimum(lengths[present], MAX_CODE_LEN)
        def kraft() -> int:
            return int(np.sum(1 << (MAX_CODE_LEN - lengths[present].astype(np.int64))))
        cap = 1 << MAX_CODE_LEN
        while kraft() > cap:
            # lengthen the currently-longest shortenable code (min freq impact)
            cand = present[lengths[present] < MAX_CODE_LEN]
            i = cand[np.argmax(lengths[cand])]
            lengths[i] += 1
    # canonical code assignment in (length, symbol) order, vectorized via the
    # standard next_code recurrence: code(s) = next_code[len(s)] + rank of s
    # among same-length symbols — identical to the sequential shift-and-
    # increment walk (``_codes_from_lengths``)
    codes = np.zeros(256, dtype=np.uint32)
    plens = lengths[present].astype(np.int64)
    bl_count = np.bincount(plens, minlength=MAX_CODE_LEN + 1)
    next_code = np.zeros(MAX_CODE_LEN + 1, dtype=np.int64)
    code = 0
    for l in range(1, MAX_CODE_LEN + 1):
        code = (code + int(bl_count[l - 1])) << 1
        next_code[l] = code
    corder = np.argsort(plens, kind="stable")  # present ascending -> (len, sym)
    sl = plens[corder]
    rank = np.arange(len(sl)) - np.searchsorted(sl, sl)
    codes[present[corder]] = (next_code[sl] + rank).astype(np.uint32)
    return lengths, codes


def _build_decode_lut(lengths: np.ndarray, codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """2^16-entry peek LUT: top-16-bit window -> (symbol, code length)."""
    lut_sym = np.zeros(1 << MAX_CODE_LEN, dtype=np.uint8)
    lut_len = np.zeros(1 << MAX_CODE_LEN, dtype=np.uint8)
    for s in range(256):
        l = int(lengths[s])
        if l == 0:
            continue
        base = int(codes[s]) << (MAX_CODE_LEN - l)
        span = 1 << (MAX_CODE_LEN - l)
        lut_sym[base:base + span] = s
        lut_len[base:base + span] = l
    return lut_sym, lut_len


# ------------------------------------------------------------ device parts --
#
# All four take rows: (B, S) uint8 symbols (or their (B, ...) payloads) on
# one device, and return device tensors; the host trims per-row tails.

def _huffman_pack(syms: torch.Tensor, lens_tab: torch.Tensor,
                  codes_tab: torch.Tensor):
    """Parallel bit-pack of each row: (B, S) symbols + per-row (B, 256)
    codebooks -> (words (B, cap) uint32 bits in int32 storage, total_bits
    (B,), chunk_offs (B, ceil(S/CHUNK))).  ``cap`` is the reference's."""
    b, s = syms.shape
    idx = syms.to(torch.int64)
    lens = torch.gather(lens_tab.to(torch.int64), 1, idx)
    codes = torch.gather(codes_tab.to(torch.int64), 1, idx)
    offs_incl = torch.cumsum(lens, dim=1)
    offs = offs_incl - lens  # exclusive
    total_bits = (offs_incl[:, -1] if s else
                  torch.zeros(b, dtype=torch.int64, device=syms.device))
    cap = s * MAX_CODE_LEN // 32 + 2
    codes_msb = (codes << (32 - lens)) & _MASK32
    w = offs >> 5
    sh = offs & 31
    lo = codes_msb >> sh
    spill = torch.where(sh > 0, (codes_msb << (32 - sh)) & _MASK32,
                        torch.zeros_like(codes_msb))
    words = torch.zeros((b, cap), dtype=torch.int64, device=syms.device)
    words.scatter_add_(1, w, lo)
    words.scatter_add_(1, w + 1, spill)
    return words.to(torch.int32), total_bits, offs[:, ::CHUNK]


def _huffman_unpack(words: torch.Tensor, chunk_offs: torch.Tensor,
                    lut_sym: torch.Tensor, lut_len: torch.Tensor,
                    n_syms: int) -> torch.Tensor:
    """Chunk-parallel decode of each row: (B, L) words (zero-padded rows),
    (B, C) chunk start bits, (B, 2**16) peek LUTs -> (B, n_syms) uint8.

    Every chunk of every row advances one symbol per step; a chunk never
    holds more than CHUNK symbols, and a single-chunk stream only
    ``n_syms``, so the loop runs ``min(CHUNK, n_syms)`` steps.  Symbols past
    a row's end decode from zero padding and are trimmed."""
    b, n_words = words.shape
    dev = words.device
    w = words.to(torch.int64) & _MASK32
    # a step advances at most MAX_CODE_LEN bits, so a chunk never peeks
    # more than CHUNK * MAX_CODE_LEN / 32 words past its start
    pad = CHUNK * MAX_CODE_LEN // 32 + 2
    w = torch.cat([w, torch.zeros((b, pad), dtype=torch.int64, device=dev)],
                  dim=1)
    pair = (w[:, :-1] << 32) | w[:, 1:]     # 64-bit window at word i
    lut = (lut_sym.to(torch.int64) & 0xFF) | (lut_len.to(torch.int64) << 8)
    p = chunk_offs.to(torch.int64) & _MASK32           # (B, C)
    steps = min(CHUNK, n_syms)
    out = torch.empty((b, p.shape[1], steps), dtype=torch.int64, device=dev)
    for k in range(steps):
        v = torch.gather(pair, 1, p >> 5)
        peek = (v >> (48 - (p & 31))) & 0xFFFF
        e = torch.gather(lut, 1, peek)
        out[:, :, k] = e
        p = p + (e >> 8)
    return (out.reshape(b, -1)[:, :n_syms] & 0xFF).to(torch.uint8)


def _rle_scan(syms: torch.Tensor):
    """(B, S) symbols -> per-row (values (B, S), lengths (B, S), nruns (B,));
    run slots beyond a row's nruns are trimmed on the host."""
    b, n = syms.shape
    dev = syms.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    prev = torch.cat([syms[:, :1] ^ 255, syms[:, :-1]], dim=1)
    brk = (syms != prev) | (idx % RLE_BREAK == 0)
    run_id = torch.cumsum(brk.to(torch.int64), dim=1) - 1
    nruns = run_id[:, -1] + 1
    starts = torch.full((b, n), n, dtype=torch.int64, device=dev)
    starts.scatter_reduce_(1, run_id, idx.expand(b, n), reduce="amin")
    values = torch.gather(syms, 1, starts.clamp(0, n - 1))
    ends = torch.cat([starts[:, 1:],
                      torch.full((b, 1), n, dtype=torch.int64, device=dev)],
                     dim=1)
    return values, ends - starts, nruns


def _rle_expand(values: torch.Tensor, lengths: torch.Tensor,
                n: int) -> torch.Tensor:
    """(B, R) run values + lengths (zero-length padded runs allowed at the
    end) -> (B, n) symbols."""
    b, r = values.shape
    cum = torch.cumsum(lengths.to(torch.int64), dim=1)
    pos = torch.arange(n, dtype=torch.int64,
                       device=values.device).expand(b, n).contiguous()
    idx = torch.searchsorted(cum, pos, right=True).clamp(max=max(r - 1, 0))
    return torch.gather(values, 1, idx)


def _rows(data: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(data, dtype=np.uint8)).to(device)[None]


# -------------------------------------------------------------- estimators --

def estimate_huffman(hist: np.ndarray, n: int) -> Tuple[float, np.ndarray, np.ndarray]:
    """Exact canonical-codebook cost estimate (paper: build tree, sum f*len).

    Returns (CR, lengths, codes) so the encoder can reuse the codebook."""
    lengths, codes = build_codebook(hist)
    bits = int(np.sum(hist * lengths.astype(np.int64)))
    overhead = 256 + 4 * (n // CHUNK + 1) + 16
    bytes_est = bits / 8.0 + overhead
    return (n / bytes_est if bytes_est else 1.0), lengths, codes


def estimate_rle(n_runs: int, n: int) -> float:
    bytes_est = 3.0 * n_runs + 16
    return n / bytes_est if bytes_est else 1.0


def exact_stored_bytes(method: str, n: int, total_bits: int = 0,
                       n_runs: int = 0) -> int:
    """EXACT ``len(Segment.to_bytes())`` of a group, computed BEFORE
    encoding from selection-time stats (hist-derived ``total_bits`` for
    huffman, ``n_runs`` for rle).

    This is what the Algorithm-2 store-raw fallback compares: the CR
    estimators above use the paper's approximate overhead constants, so near
    the break-even point a "winning" codec can still serialize larger than
    the raw bytes.  Constants are derived from ``Segment.to_bytes`` framing
    (header 16 + meta count 4; meta entry 4+len(key)+8; payload entry
    4+len(key)+5+data) and property-tested against real serializations in
    tests/test_tune.py.  Meta entries callers add after encoding
    (``n_planes``/``n_words``) are identical across methods and cancel."""
    if method == "dc":        # meta n_syms; payload raw[n]
        return 50 + n
    if method == "huffman":   # meta n_syms,total_bits; chunk_offs,lengths,words
        n_words = (total_bits + 31) // 32 + 1
        return 361 + 4 * n_words + 4 * ((n + CHUNK - 1) // CHUNK + 1)
    if method == "rle":       # meta n_syms; values[r] u8, lengths[r] u16
        return 69 + 3 * n_runs
    raise ValueError(f"unknown method {method!r}")


# ---------------------------------------------------------------- segments --

_METHODS = {"dc": 0, "huffman": 1, "rle": 2, "empty": 3}
_METHOD_NAMES = {v: k for k, v in _METHODS.items()}
_MAGIC = 0x4D445253  # 'MDRS'


@dataclasses.dataclass
class Segment:
    """One losslessly-encoded unit (a merged bitplane group).

    A Segment may be a payload-free *stub*: metadata only, with the true
    serialized size recorded in ``meta["stored_bytes"]``.  Stubs are what a
    store manifest materializes so the retrieval planner can cost byte ranges
    without ever touching segment payloads (see repro.store.layout).
    """
    method: str
    n_bytes: int                      # original (uncompressed) byte count
    payload: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    meta: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def stored_bytes(self) -> int:
        if "stored_bytes" in self.meta:
            return int(self.meta["stored_bytes"])
        return sum(a.nbytes for a in self.payload.values()) + 64

    @property
    def is_stub(self) -> bool:
        return not self.payload and "stored_bytes" in self.meta

    def to_bytes(self) -> bytes:
        parts = [struct.pack("<IIIi", _MAGIC, _METHODS[self.method],
                             self.n_bytes, len(self.payload))]
        parts.append(struct.pack("<i", len(self.meta)))
        for k, v in sorted(self.meta.items()):
            kb = k.encode()
            parts.append(struct.pack("<i", len(kb)) + kb + struct.pack("<q", v))
        for k, a in sorted(self.payload.items()):
            kb = k.encode()
            a = np.ascontiguousarray(a)
            parts.append(struct.pack("<i", len(kb)) + kb)
            parts.append(struct.pack("<ci", a.dtype.char.encode(), a.size))
            parts.append(a.tobytes())
        return b"".join(parts)

    @staticmethod
    def from_bytes(buf: bytes) -> "Segment":
        # corruption surfaces as ValueError unconditionally: a bare assert
        # would be stripped under `python -O`, and a truncated buffer would
        # otherwise escape as struct.error
        try:
            return Segment._from_bytes(buf)
        except struct.error as exc:
            raise ValueError(f"corrupt segment: truncated ({exc})") from exc

    @staticmethod
    def _from_bytes(buf: bytes) -> "Segment":
        off = 0
        magic, mcode, n_bytes, n_payload = struct.unpack_from("<IIIi", buf, off)
        off += 16
        if magic != _MAGIC:
            raise ValueError("corrupt segment: bad magic")
        if mcode not in _METHOD_NAMES:
            raise ValueError(f"corrupt segment: unknown method code {mcode}")
        (n_meta,) = struct.unpack_from("<i", buf, off)
        off += 4
        if n_meta < 0 or n_payload < 0:
            raise ValueError("corrupt segment: negative count")
        meta = {}
        for _ in range(n_meta):
            (lk,) = struct.unpack_from("<i", buf, off); off += 4
            if lk < 0:
                raise ValueError("corrupt segment: negative key length")
            k = buf[off:off + lk].decode(); off += lk
            (v,) = struct.unpack_from("<q", buf, off); off += 8
            meta[k] = v
        payload = {}
        for _ in range(n_payload):
            (lk,) = struct.unpack_from("<i", buf, off); off += 4
            if lk < 0:
                raise ValueError("corrupt segment: negative key length")
            k = buf[off:off + lk].decode(); off += lk
            ch, size = struct.unpack_from("<ci", buf, off)
            off += struct.calcsize("<ci")
            try:
                dt = np.dtype(ch.decode())
            except TypeError as exc:
                raise ValueError(
                    f"corrupt segment: bad dtype {ch!r}") from exc
            if size < 0:
                raise ValueError("corrupt segment: negative payload size")
            nb = dt.itemsize * size
            if len(buf) - off < nb:
                raise ValueError("corrupt segment: truncated payload")
            payload[k] = np.frombuffer(buf[off:off + nb], dtype=dt).copy()
            off += nb
        return Segment(_METHOD_NAMES[mcode], n_bytes, payload, meta)


# ------------------------------------------------------------------ codecs --

def huffman_encode(data: np.ndarray, hist: Optional[np.ndarray] = None,
                   codebook: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                   device: DeviceLike = None) -> Segment:
    data = np.asarray(data, dtype=np.uint8)
    n = data.size
    _check_group_size(n)
    if hist is None:
        hist = np.bincount(data, minlength=256)
    if codebook is None:
        lengths, codes = build_codebook(hist)
    else:
        lengths, codes = codebook
    dev = resolve_device(device)
    words, total_bits, chunk_offs = _huffman_pack(
        _rows(data, dev),
        torch.from_numpy(lengths.astype(np.int64)).to(dev)[None],
        torch.from_numpy(codes.astype(np.int64)).to(dev)[None])
    total_bits = int(total_bits[0])
    n_words = (total_bits + 31) // 32 + 1
    return Segment(
        "huffman", n,
        payload={
            "words": words[0, :n_words].cpu().numpy().view(np.uint32),
            "chunk_offs": chunk_offs[0].cpu().numpy().astype(np.uint32),
            "lengths": lengths,
        },
        meta={"n_syms": n, "total_bits": total_bits},
    )


def huffman_decode(seg: Segment, device: DeviceLike = None) -> np.ndarray:
    lengths = seg.payload["lengths"]
    # canonical codes are reconstructible from lengths alone
    codes = _codes_from_lengths(lengths)
    lut_sym, lut_len = _build_decode_lut(lengths, codes)
    n = seg.meta["n_syms"]
    _check_group_size(n)
    if n == 0:
        return np.zeros(0, np.uint8)
    dev = resolve_device(device)
    out = _huffman_unpack(
        torch.from_numpy(seg.payload["words"].astype(np.int64)).to(dev)[None],
        torch.from_numpy(seg.payload["chunk_offs"].astype(np.int64)
                         ).to(dev)[None],
        torch.from_numpy(lut_sym).to(dev)[None],
        torch.from_numpy(lut_len).to(dev)[None], n)
    return out[0].cpu().numpy()


def _codes_from_lengths(lengths: np.ndarray) -> np.ndarray:
    codes = np.zeros(256, dtype=np.uint32)
    present = np.nonzero(lengths)[0]
    if len(present) == 0:
        return codes
    order = sorted(present, key=lambda s: (lengths[s], s))
    code = 0
    prev_len = lengths[order[0]]
    for s in order:
        code <<= int(lengths[s]) - int(prev_len)
        codes[s] = code
        code += 1
        prev_len = lengths[s]
    return codes



def rle_encode(data: np.ndarray, device: DeviceLike = None) -> Segment:
    data = np.asarray(data, dtype=np.uint8)
    if data.size == 0:
        return Segment("rle", 0, {"values": np.zeros(0, np.uint8),
                                  "lengths": np.zeros(0, np.uint16)},
                       {"n_syms": 0})
    values, lengths, nruns = _rle_scan(_rows(data, resolve_device(device)))
    r = int(nruns[0])
    return Segment("rle", data.size,
                   payload={"values": values[0, :r].cpu().numpy(),
                            "lengths": lengths[0, :r].cpu().numpy()
                            .astype(np.uint16)},
                   meta={"n_syms": data.size})


def rle_decode(seg: Segment, device: DeviceLike = None) -> np.ndarray:
    n = seg.meta["n_syms"]
    if n == 0:
        return np.zeros(0, np.uint8)
    dev = resolve_device(device)
    out = _rle_expand(
        torch.from_numpy(seg.payload["values"].copy()).to(dev)[None],
        torch.from_numpy(seg.payload["lengths"].astype(np.int64)
                         ).to(dev)[None], n)
    return out[0].cpu().numpy()


def dc_encode(data: np.ndarray) -> Segment:
    data = np.asarray(data, dtype=np.uint8)
    return Segment("dc", data.size, {"raw": data.copy()}, {"n_syms": data.size})


def dc_decode(seg: Segment) -> np.ndarray:
    return seg.payload["raw"]


# -------------------------------------------------------------- Algorithm 2 --

@dataclasses.dataclass
class HybridConfig:
    group_size: int = 4          # m: bitplanes merged per group
    size_threshold: int = 4096   # T_s bytes
    cr_threshold: float = 1.0    # T_cr
    force: Optional[str] = None  # 'huffman' | 'rle' | 'dc' (benchmark modes)


def compress_group(data: np.ndarray, cfg: HybridConfig = HybridConfig(),
                   device: DeviceLike = None) -> Segment:
    """Algorithm 2, inner decision for one merged group (byte symbols).

    The paper's CR-threshold decision gains a store-raw fallback: when the
    chosen codec's EXACT serialized size (``exact_stored_bytes``) would not
    beat storing the group raw, fall back to ``dc``.  ``force`` modes skip
    the fallback (they exist to benchmark a specific codec)."""
    data = np.asarray(data, dtype=np.uint8)
    s = data.size
    _check_group_size(s)
    if cfg.force == "huffman":
        return huffman_encode(data, device=device)
    if cfg.force == "rle":
        return rle_encode(data, device=device)
    if cfg.force == "dc" or s <= cfg.size_threshold:
        return dc_encode(data)
    hist = np.bincount(data, minlength=256)
    r_h, lengths, codes = estimate_huffman(hist, s)
    if r_h > cfg.cr_threshold:
        bits = int(np.sum(hist * lengths.astype(np.int64)))
        if exact_stored_bytes("huffman", s, total_bits=bits) \
                >= exact_stored_bytes("dc", s):
            return dc_encode(data)
        return huffman_encode(data, hist=hist, codebook=(lengths, codes),
                              device=device)
    _, _, nruns = _rle_scan(_rows(data, resolve_device(device)))
    nruns = int(nruns[0])
    r_r = estimate_rle(nruns, s)
    if r_r > cfg.cr_threshold:
        if exact_stored_bytes("rle", s, n_runs=nruns) \
                >= exact_stored_bytes("dc", s):
            return dc_encode(data)
        return rle_encode(data, device=device)
    return dc_encode(data)


def decompress_group(seg: Segment, device: DeviceLike = None) -> np.ndarray:
    if seg.method == "dc":
        return dc_decode(seg)
    return {"huffman": huffman_decode, "rle": rle_decode}[seg.method](
        seg, device=device)
