"""Batched, device-resident lossless engine (paper §5 on wide batches).

A port of ``repro.core.lossless_batch``.  The whole chunk's merged plane
groups stay on the device and flow through a handful of wide torch ops.

Write path (``encode_groups`` / ``encode_groups_stacked``), per call:

  1. stack the chunk's group blobs into same-size buckets,
  2. one pass per bucket computes all 256-bin histograms AND all RLE
     run-break counts (``_group_stats_batch``: the ``lossless_stats``
     kernel on the card),
  3. **sync #1** (small): every bucket's stats come to the host in one
     ``host_sync``, where Algorithm-2 selection and canonical-codebook
     construction run,
  4. the Huffman groups of each bucket are packed by one batched
     ``_huffman_pack``, the RLE groups by one batched ``_rle_scan`` (the
     ``huffman_pack`` and ``rle_scan`` kernels on the card),
  5. **sync #2** (payloads): a single ``host_sync`` materializes every
     payload of the chunk.

With the alignment scalars' sync (``refactor_fused.finish_encode``) that is
three host syncs per chunk, as in the reference.  The reference branches on
``jax.default_backend()``; the port branches on the tensors' device: rows on
the CPU take the host twin of the stats pass (``np.bincount``), rows on the
card keep the stats on the card and ship only the stats.

Read path (``decode_segments``): all same-shape Huffman (resp. RLE) segments
of a request are decoded through one batched ``_huffman_unpack`` /
``_rle_expand`` (the ``huffman_decode`` and ``rle_expand`` kernels on the
card), with a single ``host_sync`` for every decoded blob.

Every entry point takes ``backend``: ``"auto"`` runs the device passes as
the kernels of ``kernels/lossless.py`` on the card and as their plain
versions (eager torch) on the CPU, ``"torch"`` the plain versions
everywhere, ``"cuda"`` the kernels (refused on the CPU).

All host materialization goes through ``host_sync`` so tests and benchmarks
can count syncs (``STATS``, context-local via ``obs.trace.ContextLocal``).
Outputs are bit-identical to ``lossless.compress_group`` per group.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import lossless as ll
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import lossless as kl
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


# ------------------------------------------------------------------- stats --

@dataclasses.dataclass
class BatchStats(obs_metrics.StatCounters):
    """Counters for the batched engine (thread-safe).

    ``host_syncs`` counts explicit device->host materializations
    (``host_sync`` calls).  ``*_batches`` count kernel-batch invocations."""
    encode_calls: int = 0
    decode_calls: int = 0
    groups_encoded: int = 0
    groups_decoded: int = 0
    host_syncs: int = 0
    hist_batches: int = 0
    huffman_pack_batches: int = 0
    rle_scan_batches: int = 0
    huffman_unpack_batches: int = 0
    rle_expand_batches: int = 0


class _StatsProxy:
    """Module-level ``STATS`` facade over the context-local instance."""

    def __init__(self, ctx: obs_trace.ContextLocal):
        self._ctx = ctx

    def add(self, **kw: int) -> None:
        self._ctx.get().add(**kw)

    def snapshot(self) -> Dict[str, int]:
        return self._ctx.get().snapshot()

    def reset(self) -> None:
        self._ctx.get().reset()

    def __getattr__(self, name: str):
        return getattr(self._ctx.get(), name)


_STATS_CTX = obs_trace.ContextLocal(BatchStats)
STATS = _StatsProxy(_STATS_CTX)


def stats_scope(stats: Optional[BatchStats] = None):
    """Install a fresh (or given) ``BatchStats`` for the current context."""
    return _STATS_CTX.scope(stats)


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def host_sync(tree, label: str = "host_sync"):
    """The engine's single door to host memory: one counted materialization
    of a tree (dicts, lists, tuples) of tensors as numpy arrays.

    ``label`` names the call site (``codec.stats``, ``codec.payload``,
    ``codec.decode``, ``encode.scalars``, ...) and becomes the attribution
    key of the traced ``host_sync`` event."""
    STATS.add(host_syncs=1)
    obs_trace.event(obs_trace.EV_HOST_SYNC, label=label)
    return _to_host(tree)


# ------------------------------------------------------------ device passes --

def _group_stats_batch(syms: torch.Tensor, backend: str = "auto"):
    """(B, S) uint8 (a same-size bucket, on the card) -> (histograms (B,256)
    int64, RLE run counts (B,) int64), computed on the card: the
    ``lossless_stats`` kernel, or with ``backend="torch"`` (and on the
    CPU) the plain version.

    The run-break rule matches ``lossless._rle_scan`` exactly (neighbor
    change or forced break every RLE_BREAK symbols)."""
    if kl.use_kernel(syms, backend):
        return kl.lossless_stats(syms.contiguous())
    return _group_stats_plain(syms)


def _group_stats_plain(syms: torch.Tensor):
    """``_group_stats_batch``'s plain version: a ``bincount`` over an int64
    copy of the bucket and a neighbour comparison."""
    b, s = syms.shape
    offs = torch.arange(b, dtype=torch.int64, device=syms.device)[:, None]
    hists = torch.bincount((syms.to(torch.int64) + offs * 256).reshape(-1),
                           minlength=b * 256).reshape(b, 256)
    idx = torch.arange(s, dtype=torch.int64, device=syms.device)
    prev = torch.cat([syms[:, :1] ^ 255, syms[:, :-1]], dim=1)
    brk = (syms != prev) | (idx % ll.RLE_BREAK == 0)
    return hists, brk.sum(dim=1)


def _group_stats_host(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host twin of ``_group_stats_batch`` for rows on the CPU: one
    ``np.bincount`` over offset-shifted symbols computes every row's 256-bin
    histogram; the run-break rule matches ``lossless._rle_scan``."""
    B, S = rows.shape
    offs = (np.arange(B, dtype=np.int64) * 256)[:, None]
    hists = np.bincount((rows + offs).reshape(-1), minlength=B * 256)
    hists = hists.reshape(B, 256).astype(np.int32)
    brk = rows[:, 1:] != rows[:, :-1]
    forced = (np.arange(1, S) % ll.RLE_BREAK) == 0
    nruns = 1 + np.sum(brk | forced[None, :], axis=1, dtype=np.int32)
    return hists, nruns


# The batch pack/scan/unpack/expand passes ARE the per-group passes of
# ``lossless`` (they take rows natively, and dispatch on ``backend``) --
# bit-identity with the per-group codecs holds by construction, row for
# row.
_huffman_pack_batch = ll._huffman_pack
_rle_scan_batch = ll._rle_scan
_huffman_unpack_batch = ll._huffman_unpack
_rle_expand_batch = ll._rle_expand


# ---------------------------------------------------------------- utilities --

def _pad_stack(rows: Sequence[np.ndarray], length: int, dtype) -> np.ndarray:
    out = np.zeros((len(rows), length), dtype=dtype)
    for j, r in enumerate(rows):
        out[j, :r.shape[0]] = r
    return out


def batch_jobs(items, key) -> Dict[tuple, List[int]]:
    """Group item indices by ``key(item)`` — the shared shape-batching
    pattern of this engine and the reconstruction engine."""
    jobs: Dict[tuple, List[int]] = {}
    for i, it in enumerate(items):
        jobs.setdefault(key(it), []).append(i)
    return jobs


# ------------------------------------------------------------------- encode --

def _select(size: int, hist: np.ndarray, n_runs: int, cfg: ll.HybridConfig
            ) -> Tuple[str, Optional[Tuple[np.ndarray, np.ndarray]]]:
    """Algorithm-2 inner decision, host side, from device-computed stats.

    Mirrors ``lossless.compress_group`` decision-for-decision so the batched
    engine picks identical methods (and identical Huffman codebooks)."""
    if cfg.force == "huffman":
        return "huffman", ll.build_codebook(hist)
    if cfg.force == "rle":
        return "rle", None
    if cfg.force == "dc" or size <= cfg.size_threshold:
        return "dc", None
    r_h, lengths, codes = ll.estimate_huffman(hist, size)
    if r_h > cfg.cr_threshold:
        bits = int(np.sum(hist * lengths.astype(np.int64)))
        if ll.exact_stored_bytes("huffman", size, total_bits=bits) \
                >= ll.exact_stored_bytes("dc", size):
            return "dc", None
        return "huffman", (lengths, codes)
    if ll.estimate_rle(n_runs, size) > cfg.cr_threshold:
        if ll.exact_stored_bytes("rle", size, n_runs=n_runs) \
                >= ll.exact_stored_bytes("dc", size):
            return "dc", None
        return "rle", None
    return "dc", None


def _as_rows(blob, device: torch.device) -> torch.Tensor:
    if isinstance(blob, torch.Tensor):
        return blob.to(device=device, dtype=torch.uint8).reshape(-1)
    return torch.from_numpy(np.array(blob, dtype=np.uint8).reshape(-1)
                            ).to(device)


def encode_groups(blobs: Sequence, cfg: ll.HybridConfig = ll.HybridConfig(),
                  device: DeviceLike = None,
                  backend: str = "auto") -> List[ll.Segment]:
    """Batched Algorithm 2 over a chunk's merged plane groups.

    ``blobs`` are 1-D uint8 tensors (numpy blobs are placed on ``device``;
    tensors stay where they are).  Returns one ``lossless.Segment`` per
    blob, bit-identical to ``[lossless.compress_group(b, cfg) for b in
    blobs]``, with exactly two host syncs for the whole batch."""
    if not blobs:
        return []
    sizes = [int(np.prod(tuple(b.shape), dtype=np.int64)) for b in blobs]
    for s in sizes:
        ll._check_group_size(s)  # before any upload/dispatch
    STATS.add(encode_calls=1, groups_encoded=len(blobs))

    dev = resolve_device(device) if any(
        not isinstance(b, torch.Tensor) for b in blobs) else None
    rows = [_as_rows(b, b.device if isinstance(b, torch.Tensor) else dev)
            for b in blobs]
    segs: List[Optional[ll.Segment]] = [None] * len(blobs)
    buckets: Dict[tuple, List[int]] = {}
    for i, s in enumerate(sizes):
        if s == 0:
            # empty groups never touch the device; compress_group reproduces
            # the per-group encoder (incl. force modes) exactly
            segs[i] = ll.compress_group(np.zeros(0, np.uint8), cfg,
                                        device=rows[i].device,
                                        backend=backend)
        else:
            buckets.setdefault((s, rows[i].device), []).append(i)
    if not buckets:
        return segs
    stacked = {k: torch.stack([rows[i] for i in idxs])
               for k, idxs in buckets.items()}
    _encode_buckets(stacked, buckets, segs, cfg, backend)
    return segs


def encode_groups_stacked(stacks: Sequence[torch.Tensor],
                          cfg: ll.HybridConfig = ll.HybridConfig(),
                          backend: str = "auto") -> List[ll.Segment]:
    """``encode_groups`` for blobs that are ALREADY stacked on the device.

    ``stacks`` are (B, S) uint8 tensors — one group blob per row, as emitted
    by the fused write engine.  Same-size stacks on one device are merged
    (one ``torch.cat`` per size), so the batch count stays O(#distinct
    sizes).  Returns one ``lossless.Segment`` per row, flattened row-major
    across ``stacks``."""
    sizes: List[int] = []
    for st in stacks:
        s = int(st.shape[1])
        ll._check_group_size(s)  # before any dispatch
        sizes.extend([s] * int(st.shape[0]))
    if not sizes:
        return []
    STATS.add(encode_calls=1, groups_encoded=len(sizes))

    segs: List[Optional[ll.Segment]] = [None] * len(sizes)
    buckets: Dict[tuple, List[int]] = {}
    parts: Dict[tuple, List[torch.Tensor]] = {}
    base = 0
    for st in stacks:
        b, s = int(st.shape[0]), int(st.shape[1])
        if s == 0:
            for i in range(base, base + b):
                segs[i] = ll.compress_group(np.zeros(0, np.uint8), cfg,
                                            device=st.device,
                                            backend=backend)
        else:
            k = (s, st.device)
            buckets.setdefault(k, []).extend(range(base, base + b))
            parts.setdefault(k, []).append(st.to(torch.uint8))
        base += b
    if not buckets:
        return segs
    stacked = {k: (p[0] if len(p) == 1 else torch.cat(p))
               for k, p in parts.items()}
    _encode_buckets(stacked, buckets, segs, cfg, backend)
    return segs


def _encode_buckets(stacked: Dict[tuple, torch.Tensor],
                    buckets: Dict[tuple, List[int]],
                    segs: List[Optional[ll.Segment]],
                    cfg: ll.HybridConfig, backend: str = "auto") -> None:
    """Shared stages of the batched encoder: stats (sync #1), host-side
    Algorithm-2 selection, batched pack/scan (sync #2).  Fills ``segs`` at
    the indices listed in ``buckets``; bucket keys are ``(group_size,
    device)``, so rows never move between devices.

    Rows on the CPU sync the stacked rows themselves and run the stats
    host-side (``_group_stats_host``); dc payloads then come straight from
    the synced rows.  Rows on the card keep the stats pass on the card and
    only the stats cross.  Both keep two syncs per call and are
    byte-identical."""
    for k in stacked:
        kl.use_kernel(k[1], backend)  # refuse an impossible backend early
    on_host = {k: k[1].type == "cpu" for k in stacked}
    # stage 1: all histograms + run counts, one batch per bucket, ONE sync
    host_keys = [k for k in stacked if on_host[k]]
    dev_stats = {}
    for k, st in stacked.items():
        STATS.add(hist_batches=1)
        if not on_host[k]:
            dev_stats[k] = _group_stats_batch(st, backend)
    synced = host_sync({"rows": {k: stacked[k] for k in host_keys},
                        "stats": dev_stats}, label="codec.stats")
    rows_host: Dict[tuple, np.ndarray] = synced["rows"]
    stats_host = dict(synced["stats"])
    for k, rows in rows_host.items():
        stats_host[k] = _group_stats_host(rows)

    # stage 2: Algorithm-2 selection + codebooks (host, trivial)
    methods: Dict[int, str] = {}
    books: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for k, idxs in buckets.items():
        s = k[0]
        hists, nruns = stats_host[k]
        for j, i in enumerate(idxs):
            m, book = _select(s, hists[j].astype(np.int64), int(nruns[j]),
                              cfg)
            methods[i] = m
            if book is not None:
                books[i] = book

    # stage 3: dispatch one pack/scan per (bucket, codec), ONE payload sync
    pend: List[Tuple[str, int, List[int], object]] = []
    want_bits: Dict[int, int] = {}
    for k, idxs in buckets.items():
        s, dev = k
        st = stacked[k]
        pos = {i: j for j, i in enumerate(idxs)}
        h = [i for i in idxs if methods[i] == "huffman"]
        r = [i for i in idxs if methods[i] == "rle"]
        d = [i for i in idxs if methods[i] == "dc"]

        def rows_for(sel_idx: List[int]) -> torch.Tensor:
            if sel_idx == idxs:       # the whole bucket, in order: no gather
                return torch.from_numpy(rows_host[k]) if k in rows_host \
                    else st
            sel = [pos[i] for i in sel_idx]
            if k in rows_host:
                return torch.from_numpy(rows_host[k][np.asarray(sel)])
            return st[torch.tensor(sel, dtype=torch.int64, device=dev)]

        if h:
            lens_tab = torch.from_numpy(
                np.stack([books[i][0] for i in h]).astype(np.int64)).to(dev)
            codes_tab = torch.from_numpy(
                np.stack([books[i][1] for i in h]).astype(np.int64)).to(dev)
            # each stream's bits, known on the host: only the words up to
            # the bucket's longest stored stream cross
            hists = stats_host[k][0]
            for i in h:
                want_bits[i] = int(np.dot(hists[pos[i]].astype(np.int64),
                                          books[i][0].astype(np.int64)))
            n_words = (max(want_bits[i] for i in h) + 31) // 32 + 1
            STATS.add(huffman_pack_batches=1)
            words, bits, offs = _huffman_pack_batch(rows_for(h), lens_tab,
                                                    codes_tab, backend)
            pend.append(("huffman", s, h, (words[:, :n_words], bits, offs)))
        if r:
            STATS.add(rle_scan_batches=1)
            pend.append(("rle", s, r, _rle_scan_batch(rows_for(r),
                                                      backend)))
        if d:
            if k in rows_host:
                # dc payloads are the raw rows — already on host
                for i in d:
                    segs[i] = ll.Segment("dc", s,
                                         {"raw": rows_host[k][pos[i]].copy()},
                                         {"n_syms": s})
            else:
                pend.append(("dc", s, d, rows_for(d)))
    mats = host_sync([p[3] for p in pend], label="codec.payload")

    for (kind, s, idxs, _), mat in zip(pend, mats):
        if kind == "huffman":
            words_b, bits_b, offs_b = mat
            for j, i in enumerate(idxs):
                total_bits = int(bits_b[j])
                if total_bits != want_bits[i]:
                    raise RuntimeError(
                        f"huffman_pack gave {total_bits} bits for a group "
                        f"whose histogram and code lengths give "
                        f"{want_bits[i]}")
                n_words = (total_bits + 31) // 32 + 1
                segs[i] = ll.Segment(
                    "huffman", s,
                    payload={"words": words_b[j, :n_words].view(np.uint32)
                             .copy(),
                             "chunk_offs": offs_b[j].astype(np.uint32),
                             "lengths": books[i][0]},
                    meta={"n_syms": s, "total_bits": total_bits})
        elif kind == "rle":
            vals_b, lens_b, nruns_b = mat
            for j, i in enumerate(idxs):
                r = int(nruns_b[j])
                segs[i] = ll.Segment(
                    "rle", s,
                    payload={"values": vals_b[j, :r].copy(),
                             "lengths": lens_b[j, :r].astype(np.uint16)},
                    meta={"n_syms": s})
        else:
            for j, i in enumerate(idxs):
                segs[i] = ll.Segment("dc", s, {"raw": mat[j].copy()},
                                     {"n_syms": s})

    # per-codec byte accounting (obs.metrics)
    per_codec: Dict[str, List[int]] = {}
    for idxs in buckets.values():
        for i in idxs:
            seg = segs[i]
            acc = per_codec.setdefault(seg.method, [0, 0, 0])
            acc[0] += 1
            acc[1] += seg.n_bytes
            acc[2] += sum(a.nbytes for a in seg.payload.values())
    m = obs_metrics.get()
    for method, (n, bin_, bout) in per_codec.items():
        m.inc("codec.groups", n, codec=method)
        m.inc("codec.bytes_in", bin_, codec=method)
        m.inc("codec.bytes_out", bout, codec=method)


# ------------------------------------------------------------------- decode --

def decode_segments(segs: Sequence[ll.Segment],
                    device: DeviceLike = None,
                    backend: str = "auto") -> List[np.ndarray]:
    """Decode many segments on ``device``, batching same-shape Huffman/RLE
    decodes.

    Segments sharing (method, n_syms) are decoded through ONE batched
    ``_huffman_unpack``/``_rle_expand`` call (Huffman ``words`` are padded to
    the batch max — trailing zeros are exactly what the chunk decoder already
    assumes).  Returns uint8 host blobs aligned with ``segs``; bit-identical
    to ``[lossless.decompress_group(s) for s in segs]``, with one host sync
    for every decoded blob.  The span ``codec.decode`` times the call."""
    if not segs:
        return []
    with obs_trace.span("codec.decode", groups=len(segs)):
        return _decode_segments(segs, resolve_device(device), backend)


def _decode_segments(segs: Sequence[ll.Segment], dev: torch.device,
                     backend: str = "auto") -> List[np.ndarray]:
    kl.use_kernel(dev, backend)  # refuse an impossible backend early
    STATS.add(decode_calls=1, groups_decoded=len(segs))
    outs: List[Optional[np.ndarray]] = [None] * len(segs)
    pending = []  # (indices, device batch) resolved by one host_sync

    def key(seg: ll.Segment):
        return (seg.method, int(seg.meta.get("n_syms", seg.n_bytes)))

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    for (method, n), idxs in batch_jobs(segs, key).items():
        ll._check_group_size(n)  # corrupt metadata must not drive allocation
        if n == 0:
            for i in idxs:
                outs[i] = np.zeros(0, np.uint8)
            continue
        if method == "dc":
            for i in idxs:
                outs[i] = segs[i].payload["raw"]
            continue
        if method == "huffman":
            for i in idxs:
                ll._check_chunk_offs(segs[i])  # before any upload
            luts = [ll._build_decode_lut(
                segs[i].payload["lengths"],
                ll._codes_from_lengths(segs[i].payload["lengths"]))
                for i in idxs]
            words = _pad_stack(
                [segs[i].payload["words"].astype(np.uint32).view(np.int32)
                 for i in idxs],
                max(segs[i].payload["words"].shape[0] for i in idxs),
                np.int32)
            chunk_offs = np.stack([segs[i].payload["chunk_offs"]
                                   .astype(np.int64) for i in idxs])
            lut_sym = np.stack([l[0] for l in luts])
            lut_len = np.stack([l[1] for l in luts])
            STATS.add(huffman_unpack_batches=1)
            pending.append((idxs, _huffman_unpack_batch(
                up(words), up(chunk_offs), up(lut_sym), up(lut_len), n,
                backend)))
        elif method == "rle":
            rmax = max(segs[i].payload["values"].shape[0] for i in idxs)
            values = _pad_stack([segs[i].payload["values"] for i in idxs],
                                rmax, np.uint8)
            lengths = _pad_stack(
                [segs[i].payload["lengths"].astype(np.int32) for i in idxs],
                rmax, np.int32)
            STATS.add(rle_expand_batches=1)
            pending.append((idxs, _rle_expand_batch(up(values), up(lengths),
                                                    n, backend)))
        else:
            raise ValueError(f"cannot decode method {method!r}")

    if pending:
        mats = host_sync([p[1] for p in pending], label="codec.decode")
        for (idxs, _), mat in zip(pending, mats):
            for j, i in enumerate(idxs):
                outs[i] = np.asarray(mat[j], dtype=np.uint8)
    return outs
