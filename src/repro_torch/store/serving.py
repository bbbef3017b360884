"""High-concurrency serving tier: shared plane cache + coalesced decode.

A port of ``repro.store.serving``.  ``RetrievalService`` multiplexes many
progressive sessions over one store; without this layer every session pays
for its own decode: N sessions at overlapping tolerances fetch the same
byte ranges (deduplicated by the ``CachingBackend``) and then run N
identical lossless + bitplane decodes of the same plane groups.  A decoded
plane group is a pure function of the stored bytes, so that work is
shareable.

``ServingTier`` amortizes it across sessions with three mechanisms, layered
*above* the byte-range ``CachingBackend``:

Shared plane cache
    Decoded-on-device plane groups keyed by ``(variable, chunk, piece,
    group)`` (group ``-1`` is the piece's sign plane), byte-budgeted, LRU
    eviction with popularity-aware admission: a group only displaces cached
    entries that are less popular than itself, so one cold scan cannot
    flush the hot set.  A hit skips the backend read, the lossless decode
    and the bitplane kernel; the session OR-accumulates the cached
    magnitude delta into its own engine state (exact: the bit ranges of
    distinct groups are disjoint, see ``core.reconstruct``).

Request coalescing
    Concurrent sessions wanting the same plane group register on ONE
    in-flight future (the claim table); exactly one session (the owner)
    reads the bytes and decodes, everyone else blocks on the future, with
    the failure contract of ``CachingBackend._fetch_into_cache``: an owner's
    typed store error propagates to every coalesced waiter (each applies
    its own degrade policy) and is NEVER cached.

Cross-session batched decode
    Owners enqueue self-contained decode jobs; the first thread that needs
    results becomes the leader, optionally waits a small batching window
    for other sessions' jobs, then decodes a round-robin fair share of
    every tenant's queue.  The round's host rows go to each device in ONE
    pinned, stacked upload, and each (shape, offset, design, device) bucket
    is ONE ``rb_decode``/``loc_decode`` launch through
    ``kernels.ops.decode_bitplanes_offset_batch`` /
    ``decode_bitplanes_batch``, so pending groups from *different sessions*
    share kernel launches.  Any blocked thread may lead, so cross-owned
    waits never deadlock.

Streams: the leader decodes on each device's default stream, which is
also where every session's engine OR-accumulates (no thread of the read
path sets another current stream), so a decoded tensor is ordered before
its first use by construction and needs neither an event wait nor
``record_stream``.  A cached entry consumed by an engine on another device
is copied there (``.to(device)``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import lossless_batch as lb
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

#: (variable, chunk, piece, group); group == -1 addresses the sign plane.
PlaneKey = Tuple[str, int, int, int]

DEFAULT_PLANE_CACHE_BYTES = 64 << 20
DEFAULT_WINDOW_S = 0.002
DEFAULT_MAX_BATCH_JOBS = 1024


def _default_stream(device: torch.device):
    """Run the enclosed work on ``device``'s default stream (see the module
    note on streams); a no-op on the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.default_stream(device))


# ------------------------------------------------------------------- stats --

@dataclasses.dataclass
class ServingStats:
    """Tier counters (thread-safe).  ``requests`` counts plane-group claims;
    ``plane_hits`` were served from the shared cache, ``coalesced`` by
    waiting on another session's in-flight decode, ``decoded`` are the jobs
    this tier actually ran through the kernels — their sum is ``requests``
    (every claim resolves exactly one way), so
    ``1 - decoded/requests`` is the shared-work (coalesced-read) ratio."""
    requests: int = 0
    plane_hits: int = 0
    coalesced: int = 0
    decoded: int = 0
    decode_rounds: int = 0
    decode_batches: int = 0
    window_waits: int = 0
    admitted: int = 0
    admission_rejects: int = 0
    evictions: int = 0
    errors_propagated: int = 0

    def __post_init__(self):
        self._lock = threading.Lock()

    def add(self, **kw: int) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            out = {f.name: getattr(self, f.name)
                   for f in dataclasses.fields(self)}
        total = out["requests"]
        out["shared_ratio"] = (
            (out["plane_hits"] + out["coalesced"]) / total if total else 0.0)
        out["hit_rate"] = out["plane_hits"] / total if total else 0.0
        return out


# ----------------------------------------------------------------- futures --

@dataclasses.dataclass(frozen=True)
class DecodedPlanes:
    """One shared decode result: the device-resident magnitude delta (or
    decoded sign plane) of a single plane group, uint32 bits in int32
    storage.  Immutable and engine-free, so any number of sessions can OR
    it into their own state."""
    array: torch.Tensor
    kind: str                  # "sign" | "group"
    n_rows: int                # plane rows the group contributes (0 = sign)
    row_bytes: int             # logical plane bytes (what a decode costs)

    @property
    def nbytes(self) -> int:
        return int(self.array.numel()) * 4


class _Future:
    """One in-flight shared decode (publish-then-wake, as the backend's
    ``_InFlight``): ``value`` or ``error`` is set BEFORE ``event``."""
    __slots__ = ("event", "value", "error", "owner")

    def __init__(self, owner: int):
        self.event = threading.Event()
        self.value: Optional[DecodedPlanes] = None
        self.error: Optional[BaseException] = None
        self.owner = owner

    @property
    def done(self) -> bool:
        return self.event.is_set()

    def resolve(self, value: Optional[DecodedPlanes],
                error: Optional[BaseException]) -> None:
        self.value = value
        self.error = error
        self.event.set()


def entry_future(entry: Tuple[str, object]) -> _Future:
    """Uniform engine staging: ``("value", DecodedPlanes)`` (cache hit or
    already-resolved wait) wraps into a pre-resolved future; ``("future",
    fut)`` passes the live in-flight future through."""
    tag, payload = entry
    if tag != "value":
        return payload
    f = _Future(owner=-1)
    f.resolve(payload, None)
    return f


@dataclasses.dataclass
class DecodeJob:
    """A self-contained unit of shared decode work: everything needed to run
    the bitplane kernel, with no reference to any session's engine — so ANY
    thread (owner or not) can decode it and publish the result.  (The
    reference's ``tiles_per_block``/``unroll`` select nothing in the CUDA
    kernels and are not carried.)"""
    key: PlaneKey
    kind: str                  # "sign" | "group"
    rows: np.ndarray           # (P', W) uint32 host rows (sign: (1, W))
    row_offset: int            # rows above this group in the MSB-first stack
    n: int                     # piece element count
    mag_bits: int
    design: str
    backend: str
    device: torch.device
    future: _Future


# -------------------------------------------------------------- plane cache --

def _own_storage(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if it is the only tensor in its storage, else a copy: a
    row of a bucket's (B, n) output would keep the whole output alive while
    its cache entry, which counts only the row's bytes, stays cached."""
    if t.untyped_storage().nbytes() == t.numel() * t.element_size():
        return t
    return t.clone()


class PlaneCache:
    """Byte-budgeted LRU with popularity-aware admission (NOT thread-safe:
    the owning ``ServingTier`` serializes access under its lock).

    Admission mirrors TinyLFU's insight: under Zipf traffic an unbounded
    LRU lets a long tail of one-hit groups evict the hot set.  Every claim
    bumps a key's popularity count (periodically halved so the sketch ages);
    an insert may only evict victims at most as popular as itself —
    otherwise the *candidate* is rejected and the hot entry stays."""

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = int(capacity_bytes)
        self._entries: "collections.OrderedDict[PlaneKey, DecodedPlanes]" = \
            collections.OrderedDict()
        self._bytes = 0
        self._pop: Dict[PlaneKey, int] = {}
        self._pop_total = 0

    @property
    def cached_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def touch(self, key: PlaneKey) -> None:
        """Popularity bump (called on every claim, hit or miss)."""
        self._pop[key] = self._pop.get(key, 0) + 1
        self._pop_total += 1
        if self._pop_total > max(4096, 8 * len(self._pop)):
            # age the sketch: halve everything, drop the zeros
            self._pop = {k: v // 2 for k, v in self._pop.items() if v >= 2}
            self._pop_total = sum(self._pop.values())

    def get(self, key: PlaneKey) -> Optional[DecodedPlanes]:
        v = self._entries.get(key)
        if v is not None:
            self._entries.move_to_end(key)
        return v

    def offer(self, key: PlaneKey, value: DecodedPlanes
              ) -> Tuple[bool, int, int]:
        """Try to admit; returns (admitted, evictions, rejects)."""
        if self.capacity_bytes <= 0 or key in self._entries:
            return False, 0, 0
        self._entries[key] = value
        self._bytes += value.nbytes
        evictions = 0
        mine = self._pop.get(key, 0)
        while self._bytes > self.capacity_bytes and self._entries:
            victim = next(iter(self._entries))
            if victim == key or self._pop.get(victim, 0) > mine:
                # the LRU victim is more popular (or is the candidate
                # itself): reject the candidate instead of churning
                self._bytes -= self._entries.pop(key).nbytes
                return False, evictions, 1
            self._bytes -= self._entries.pop(victim).nbytes
            evictions += 1
        return True, evictions, 0

    def drop(self) -> None:
        self._entries.clear()
        self._bytes = 0


# ------------------------------------------------------------- serving tier --

class ServingTier:
    """Shared plane cache + claim table + combining batched decoder.

    One tier per ``RetrievalService``: all sessions of a service share one
    manifest plan per variable (same design, same chunk -> device
    placement), which is what makes decoded plane groups exchangeable
    between them.  ``cache_bytes=0`` disables retention but keeps the
    coalescing and batching machinery (in-flight claims still dedupe)."""

    def __init__(self, cache_bytes: int = DEFAULT_PLANE_CACHE_BYTES,
                 window_s: float = DEFAULT_WINDOW_S,
                 max_batch_jobs: int = DEFAULT_MAX_BATCH_JOBS):
        self.window_s = float(window_s)
        self.max_batch_jobs = max(int(max_batch_jobs), 1)
        self.stats = ServingStats()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._cache = PlaneCache(cache_bytes)
        self._inflight: Dict[PlaneKey, _Future] = {}
        self._jobs: Dict[int, "collections.deque[DecodeJob]"] = {}
        self._rr: "collections.deque[int]" = collections.deque()
        self._leader_active = False

    # -- claims --------------------------------------------------------------
    def claim(self, tenant: int, keys: Sequence[PlaneKey]
              ) -> Dict[PlaneKey, Tuple[str, object]]:
        """Resolve each key to ``("hit", DecodedPlanes)``, ``("mine",
        _Future)`` (this caller owns fetch+decode and MUST later ``submit``
        or ``fail`` it), or ``("theirs", _Future)`` (another session owns
        it; ``wait_for`` the future)."""
        out: Dict[PlaneKey, Tuple[str, object]] = {}
        n_hits = n_mine = n_theirs = 0
        m = obs_metrics.REGISTRY.get()
        with self._lock:
            for key in keys:
                self._cache.touch(key)
                v = self._cache.get(key)
                if v is not None:
                    out[key] = ("hit", v)
                    n_hits += 1
                    continue
                fl = self._inflight.get(key)
                if fl is not None:
                    out[key] = ("theirs", fl)
                    n_theirs += 1
                    continue
                fl = self._inflight[key] = _Future(owner=tenant)
                out[key] = ("mine", fl)
                n_mine += 1
        self.stats.add(requests=len(keys), plane_hits=n_hits,
                       coalesced=n_theirs)
        if n_hits:
            m.inc("serve.plane_cache_hits", n_hits)
        if n_theirs:
            m.inc("serve.coalesced_groups", n_theirs)
        if n_mine:
            m.inc("serve.plane_cache_misses", n_mine)
        return out

    def fail(self, key: PlaneKey, exc: BaseException) -> None:
        """Owner could not produce ``key`` (fetch failed before submit):
        propagate to every coalesced waiter, never cache."""
        with self._cv:
            fl = self._inflight.pop(key, None)
            if fl is None or fl.done:
                return
            fl.resolve(None, exc)
            self.stats.add(errors_propagated=1)
            self._cv.notify_all()

    def abandon(self, tenant: int, keys: Sequence[PlaneKey],
                exc: BaseException) -> None:
        """Owner is unwinding on an exception: fail every claimed key —
        including jobs already submitted but not yet decoded (their queue
        entries are withdrawn so no thread decodes work nobody will use)."""
        wanted = set(keys)
        with self._cv:
            q = self._jobs.get(tenant)
            if q:
                kept = [j for j in q if j.key not in wanted]
                q.clear()
                q.extend(kept)
            for key in wanted:
                fl = self._inflight.pop(key, None)
                if fl is not None and not fl.done:
                    fl.resolve(None, exc)
                    self.stats.add(errors_propagated=1)
            self._cv.notify_all()

    def should_warm(self, key: PlaneKey) -> bool:
        """Overlap-feeder filter: warming a byte range is pointless when the
        decoded group is already cached or someone is decoding it."""
        with self._lock:
            return (self._cache.get(key) is None
                    and key not in self._inflight)

    # -- decode pipeline -----------------------------------------------------
    def submit(self, tenant: int, jobs: Sequence[DecodeJob]) -> None:
        """Enqueue owned decode work (deferred: decoding happens at drain,
        batched with every other tenant's queue)."""
        if not jobs:
            return
        with self._cv:
            q = self._jobs.get(tenant)
            if q is None:
                q = self._jobs[tenant] = collections.deque()
                self._rr.append(tenant)
            q.extend(jobs)
            self._cv.notify_all()

    def wait_for(self, fut: _Future) -> DecodedPlanes:
        """Block until a coalesced future resolves, pumping the decode queue
        while waiting (a blocked waiter may lead a decode round, so two
        sessions waiting on each other's claims always make progress).
        Raises the owner's error if the shared fetch/decode failed."""
        self._pump_until([fut])
        if fut.error is not None:
            raise fut.error
        return fut.value

    def drain_engines(self, engines: Sequence) -> None:
        """Resolve and apply every engine's staged shared futures.

        Called from ``reconstruct.batch_apply_pending`` (via each engine's
        ``shared`` backref): pumps the combined queue until all futures of
        ``engines`` resolve — one leader decodes the merged, fairness-
        bounded batch — then OR-applies each result into its engine."""
        futs = [f for e in engines for (_, _, f) in e._shared_pending]
        self._pump_until(futs)
        error: Optional[BaseException] = None
        for e in engines:
            pend, e._shared_pending = list(e._shared_pending), []
            for kind, piece, fut in pend:
                if fut.error is not None:
                    error = error or fut.error
                    continue
                v = fut.value
                arr = v.array.to(e.device)  # no copy when already there
                if kind == "sign":
                    e._apply_sign(piece, arr)
                else:
                    e._apply_mag(piece, arr, v.n_rows)
                e.bytes_decoded += v.row_bytes
        if error is not None:
            raise error

    # -- combining pump ------------------------------------------------------
    def _queued(self) -> bool:
        return any(self._jobs.values())

    def _pump_until(self, futures: Sequence[_Future]) -> None:
        while True:
            if all(f.done for f in futures):
                return
            with self._cv:
                if all(f.done for f in futures):
                    return
                if not self._queued() or self._leader_active:
                    # nothing decodable by us right now: the owners have
                    # not submitted yet, or a leader is mid-round — wait
                    # for any publish/submit and re-check
                    self._cv.wait(timeout=0.05)
                    continue
                self._leader_active = True
                wait_window = len({f.owner for f in
                                   self._inflight.values()}) > 1
            try:
                if wait_window and self.window_s > 0:
                    # batching window: other sessions' in-flight claims
                    # will land in the queue momentarily — merging them
                    # into this round shares the kernel launches
                    self.stats.add(window_waits=1)
                    time.sleep(self.window_s)
                with self._lock:
                    batch = self._take_fair_batch()
                if batch:
                    self._decode_round(batch)
            finally:
                with self._cv:
                    self._leader_active = False
                    self._cv.notify_all()

    def _take_fair_batch(self) -> List[DecodeJob]:
        """Round-robin across tenant queues, at most ``max_batch_jobs``:
        a heavy session's backlog cannot monopolize a round — everyone
        else's jobs are interleaved, overflow waits for the next round."""
        batch: List[DecodeJob] = []
        while self._rr and len(batch) < self.max_batch_jobs:
            t = self._rr.popleft()
            q = self._jobs.get(t)
            if not q:
                self._jobs.pop(t, None)
                continue
            batch.append(q.popleft())
            if q:
                self._rr.append(t)
            else:
                self._jobs.pop(t, None)
        return batch

    @staticmethod
    def _upload(buckets: Sequence[List[DecodeJob]], device: torch.device
                ) -> List[torch.Tensor]:
        """One device's share of a round: every bucket's host rows go up in
        ONE stacked copy (pinned on a card, so the copy is asynchronous on
        the default stream), returned as (B, P', W) int32 views, one per
        bucket."""
        sizes = [len(b) * int(b[0].rows.size) for b in buckets]
        total = sum(sizes)
        host = torch.empty((total,), dtype=torch.int32,
                           pin_memory=device.type == "cuda")
        flat = host.numpy()
        off = 0
        for b in buckets:
            for j in b:
                size = int(j.rows.size)
                flat[off:off + size] = np.ascontiguousarray(
                    j.rows, dtype=np.uint32).reshape(-1).view(np.int32)
                off += size
        dev = host.to(device, non_blocking=True) if device.type == "cuda" \
            else host
        out, off = [], 0
        for b, size in zip(buckets, sizes):
            out.append(dev[off:off + size].view(len(b), *b[0].rows.shape))
            off += size
        return out

    def _decode_round(self, batch: List[DecodeJob]) -> None:
        """One combined decode: bucket the round's jobs exactly as
        ``reconstruct.batch_apply_pending`` does (shape/offset/design/
        device), upload each device's rows once, and run one kernel launch
        per bucket; publish every result (cache admission + future resolve)
        before waking waiters."""
        from repro_torch.kernels import ops as kops  # local: flat imports

        self.stats.add(decode_rounds=1, decoded=len(batch))
        with obs_trace.span("serve.shared_decode", jobs=len(batch)):
            groups = [j for j in batch if j.kind == "group"]
            signs = [j for j in batch if j.kind == "sign"]

            def gkey(j: DecodeJob):
                return (int(j.rows.shape[0]), int(j.rows.shape[1]),
                        j.row_offset, j.n, j.mag_bits, j.design, j.backend,
                        j.device)

            def skey(j: DecodeJob):
                return (int(j.rows.shape[1]), j.n, j.design, j.backend,
                        j.device)

            def decode_group(k, stacked):
                n_rows, words, offset, n, mag_bits, design, bk, _ = k
                return kops.decode_bitplanes_offset_batch(
                    stacked, mag_bits, n, offset, design, backend=bk,
                    device=stacked.device), n_rows, 4 * n_rows * words

            def decode_sign(k, stacked):
                words, n, design, bk, _ = k
                return kops.decode_bitplanes_batch(
                    stacked, 1, n, design, backend=bk,
                    device=stacked.device), 0, 4 * words

            work = []  # (bucket jobs, key, decode fn, kind)
            for jobs, key_fn, fn, kind in ((groups, gkey, decode_group,
                                            "group"),
                                           (signs, skey, decode_sign,
                                            "sign")):
                for k, pos in lb.batch_jobs(jobs, key_fn).items():
                    work.append(([jobs[p] for p in pos], k, fn, kind))
            by_device: Dict[torch.device, list] = {}
            for w in work:
                by_device.setdefault(w[0][0].device, []).append(w)
            for dev, items in by_device.items():
                with _default_stream(dev):
                    try:
                        uploads = self._upload([w[0] for w in items], dev)
                    except BaseException as exc:  # fan out to the waiters
                        for w in items:
                            self._publish_error(w[0], exc)
                        if not isinstance(exc, Exception):
                            raise
                        continue
                    for (bucket, k, fn, kind), stacked in zip(items,
                                                               uploads):
                        try:
                            out, n_rows, row_bytes = fn(k, stacked)
                        except BaseException as exc:  # fan out, as above
                            self._publish_error(bucket, exc)
                            if not isinstance(exc, Exception):
                                raise
                            continue
                        self.stats.add(decode_batches=1)
                        for j, arr in zip(bucket, out):
                            self._publish(j, DecodedPlanes(
                                _own_storage(arr), kind, n_rows, row_bytes))
        obs_metrics.REGISTRY.get().inc("serve.shared_decode_jobs", len(batch))

    def _publish(self, job: DecodeJob, value: DecodedPlanes) -> None:
        with self._cv:
            self._inflight.pop(job.key, None)
            admitted, evictions, rejects = self._cache.offer(job.key, value)
            self.stats.add(admitted=int(admitted), evictions=evictions,
                           admission_rejects=rejects)
            job.future.resolve(value, None)
            self._cv.notify_all()
        m = obs_metrics.REGISTRY.get()
        if evictions:
            m.inc("serve.plane_cache_evictions", evictions)
        if rejects:
            m.inc("serve.plane_cache_admission_rejects", rejects)

    def _publish_error(self, bucket: Sequence[DecodeJob],
                       exc: BaseException) -> None:
        """A kernel-level failure poisons the whole bucket: every waiter of
        every job sees the same error; nothing is cached."""
        with self._cv:
            for j in bucket:
                self._inflight.pop(j.key, None)
                if not j.future.done:
                    j.future.resolve(None, exc)
                    self.stats.add(errors_propagated=1)
            self._cv.notify_all()

    # -- introspection -------------------------------------------------------
    def drop_cache(self) -> None:
        """Forget every cached plane group (cold-path benchmarking)."""
        with self._lock:
            self._cache.drop()

    @property
    def inflight_count(self) -> int:
        with self._lock:
            return len(self._inflight)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            cache = {"entries": len(self._cache),
                     "bytes": self._cache.cached_bytes,
                     "capacity_bytes": self._cache.capacity_bytes}
            inflight = len(self._inflight)
        out = self.stats.snapshot()
        out["plane_cache"] = cache
        out["inflight"] = inflight
        return out
