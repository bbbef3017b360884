"""Pluggable fetch backends for the progressive store.

A port of ``repro.store.backend`` (pure Python: byte ranges never touch the
device here).

A backend serves byte ranges by (key, offset, size), where a key is a
store-root-relative path (e.g. ``segments/vx.seg``).  Implementations:

* ``LocalFileBackend`` — pread-style range reads from files under a root
  directory (thread-safe; one file handle per key, lazily opened).
* ``InMemoryBackend``  — a dict of buffers; the writer's staging target and
  the zero-I/O test double.
* ``CachingBackend``   — wraps any backend with an LRU *segment* cache
  (keyed by exact range) plus an async prefetch queue served by worker
  threads, with hit/miss/byte accounting.  Concurrent readers of the same
  range coalesce on one in-flight fetch.

All methods are thread-safe: the RetrievalService multiplexes many sessions
over one backend.
"""
from __future__ import annotations

import collections
import dataclasses
import io
import os
import threading
from typing import Dict, Optional, Tuple

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.store import reliability as rl


@dataclasses.dataclass
class BackendStats:
    """Byte accounting (thread-safe). ``bytes_fetched`` counts only bytes
    that actually moved from the underlying storage (cache misses +
    prefetches); cache hits count toward ``bytes_served`` alone.

    ``add`` applies one event's counter deltas atomically and ``snapshot``
    reads every field under the same lock, so a snapshot taken while other
    threads serve reads is internally consistent — never e.g. a read counted
    with its served bytes missing (the historical torn-read race)."""
    reads: int = 0
    bytes_served: int = 0
    fetches: int = 0
    bytes_fetched: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    prefetch_issued: int = 0
    prefetch_useful: int = 0
    # prefetch hints shed by the bounded queue (oldest-first) under bursts
    prefetch_dropped: int = 0

    def __post_init__(self):
        self._lock = threading.Lock()

    def add(self, **kw: int) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)

    @property
    def hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = {f.name: getattr(self, f.name)
                   for f in dataclasses.fields(self)}
        total = out["cache_hits"] + out["cache_misses"]
        out["hit_rate"] = out["cache_hits"] / total if total else 0.0
        return out


class FetchBackend:
    """Byte-range fetch interface."""

    #: True when read() results are retained (so a warming read on another
    #: thread makes the subsequent real read cheap). Plain backends discard.
    caches = False

    def read(self, key: str, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def size(self, key: str) -> int:
        raise NotImplementedError

    def prefetch(self, key: str, offset: int, size: int) -> None:
        pass  # hint only; plain backends ignore it

    def close(self) -> None:
        pass


class LocalFileBackend(FetchBackend):
    def __init__(self, root: str):
        self.root = root
        self._files: Dict[str, io.BufferedReader] = {}
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key)

    def read(self, key: str, offset: int, size: int) -> bytes:
        # pread-only: no shared seek state, safe across threads
        with self._lock:
            f = self._files.get(key)
            if f is None:
                f = open(self._path(key), "rb")
                self._files[key] = f
        data = os.pread(f.fileno(), size, offset)
        if len(data) == size:
            return data
        # pread may legally return fewer bytes than asked (signals, pipes,
        # network filesystems): loop until the range is filled, and raise a
        # TYPED truncation error on EOF — a silently-short buffer would reach
        # the decoders as subtly wrong data, not as a failure
        parts = [data]
        got = len(data)
        while got < size:
            chunk = os.pread(f.fileno(), size - got, offset + got)
            if not chunk:
                raise rl.TruncatedReadError(
                    f"truncated read: {key}@{offset}+{size} ended at "
                    f"{got} bytes (EOF inside the addressed range)")
            parts.append(chunk)
            got += len(chunk)
        return b"".join(parts)

    def size(self, key: str) -> int:
        return os.path.getsize(self._path(key))

    def close(self) -> None:
        with self._lock:
            for f in self._files.values():
                f.close()
            self._files.clear()


class InMemoryBackend(FetchBackend):
    def __init__(self, buffers: Optional[Dict[str, bytes]] = None):
        self.buffers: Dict[str, bytes] = dict(buffers or {})

    def read(self, key: str, offset: int, size: int) -> bytes:
        buf = self.buffers[key]
        if offset + size > len(buf):
            raise rl.TruncatedReadError(
                f"truncated read: {key}@{offset}+{size} beyond "
                f"{len(buf)}-byte buffer")
        return bytes(buf[offset:offset + size])

    def size(self, key: str) -> int:
        return len(self.buffers[key])


_Range = Tuple[str, int, int]


class _InFlight:
    """One coalesced fetch: waiters block on ``event``; the owner publishes
    either the cache insert or ``error`` BEFORE setting the event, so a
    failed fetch propagates to every coalesced waiter instead of wedging
    them or fanning out into a retry stampede of duplicate inner reads."""
    __slots__ = ("event", "error")

    def __init__(self):
        self.event = threading.Event()
        self.error: Optional[BaseException] = None


class CachingBackend(FetchBackend):
    """LRU segment cache + async prefetch over an inner backend."""

    caches = True

    def __init__(self, inner: FetchBackend, capacity_bytes: int = 64 << 20,
                 workers: int = 2, prefetch_queue_max: int = 512):
        self.inner = inner
        self.capacity_bytes = capacity_bytes
        self.stats = BackendStats()
        self._cache: "collections.OrderedDict[_Range, bytes]" = collections.OrderedDict()
        self._cached_bytes = 0
        self._lock = threading.Lock()
        self._inflight: Dict[_Range, _InFlight] = {}
        self._queue: "collections.deque[_Range]" = collections.deque()
        # bounded: a prefetch storm (many sessions hinting at once) must not
        # grow the queue without limit — the oldest hints are the stalest,
        # so they are shed first (counted as ``prefetch_dropped``)
        self._queue_max = max(int(prefetch_queue_max), 1)
        self._queue_cv = threading.Condition(self._lock)
        self._closed = False
        self._workers = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(max(workers, 0))]
        for w in self._workers:
            w.start()

    # -- cache mechanics (call with self._lock held) -------------------------
    def _insert(self, rng: _Range, data: bytes) -> None:
        if rng in self._cache:
            return
        self._cache[rng] = data
        self._cached_bytes += len(data)
        while self._cached_bytes > self.capacity_bytes and self._cache:
            _, old = self._cache.popitem(last=False)
            self._cached_bytes -= len(old)

    def _lookup(self, rng: _Range) -> Optional[bytes]:
        data = self._cache.get(rng)
        if data is not None:
            self._cache.move_to_end(rng)
        return data

    # -- fetch path ----------------------------------------------------------
    def _fetch_into_cache(self, rng: _Range) -> Tuple[bytes, bool]:
        """Fetch ``rng`` from the inner backend, coalescing with any other
        thread already fetching the same range.  Returns (data, performed):
        ``performed`` is True only when THIS call did the inner read.

        Failure semantics: an inner read that raises publishes its exception
        on the in-flight entry and clears the entry, so (a) every coalesced
        waiter observes the SAME error instead of re-issuing the read, and
        (b) the next caller starts a fresh fetch — errors are never cached."""
        key, off, size = rng
        while True:
            with self._lock:
                data = self._lookup(rng)
                if data is not None:
                    return data, False
                fl = self._inflight.get(rng)
                if fl is None:
                    fl = self._inflight[rng] = _InFlight()
                    owner = True
                else:
                    owner = False
            if not owner:
                fl.event.wait()
                if fl.error is not None:
                    raise fl.error
                with self._lock:
                    data = self._lookup(rng)
                if data is not None:
                    return data, False
                continue  # evicted before our lookup: loop and try to own
            try:
                data = self.inner.read(key, off, size)
            except BaseException as exc:
                # publish-then-wake ordering: waiters read fl.error after
                # event.wait(), so the error must be set before event.set()
                fl.error = exc
                with self._lock:
                    self._inflight.pop(rng, None)
                fl.event.set()
                raise
            # insert BEFORE waking waiters, so coalesced readers find the
            # data in cache instead of re-reading the range themselves.
            self.stats.add(fetches=1, bytes_fetched=size)
            with self._lock:
                self._insert(rng, data)
                self._inflight.pop(rng, None)
            fl.event.set()
            return data, True

    def read(self, key: str, offset: int, size: int) -> bytes:
        rng = (key, offset, size)
        m = obs_metrics.REGISTRY.get()
        with self._lock:
            data = self._lookup(rng)
        hit = data is not None
        self.stats.add(reads=1, bytes_served=size,
                       **({"cache_hits": 1} if hit else {"cache_misses": 1}))
        obs_trace.event(obs_trace.EV_BACKEND_READ, key=key, bytes=size,
                        hit=hit)
        m.inc("backend.bytes_served", size)
        m.inc("backend.cache_hits" if hit else "backend.cache_misses")
        if hit:
            return data
        data, performed = self._fetch_into_cache(rng)
        if performed:
            m.inc("backend.bytes_fetched", size)
        return data

    def size(self, key: str) -> int:
        return self.inner.size(key)

    # -- prefetch ------------------------------------------------------------
    def prefetch(self, key: str, offset: int, size: int) -> None:
        if not self._workers:
            return
        rng = (key, offset, size)
        dropped = 0
        with self._queue_cv:
            if self._closed or rng in self._cache or rng in self._inflight:
                return
            self._queue.append(rng)
            while len(self._queue) > self._queue_max:
                self._queue.popleft()  # shed the stalest hint first
                dropped += 1
            self._queue_cv.notify()
        self.stats.add(prefetch_issued=1, prefetch_dropped=dropped)
        if dropped:
            obs_metrics.REGISTRY.get().inc("backend.prefetch_dropped",
                                           dropped)

    def _worker(self) -> None:
        # the worker must survive ANY per-item failure: prefetch is a hint,
        # and a dead worker silently degrades every future prefetch.  Only
        # the shutdown path (self._closed) exits the loop.
        while True:
            try:
                with self._queue_cv:
                    while not self._queue and not self._closed:
                        self._queue_cv.wait()
                    if self._closed:
                        return
                    rng = self._queue.popleft()
                _, performed = self._fetch_into_cache(rng)
                if performed:  # the prefetch itself moved the bytes
                    self.stats.add(prefetch_useful=1)
            except Exception:  # noqa: BLE001 - prefetch is best-effort
                pass

    def drop_cache(self) -> None:
        """Forget all cached segments (cold-cache benchmarking)."""
        with self._lock:
            self._cache.clear()
            self._cached_bytes = 0

    def close(self) -> None:
        with self._queue_cv:
            self._closed = True
            self._queue.clear()
            self._queue_cv.notify_all()
        for w in self._workers:
            w.join(timeout=1.0)
        self.inner.close()
