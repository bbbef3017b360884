"""Fault tolerance for store I/O: error taxonomy, checksums, retries, chaos.

A port of ``repro.store.reliability`` (pure Python plus ``zlib.crc32``;
fault draws are seeded exactly as in the reference, so one seed injects the
same faults in both packages).

The store's byte-range read path ("guaranteed error control") is only as
trustworthy as the I/O under it.  This module is the reliability layer the
rest of ``repro_torch.store`` threads through:

* **Taxonomy** — every failure a backend read can surface is typed:
  ``TransientFetchError`` (retryable: flaky I/O, timeouts),
  ``CorruptSegmentError`` (data at rest does not match what the manifest
  recorded — NOT retryable; subclasses ``ValueError`` so pre-existing
  ``Segment.from_bytes`` error contracts still hold),
  ``TruncatedReadError`` (a read ended short of the addressed range),
  ``FatalStoreError`` (missing key/file, programming errors — never retry),
  ``UnreachableSegmentError`` (retries/deadline/circuit-breaker exhausted;
  the *degradation* signal the read path may convert into a wider bound).

* **Integrity** — ``checksum()`` is the store's checksum function (CRC-32,
  ``zlib.crc32``: C-speed and stdlib-only — the container has no CRC32C
  extension and a pure-Python Castagnoli table would blow the <3% overhead
  budget).  Writers record it per (chunk, piece, group) blob in the manifest
  (``GroupRef.crc``) and over the manifest's own ``variables`` body
  (``manifest.json`` key ``"crc32"``); readers verify on every segment read
  (``verify_checksum``).  Both fields are backward/forward compatible:
  absent means unchecked, extra is ignored by old readers — the same
  evolution rules as the ``shards``/``plan`` manifest fields.

* **Resilience** — ``RetryingBackend`` wraps any fetch backend with bounded
  exponential backoff + full jitter, a per-read deadline, and a per-key
  circuit breaker, instrumented as ``repro_torch.obs`` metrics
  (``backend.retries``, ``backend.breaker_open``, span
  ``backend.retry_wait``).  Compose it UNDER ``CachingBackend`` so retries
  coalesce with in-flight reads: ``CachingBackend(RetryingBackend(inner))``.

* **Chaos** — ``FaultInjectionBackend`` is the deterministic fault harness:
  per-visit transient faults and slow reads, plus *sticky* (at-rest)
  corruption/truncation that survives retries, all drawn from a seeded hash
  of (key, offset, size) so concurrent test runs are reproducible.
  ``chaos_from_env`` lets CI wrap every default-constructed store backend
  via ``REPRO_CHAOS=transient=0.05,seed=1234`` without touching test code.

Degradation policy (the fourth pillar) lives where the state is: the read
side (``core.retrieve.ProgressiveReader`` / ``store.service``) catches
``StoreIOError`` per plane group and serves the reconstruction *without*
the unreachable group, returning the honestly widened bound.  See
docs/reliability.md.
"""
from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
import zlib
from typing import Callable, Dict, Optional, Tuple

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


# ------------------------------------------------------------------ errors --

class StoreIOError(Exception):
    """Base of every typed store I/O failure."""


class TransientFetchError(StoreIOError):
    """A read failed in a way a retry may fix (flaky I/O, timeout)."""


class CorruptSegmentError(StoreIOError, ValueError):
    """Bytes at rest do not match what the manifest recorded (checksum
    mismatch, bad framing).  Subclasses ValueError: the pre-checksum decode
    path already raised ValueError on corrupt framing, and callers that
    handle that keep working."""


class TruncatedReadError(CorruptSegmentError):
    """A read ended before the addressed range did (EOF inside the range)."""


class FatalStoreError(StoreIOError):
    """Non-retryable failure: missing key/file, closed backend, bad usage."""


class UnreachableSegmentError(StoreIOError):
    """Retries, deadline, or circuit breaker exhausted for a byte range.
    This is the signal degradation policies convert into a wider bound."""


#: Exception types a retry may fix.  OSError covers real I/O flakiness
#: (EIO, EAGAIN, network filesystems); FileNotFoundError is carved out as
#: fatal in ``classify`` — retrying a missing file never helps.
_TRANSIENT_TYPES = (TransientFetchError, TimeoutError, ConnectionError,
                    InterruptedError, BlockingIOError)


def classify(exc: BaseException) -> str:
    """Map an exception to its retry class: 'transient' | 'corrupt' | 'fatal'."""
    if isinstance(exc, CorruptSegmentError):
        return "corrupt"
    if isinstance(exc, (FatalStoreError, FileNotFoundError, KeyError,
                        NotImplementedError)):
        return "fatal"
    if isinstance(exc, _TRANSIENT_TYPES) or isinstance(exc, OSError):
        return "transient"
    return "fatal"


# --------------------------------------------------------------- integrity --

def checksum(data: bytes) -> int:
    """The store's integrity checksum: CRC-32 over the blob (uint32)."""
    return zlib.crc32(data) & 0xFFFFFFFF


def verify_checksum(blob: bytes, expected: int, context: str = "") -> None:
    """Raise ``CorruptSegmentError`` (and count it) unless ``blob`` matches."""
    got = checksum(blob)
    if got != (expected & 0xFFFFFFFF):
        obs_metrics.REGISTRY.get().inc("backend.checksum_failures")
        raise CorruptSegmentError(
            f"checksum mismatch{f' for {context}' if context else ''}: "
            f"stored crc32=0x{expected & 0xFFFFFFFF:08x}, "
            f"computed 0x{got:08x} over {len(blob)} bytes")


def manifest_body_checksum(variables_json: Dict) -> int:
    """CRC-32 over the canonical serialization of a manifest's ``variables``
    value.  Canonical = ``json.dumps(..., sort_keys=True)`` with default
    separators, which round-trips bit-identically through parse + re-dump —
    so a reader can verify the checksum from the *parsed* manifest without
    keeping the raw file bytes around, and a newer writer's extra keys are
    covered by the checksum it computed itself (forward compatible)."""
    import json
    return checksum(json.dumps(variables_json, sort_keys=True).encode())


# ------------------------------------------------------------------ retry ---

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff + full jitter, deadline, circuit breaker.

    Sleep before attempt ``k`` (k >= 1) is drawn uniformly from
    ``[base/2, base] * 2^(k-1)``, capped at ``max_delay_s`` — full jitter
    keeps coalesced retries from stampeding in lockstep.  A read that would
    sleep past ``deadline_s`` raises ``UnreachableSegmentError`` instead.
    ``breaker_threshold`` consecutive exhausted reads on one key open that
    key's circuit for ``breaker_reset_s``: reads fail fast (no backend
    traffic) until the window passes, then one probe read half-opens it."""
    attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    deadline_s: float = 30.0
    breaker_threshold: int = 5
    breaker_reset_s: float = 30.0


@dataclasses.dataclass
class RetryStats:
    reads: int = 0
    retries: int = 0
    transient_errors: int = 0
    corrupt_errors: int = 0
    fatal_errors: int = 0
    exhausted: int = 0
    breaker_opens: int = 0
    breaker_fast_fails: int = 0

    def snapshot(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class _Breaker:
    """Per-key circuit breaker state (guarded by RetryingBackend._lock)."""
    __slots__ = ("failures", "opened_at")

    def __init__(self):
        self.failures = 0
        self.opened_at: Optional[float] = None


class RetryingBackend:
    """Typed-retry wrapper around any fetch backend (duck-typed: ``read``,
    ``size``, ``prefetch``, ``close``).

    Only *transient* failures are retried; corruption is a property of the
    bytes at rest (a re-read returns the same bytes) and fatal errors never
    improve, so both raise immediately with their type intact.  ``clock``
    and ``sleep`` are injectable for tests.
    """

    caches = False  # retries don't retain bytes; wrap in CachingBackend for that

    def __init__(self, inner, policy: RetryPolicy = RetryPolicy(),
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None):
        self.inner = inner
        self.policy = policy
        self.stats = RetryStats()
        self._clock = clock
        self._sleep = sleep
        self._rng = rng if rng is not None else random.Random()
        self._lock = threading.Lock()
        self._breakers: Dict[str, _Breaker] = {}

    # -- circuit breaker -----------------------------------------------------
    def _breaker(self, key: str) -> _Breaker:
        b = self._breakers.get(key)
        if b is None:
            b = self._breakers[key] = _Breaker()
        return b

    def _check_breaker(self, key: str) -> None:
        with self._lock:
            b = self._breaker(key)
            if b.opened_at is None:
                return
            if self._clock() - b.opened_at >= self.policy.breaker_reset_s:
                # half-open: let this read probe; failure re-opens below
                b.opened_at = None
                b.failures = self.policy.breaker_threshold - 1
                return
            self.stats.breaker_fast_fails += 1
        obs_metrics.REGISTRY.get().inc("backend.breaker_fast_fails")
        raise UnreachableSegmentError(
            f"circuit open for {key!r}: {self.policy.breaker_threshold} "
            f"consecutive failed reads; retrying after "
            f"{self.policy.breaker_reset_s}s")

    def _record_outcome(self, key: str, ok: bool) -> None:
        with self._lock:
            b = self._breaker(key)
            if ok:
                b.failures = 0
                b.opened_at = None
                return
            b.failures += 1
            if (b.failures >= self.policy.breaker_threshold
                    and b.opened_at is None):
                b.opened_at = self._clock()
                self.stats.breaker_opens += 1
                obs_metrics.REGISTRY.get().inc("backend.breaker_open", key=key)

    # -- retry loop ----------------------------------------------------------
    def _run(self, key: str, what: str, fn):
        self._check_breaker(key)
        m = obs_metrics.REGISTRY.get()
        with self._lock:
            self.stats.reads += 1
        t0 = self._clock()
        last: Optional[BaseException] = None
        for attempt in range(1, self.policy.attempts + 1):
            try:
                out = fn()
            except BaseException as exc:  # noqa: BLE001 - classified below
                kind = classify(exc)
                with self._lock:
                    if kind == "transient":
                        self.stats.transient_errors += 1
                    elif kind == "corrupt":
                        self.stats.corrupt_errors += 1
                    else:
                        self.stats.fatal_errors += 1
                if kind == "corrupt":
                    self._record_outcome(key, ok=False)
                    raise
                if kind == "fatal":
                    # fatal does NOT trip the breaker: a missing key says
                    # nothing about the health of the path to other keys
                    raise
                last = exc
                if attempt >= self.policy.attempts:
                    break
                delay = min(self.policy.base_delay_s * (2 ** (attempt - 1)),
                            self.policy.max_delay_s)
                delay *= 0.5 + 0.5 * self._rng.random()  # full jitter
                if self._clock() - t0 + delay > self.policy.deadline_s:
                    break
                with self._lock:
                    self.stats.retries += 1
                m.inc("backend.retries", key=key)
                with obs_trace.span("backend.retry_wait", key=key,
                                    attempt=attempt, delay_s=round(delay, 4)):
                    self._sleep(delay)
                continue
            self._record_outcome(key, ok=True)
            return out
        self._record_outcome(key, ok=False)
        with self._lock:
            self.stats.exhausted += 1
        m.inc("backend.reads_exhausted")
        raise UnreachableSegmentError(
            f"{what} failed after {self.policy.attempts} attempts "
            f"({self._clock() - t0:.3f}s): {last!r}") from last

    # -- FetchBackend surface ------------------------------------------------
    def read(self, key: str, offset: int, size: int) -> bytes:
        return self._run(key, f"read {key}@{offset}+{size}",
                         lambda: self.inner.read(key, offset, size))

    def size(self, key: str) -> int:
        return self._run(key, f"size {key}", lambda: self.inner.size(key))

    def prefetch(self, key: str, offset: int, size: int) -> None:
        self.inner.prefetch(key, offset, size)  # hint only; never retried

    def close(self) -> None:
        self.inner.close()


# -------------------------------------------------------- fault injection ---

@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault mix for ``FaultInjectionBackend`` (rates are per-read draws).

    ``transient`` and ``slow`` are *per-visit*: a retry of the same range
    redraws.  ``corrupt`` and ``truncate`` are *sticky* (at-rest): the
    decision is a pure function of (seed, key, offset, size), so a corrupted
    range stays corrupted across retries and across backend instances with
    the same seed — exactly how real bit rot behaves."""
    transient: float = 0.0
    corrupt: float = 0.0
    truncate: float = 0.0
    slow: float = 0.0
    slow_s: float = 0.005
    seed: int = 0
    # keys never injected (e.g. protect the manifest when a test targets
    # segment reads only); substring match against the backend key
    protect: Tuple[str, ...] = ()


@dataclasses.dataclass
class FaultStats:
    reads: int = 0
    transient_injected: int = 0
    corrupt_injected: int = 0
    truncate_injected: int = 0
    slow_injected: int = 0

    def snapshot(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class FaultInjectionBackend:
    """Deterministic chaos double over any fetch backend.

    Determinism contract: the fault decision for the N-th visit of a given
    (key, offset, size) range depends only on (seed, key, offset, size, N) —
    never on global call order — so multi-threaded test runs reproduce."""

    caches = False

    def __init__(self, inner, faults: FaultConfig = FaultConfig()):
        self.inner = inner
        self.faults = faults
        self.stats = FaultStats()
        self._lock = threading.Lock()
        self._visits: Dict[Tuple[str, int, int], int] = {}

    def _protected(self, key: str) -> bool:
        return any(p in key for p in self.faults.protect)

    @staticmethod
    def _draw(seed_parts: Tuple) -> random.Random:
        return random.Random(hash(seed_parts) & 0xFFFFFFFFFFFF)

    def read(self, key: str, offset: int, size: int) -> bytes:
        f = self.faults
        with self._lock:
            self.stats.reads += 1
            n = self._visits[(key, offset, size)] = \
                self._visits.get((key, offset, size), 0) + 1
        if not self._protected(key):
            visit = self._draw((f.seed, "visit", key, offset, size, n))
            if visit.random() < f.transient:
                with self._lock:
                    self.stats.transient_injected += 1
                raise TransientFetchError(
                    f"injected transient fault: {key}@{offset}+{size} "
                    f"(visit {n})")
            if visit.random() < f.slow:
                with self._lock:
                    self.stats.slow_injected += 1
                time.sleep(f.slow_s)
        data = self.inner.read(key, offset, size)
        if self._protected(key):
            return data
        sticky = self._draw((f.seed, "persist", key, offset, size))
        if sticky.random() < f.corrupt and len(data) > 0:
            with self._lock:
                self.stats.corrupt_injected += 1
            buf = bytearray(data)
            pos = sticky.randrange(len(buf))
            buf[pos] ^= 1 << sticky.randrange(8)
            return bytes(buf)
        if sticky.random() < f.truncate and len(data) > 0:
            with self._lock:
                self.stats.truncate_injected += 1
            return data[:sticky.randrange(len(data))]
        return data

    def size(self, key: str) -> int:
        return self.inner.size(key)

    def prefetch(self, key: str, offset: int, size: int) -> None:
        self.inner.prefetch(key, offset, size)

    def close(self) -> None:
        self.inner.close()


# ------------------------------------------------------------- chaos hook ---

#: Environment knob the CI chaos job sets to run ORDINARY test suites under
#: injected faults: every DatasetStore.open() with a default backend wraps
#: its file backend in FaultInjectionBackend + RetryingBackend.  Format is
#: comma-separated k=v pairs, e.g. ``transient=0.05,seed=1234``; recognized
#: keys: transient, corrupt, truncate, slow, slow_s, seed, attempts,
#: base_delay, max_delay.  Retry delays default fast (5ms base) so suites
#: stay quick.
CHAOS_ENV = "REPRO_CHAOS"


def chaos_from_env(inner, env: Optional[str] = None):
    """Wrap ``inner`` per the ``REPRO_CHAOS`` env var; identity when unset."""
    spec = os.environ.get(CHAOS_ENV) if env is None else env
    if not spec:
        return inner
    kv: Dict[str, float] = {}
    for part in spec.split(","):
        if not part.strip():
            continue
        k, _, v = part.partition("=")
        kv[k.strip()] = float(v) if v else 1.0
    faults = FaultConfig(
        transient=kv.get("transient", 0.0),
        corrupt=kv.get("corrupt", 0.0),
        truncate=kv.get("truncate", 0.0),
        slow=kv.get("slow", 0.0),
        slow_s=kv.get("slow_s", 0.005),
        seed=int(kv.get("seed", 0)))
    policy = RetryPolicy(
        attempts=int(kv.get("attempts", 6)),
        base_delay_s=kv.get("base_delay", 0.005),
        max_delay_s=kv.get("max_delay", 0.05),
        deadline_s=kv.get("deadline", 30.0))
    return RetryingBackend(FaultInjectionBackend(inner, faults), policy,
                           rng=random.Random(int(kv.get("seed", 0))))
