"""Store I/O error taxonomy (the part of ``repro.store.reliability`` the read
path needs).

``ProgressiveReader._fetch_to`` catches ``StoreIOError`` per plane group and,
under ``degrade=True``, serves the reconstruction without the unreachable
group.  Checksums, retries, the circuit breaker and fault injection come
with the store.
"""
from __future__ import annotations


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
