"""repro_torch.store — persistent progressive data store + retrieval service.

A port of ``repro.store``: a store written by either package opens in the
other and serves the same bytes and values.  The write path chunks an array
through the refactor pipeline and lays the losslessly-encoded plane-group
segments out on disk with per-(chunk, piece, group) byte-range addressing
(layout).  The read path opens the manifest (metadata only), plans greedy
rate allocation against recorded segment sizes, and fetches exactly the
delta byte ranges through a pluggable, caching, prefetching backend —
multiplexed over many concurrent sessions by the RetrievalService.

    writer.DatasetWriter   refactor_array -> pipeline -> segments + manifest
    layout.DatasetStore    manifest + byte-range addressing
    backend.*              local-file / in-memory fetch, LRU cache, prefetch
    service.RetrievalService   sessions, batched decode, QoI serving
    serving.ServingTier    shared plane cache, coalescing, batched decode
    reliability.*          checksums, typed errors, retries, fault injection
"""
from repro_torch.store.backend import (BackendStats, CachingBackend,
                                       FetchBackend, InMemoryBackend,
                                       LocalFileBackend)
from repro_torch.store.serving import (DecodedPlanes, PlaneCache,
                                       ServingStats, ServingTier)
from repro_torch.store.layout import (ChunkEntry, DatasetStore, GroupRef,
                                      Manifest, PieceEntry, VariableEntry)
from repro_torch.store.reliability import (CorruptSegmentError,
                                           FatalStoreError, FaultConfig,
                                           FaultInjectionBackend,
                                           RetryingBackend, RetryPolicy,
                                           StoreIOError, TransientFetchError,
                                           TruncatedReadError,
                                           UnreachableSegmentError)
from repro_torch.store.service import RetrievalService, StoreSegmentSource
from repro_torch.store.writer import DatasetWriter

__all__ = [
    "BackendStats", "CachingBackend", "FetchBackend", "InMemoryBackend",
    "LocalFileBackend", "ChunkEntry", "DatasetStore", "GroupRef", "Manifest",
    "PieceEntry", "VariableEntry", "RetrievalService", "StoreSegmentSource",
    "DatasetWriter", "CorruptSegmentError", "FatalStoreError", "FaultConfig",
    "FaultInjectionBackend", "RetryingBackend", "RetryPolicy", "StoreIOError",
    "TransientFetchError", "TruncatedReadError", "UnreachableSegmentError",
    "DecodedPlanes", "PlaneCache", "ServingStats", "ServingTier",
]
