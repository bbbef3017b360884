"""Chunk -> device placement for the refactor and retrieval workflows.

A port of ``repro.core.sharded``.  Chunks are independent (each is
refactored with its own decomposition, alignment and lossless state), so the
data axis is the *chunk* axis.  The reference's 1-d ``('chunk',)`` ``Mesh``
becomes a list of ``torch.device``s here:

* ``mesh=None`` is the one default device (``cuda`` unless the caller
  passes ``device="cpu"``);
* an int ``n`` is ``make_chunk_mesh(n)``: the first ``n`` cards,
  ``cuda:0 .. cuda:n-1`` (on the CPU, ``n`` shards of the one host device,
  as the reference's host-device meshes are);
* a sequence of devices is taken as given.  One card may appear several
  times (``["cuda:0"] * 4``): its chunks then run in turn on its current
  stream, which is the split path on one card.

Chunk ``ci`` lives on device ``ci % n`` (round-robin).

``ShardedRefactorPlan`` (write side) places each chunk's input on its
owning device and runs the chunk's fused encode there
(``refactor_fused.dispatch_encode``: kernels launch on that device's current
stream); ``dispatch_round`` dispatches one chunk per device, and
``finish_many`` resolves any batch of dispatched chunks with one scalar
gather plus one stacked codec pass (``finish_encode_many``), 3 host syncs
for the batch.  ``refactor_chunks`` runs both a window at a time.

``ShardedReconstructEngine`` (read side) pins each chunk's incremental
reconstruction state to its owning device (``engine_for``); ``reconstruct.
batch_apply_pending`` keys its decode buckets on the device, so a stacked
decode never mixes devices.

The kernel ops' sharded forms (``kernels.ops.encode_bitplanes_sharded``,
``decode_bitplanes_sharded``) split a batch's rows over the same device
lists.

Placement never changes values: every device runs the same code on the same
inputs, so the output is byte-identical to the single-device path (on
several cards: the card tests that need two of them).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import tune as tn
from repro_torch.core import lossless as ll
from repro_torch.core import reconstruct as rc
from repro_torch.core import refactor as rf
from repro_torch.core import refactor_fused as rff
from repro_torch.device import DeviceLike, as_float32, resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

MeshLike = Union[None, int, Sequence[DeviceLike]]

CHUNK_AXIS = "chunk"


# ------------------------------------------------------------------- stats --

@dataclasses.dataclass
class ShardedStats(obs_metrics.StatCounters):
    """Counters for the sharded layer (thread-safe, process-global).

    ``dispatches_by_device`` maps device ordinal (position in the chunk-axis
    device order) to fused dispatches issued there — round-robin placement
    shows up as a flat histogram.  ``rounds`` counts batched finishes (one
    scalar gather each); ``chunks_finished`` the chunks they resolved."""
    rounds: int = 0
    drains: int = 0
    chunks_finished: int = 0

    def __post_init__(self):
        super().__post_init__()
        self.dispatches_by_device: Dict[int, int] = {}

    def add_dispatch(self, ordinal: int) -> None:
        with self._lock:
            self.dispatches_by_device[ordinal] = (
                self.dispatches_by_device.get(ordinal, 0) + 1)

    def snapshot(self) -> Dict[str, object]:
        snap = super().snapshot()
        with self._lock:
            snap["dispatches_by_device"] = dict(self.dispatches_by_device)
        return snap

    def reset(self) -> None:
        super().reset()
        with self._lock:
            self.dispatches_by_device = {}


STATS = ShardedStats()


# -------------------------------------------------------------------- mesh --

def make_chunk_mesh(n_devices: Optional[int] = None,
                    device: DeviceLike = None) -> List[torch.device]:
    """The chunk axis over the first ``n_devices`` cards, ``cuda:0 ..
    cuda:n-1`` (``None``: every card).  When ``device`` is the CPU, ``n``
    shards of the one host device (``None``: one).  Chunk ``ci`` lives on
    entry ``ci % n``."""
    base = resolve_device(device)
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if base.type != "cuda":
        return [base] * (1 if n_devices is None else n_devices)
    count = torch.cuda.device_count()
    if n_devices is None:
        n_devices = count
    if n_devices > count:
        raise ValueError(
            f"requested {n_devices} devices, only {count} available")
    return [torch.device("cuda", k) for k in range(n_devices)]


def resolve_mesh(mesh: MeshLike, device: DeviceLike = None
                 ) -> Optional[List[torch.device]]:
    """Normalize the ``mesh=`` knob: None / device count / device list.

    ``device`` is the default device an int mesh counts from (its type)."""
    if mesh is None:
        return None
    if isinstance(mesh, int):
        return make_chunk_mesh(mesh, device)
    if isinstance(mesh, (list, tuple)):
        if not mesh:
            raise ValueError("an empty device list")
        return [resolve_device(d) for d in mesh]
    raise TypeError(f"mesh must be None, an int, or a device list, got "
                    f"{type(mesh)!r}")


def chunk_devices(mesh: Optional[List[torch.device]],
                  device: DeviceLike = None) -> List[torch.device]:
    """Chunk-axis device order; ``None`` -> the one default device."""
    return [resolve_device(device)] if mesh is None else list(mesh)


@dataclasses.dataclass
class PlacedChunk:
    """A chunk's input on its owning device.  ``ready`` is the event of the
    copy stream the input was uploaded on; None when the copy was ordered on
    the current stream already."""
    tensor: torch.Tensor
    ready: Optional[torch.cuda.Event] = None

    def wait(self) -> torch.Tensor:
        """Order the current stream after the upload and return the input.

        ``record_stream`` tells the caching allocator that the current stream
        uses the buffer, so it is not handed out again (to the copy stream's
        next upload) before the work queued here has read it."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.tensor.device)
            stream.wait_event(self.ready)
            self.tensor.record_stream(stream)
            self.ready = None
        return self.tensor


# -------------------------------------------------------------- write side --

class ShardedRefactorPlan:
    """Chunk -> device placement + per-shard fused dispatch (write side).

    ``place`` may run on another thread than ``dispatch`` (the chunked
    pipeline's prefetcher places, the main thread dispatches)."""

    def __init__(self, mesh: MeshLike,
                 levels: Optional[int] = None,
                 design: Optional[str] = None,
                 mag_bits: Optional[int] = None,
                 hybrid: Optional[ll.HybridConfig] = None,
                 backend: Optional[str] = None,
                 config: Optional[tn.RefactorConfig] = None,
                 device: DeviceLike = None):
        force = hybrid.force if hybrid is not None else None
        cfg = tn.as_config(config, design=design, mag_bits=mag_bits,
                           hybrid=hybrid, backend=backend)
        self.config = cfg
        self.mesh = resolve_mesh(mesh if mesh is not None
                                 else cfg.mesh_devices, device)
        self.devices = chunk_devices(self.mesh, device)
        self.levels = levels
        self.design = cfg.design
        self.mag_bits = cfg.mag_bits
        self.hybrid = cfg.hybrid(force=force)
        self.backend = cfg.backend
        self._copy_streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._lock = threading.Lock()

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    def shard_for(self, ci: int) -> int:
        """Round-robin chunk -> shard ordinal."""
        return ci % self.n_shards

    def device_for(self, ci: int) -> torch.device:
        return self.devices[self.shard_for(ci)]

    def _copy_stream(self, dev: torch.device) -> torch.cuda.Stream:
        with self._lock:
            if dev not in self._copy_streams:
                self._copy_streams[dev] = torch.cuda.Stream(dev)
            return self._copy_streams[dev]

    def place(self, ci: int, host_chunk, async_copy: bool = False
              ) -> PlacedChunk:
        """Copy chunk ``ci``'s input to its owning device (the H2D copy).

        ``async_copy=True`` on a card stages the chunk in pinned host memory
        and uploads it on a side stream of the device, so the upload overlaps
        the compute stream's work; the returned chunk's ``wait`` orders the
        compute stream after it.  Otherwise the copy is ordered on the
        current stream.  The result is always a fresh buffer."""
        dev = self.device_for(ci)
        obs_trace.event(obs_trace.EV_DEVICE_PUT, chunk=ci,
                        device=self.shard_for(ci))
        if dev.type != "cuda" or not async_copy:
            return PlacedChunk(as_float32(host_chunk, dev))
        pinned = torch.empty(np.shape(host_chunk), dtype=torch.float32,
                             pin_memory=True)
        pinned.numpy()[...] = host_chunk
        side = self._copy_stream(dev)
        with torch.cuda.stream(side):
            # the pinned block goes back to PyTorch's caching host allocator,
            # which holds it until this copy has read it
            t = pinned.to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        return PlacedChunk(t, ready)

    def dispatch(self, ci: int, chunk, name: str = "var"
                 ) -> rff.PendingChunk:
        """One fused dispatch on chunk ``ci``'s device.

        ``chunk`` may be a host array (placed here) or a ``PlacedChunk``
        from ``place``.  Under tracing the span carries the owning device
        ordinal."""
        if not isinstance(chunk, PlacedChunk):
            chunk = self.place(ci, chunk)
        dev = self.device_for(ci)
        STATS.add_dispatch(self.shard_for(ci))
        with obs_trace.span("sharded.dispatch", chunk=ci,
                            device=self.shard_for(ci)):
            x = chunk.wait()
            return rff.dispatch_encode(x, name=name, levels=self.levels,
                                       hybrid=self.hybrid, config=self.config,
                                       device=dev)

    def dispatch_round(self, chunks: Sequence[Tuple[int, np.ndarray]],
                       name: str = "var") -> List[rff.PendingChunk]:
        """Dispatch one round: each (ci, host_chunk) to its owning device,
        with no sync, so a round of N chunks on N cards runs concurrently."""
        return [self.dispatch(ci, chunk, name=f"{name}.{ci}")
                for ci, chunk in chunks]

    def finish_many(self, pendings: Sequence[rff.PendingChunk]
                    ) -> List[rf.Refactored]:
        """Resolve a batch of dispatched chunks — any number, any device mix:
        ONE host sync gathers every chunk's scalar metadata and ONE stacked
        lossless pass encodes every chunk's blob rows, so a batch costs 3
        host syncs.  Results come back in input order, byte-identical to
        finishing chunk by chunk."""
        pendings = list(pendings)
        if not pendings:
            return []
        STATS.add(rounds=1, chunks_finished=len(pendings))
        with obs_trace.span("sharded.finish_many", chunks=len(pendings)):
            return rff.finish_encode_many(pendings)

    def finish_round(self, pendings: Sequence[rff.PendingChunk]
                     ) -> List[rf.Refactored]:
        """A round is a batch of one chunk per device: ``finish_many``."""
        return self.finish_many(pendings)

    def refactor_chunks(self, chunks: Sequence[np.ndarray], name: str = "var"
                        ) -> List[rf.Refactored]:
        """Dispatch a window of one chunk per mesh entry, finish it with one
        ``finish_many`` (3 host syncs), and go on to the next window;
        results come back in chunk order."""
        out: List[rf.Refactored] = []
        n = self.n_shards
        for base in range(0, len(chunks), n):
            rnd = [(base + j, c) for j, c in enumerate(chunks[base:base + n])]
            out.extend(self.finish_many(self.dispatch_round(rnd, name=name)))
        return out


# --------------------------------------------------------------- read side --

class ShardedReconstructEngine:
    """Chunk -> device placement for incremental reconstruction state.

    A chunk's reader (and its ``reconstruct.IncrementalReconstructor``) is
    built on ``device_for(ci)``; ``drain`` decodes the staged plane groups
    of many engines with one ``batch_apply_pending`` pass, whose buckets are
    per device.  ``shards`` (a recorded chunk -> shard map) overrides
    round-robin placement, taken modulo the device count."""

    def __init__(self, mesh: MeshLike,
                 shards: Optional[Sequence[int]] = None,
                 device: DeviceLike = None):
        self.mesh = resolve_mesh(mesh, device)
        self.devices = chunk_devices(self.mesh, device)
        self.shards = list(shards) if shards is not None else None

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    def shard_for(self, ci: int) -> int:
        if self.shards is not None and ci < len(self.shards):
            return self.shards[ci] % self.n_shards
        return ci % self.n_shards

    def device_for(self, ci: int) -> torch.device:
        return self.devices[self.shard_for(ci)]

    def engine_for(self, ci: int, ref: rf.Refactored, backend: str = "auto"
                   ) -> rc.IncrementalReconstructor:
        """Chunk ``ci``'s incremental reconstruction state, on its owning
        device."""
        return rc.IncrementalReconstructor(ref, backend=backend,
                                           device=self.device_for(ci))

    @staticmethod
    def drain(engines: Sequence[rc.IncrementalReconstructor]) -> None:
        """Decode many engines' staged plane groups, per device."""
        rc.batch_apply_pending(list(engines))
        STATS.add(drains=1)
