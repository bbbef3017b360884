"""Pipeline optimization (paper §6.1, Fig 4): chunked refactor/reconstruct
with copy/compute overlap.

A port of ``repro.core.pipeline``.  The Fig-4 DAGs map onto three worker
queues:

  Q1 (H2D copy)  -- prefetch of the *next* chunk's input     (green boxes)
  Q2 (compute)   -- decompose + bitplane encode + lossless   (blue/yellow)
  Q3 (D2H copy)  -- serialization of the *previous* chunk    (red boxes)

Fig-4 dependency edges enforced:
  refactor:   S -> I  (prefetch starts once the previous serialize frees DMA1)
              I -> Z  (prefetch must land before lossless of current chunk)
              O overlaps with next chunk's decompose+encode
  reconstruct: X -> I (input prefetch delayed until decompress done)
               X -> O (store of previous result delayed until decode start)

JAX's asynchronous dispatch gave the reference its overlap for free.  Here
the streams are explicit: in pipelined mode the prefetcher thread stages
each chunk in pinned host memory and uploads it on a side CUDA stream of
the chunk's device (``sharded.ShardedRefactorPlan.place``), recording an
event; before the chunk's dispatch the compute stream waits on that event,
and ``record_stream`` keeps the caching allocator from recycling the upload
buffer early (``sharded.PlacedChunk.wait``).  Kernels and torch ops are
queued without host synchronization, so chunk k+1's upload and encode run
on the card while chunk k's lossless finish and serialize run on the host.

Dispatch-ahead (fused write path): with ``fused=True`` the compute stage is
split into *dispatch* (the whole decompose -> quantize -> bitplane-encode
chain of a chunk through its cached plan, ``core.refactor_fused``) and
*finish* (host-side lossless selection + manifest assembly, which
synchronizes).  The refactor loop keeps up to ``dispatch_ahead`` (>= 2
by default) dispatched chunks in flight PER DEVICE, drains the whole window
in one batched finish (one scalar gather + one stacked codec pass — 3 host
syncs per drain, amortized ``3 / (dispatch_ahead * n_shards)`` per chunk),
and refills every device queue from the prefetcher before the host blocks
on a drain.  Stage barriers (``_sync_stage``, a device synchronization) are
taken only when stage timing is on (``stage_timing``, default: serial mode
only) — stage timers need them, the overlap path must not pay them.
``overlap_map``'s feeder look-ahead is configurable (``depth``) on the
reconstruct pipeline.

Entry points run on ``device`` (``None`` means ``cuda``; see
``repro_torch.device``) or on the devices of ``mesh`` (``core.sharded``).
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tune as tn
from repro_torch.core import lossless as ll
from repro_torch.core import lossless_batch as lb
from repro_torch.core import refactor as rf
from repro_torch.core import refactor_fused as rff
from repro_torch.core import retrieve as rtv
from repro_torch.core import sharded as shd
from repro_torch.device import DeviceLike
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class PipelineStats:
    chunks: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    wall_s: float = 0.0
    copy_in_s: float = 0.0
    compute_s: float = 0.0
    copy_out_s: float = 0.0

    @property
    def throughput_gbps(self) -> float:
        return self.bytes_in / max(self.wall_s, 1e-9) / 1e9


def _chunk_slices(n: int, chunk: int) -> List[slice]:
    return [slice(i, min(i + chunk, n)) for i in range(0, n, chunk)]


def _sync_stage(dev: torch.device) -> None:
    """Stage barrier for stage timing: waits for all work queued on the
    device, so a stage's timer stops after its execution, not its dispatch.
    Module-level so tests can count that the pipelined write path never
    calls it per chunk.  (The reference also blocks on device-resident
    segment payloads after a finish; the port's finished segments are host
    arrays, so the finish's own host syncs are the barrier there.)"""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def overlap_map(n_items: int,
                stage1: Callable[[int], object],
                stage2: Callable[[int, object], object],
                pipelined: bool = True,
                depth: int = 1) -> List[object]:
    """Two-stage overlapped map with the Fig-4 X->I dependency structure.

    ``stage1(i)`` (I/O-bound: fetch/decompress/deserialize) runs on a feeder
    thread at most ``depth`` items ahead; ``stage2(i, s1)`` (compute-bound:
    decode/recompose) runs on the calling thread.  Order is preserved and a
    stage-1 exception is re-raised on the caller.  With ``pipelined=False``
    the stages run strictly serially (the paper's baseline mode).

    This is the single overlap primitive shared by the chunked reconstruct
    pipeline and the store retrieval service."""
    out: List[object] = [None] * n_items
    if not pipelined or n_items <= 1:
        for i in range(n_items):
            out[i] = stage2(i, stage1(i))
        return out

    ready: "queue.Queue[tuple]" = queue.Queue(maxsize=max(depth, 1))
    cancel = threading.Event()

    def feeder():
        for i in range(n_items):
            if cancel.is_set():
                break
            try:
                ready.put((i, stage1(i), None))
            except Exception as exc:  # noqa: BLE001 - forwarded to caller
                ready.put((i, None, exc))
                return
        ready.put((-1, None, None))

    # the feeder joins the caller's context: its spans land in the caller's
    # trace and its counter mutations in the caller's context-local stats
    threading.Thread(target=obs_trace.wrap_for_thread(feeder),
                     daemon=True).start()
    while True:
        i, s1, exc = ready.get()
        if exc is not None:
            raise exc  # feeder already exited; nothing left to drain
        if i < 0:
            break
        try:
            out[i] = stage2(i, s1)
        except BaseException:
            # stop the feeder (it runs at most `depth` more stage1 calls)
            # and drain to its sentinel so the thread exits instead of
            # leaking parked on the bounded put.
            cancel.set()
            while True:
                j, _, e2 = ready.get()
                if j < 0 or e2 is not None:
                    break
            raise
    return out


class ChunkedRefactorPipeline:
    """Refactor a large (possibly larger-than-device-memory) array in chunks.

    ``pipelined=False`` executes the same stages strictly serially (the
    paper's Fig-9 baseline); ``pipelined=True`` overlaps the three queues
    with the Fig-4 dependency edges, and additionally dispatch-ahead: the
    fused write engine launches chunk k+1's whole encode chain (one plan
    invocation) before chunk k's host-side lossless/serialize work runs, up
    to ``dispatch_ahead`` chunks in flight.

    ``stage_timing`` controls whether stages hard-synchronize so the
    per-stage timers attribute execution rather than dispatch.  Default is
    ``None``: enabled in serial mode (the stage-sum contract), disabled in
    pipelined mode — the overlap path must not pay a per-chunk device
    synchronization.

    ``mesh`` shards the write across devices (``core.sharded``): chunks are
    placed round-robin on the mesh's chunk-axis devices and each chunk's
    fused dispatch runs on its owning device, so dispatch-ahead becomes
    dispatch-per-*device*-ahead — up to ``dispatch_ahead`` chunks in flight
    on EACH device.  ``mesh=None`` (default) is the single-device path on
    ``device``; a mesh of one device is byte-identical to it.
    """

    def __init__(self, chunk_elems: Optional[int] = None,
                 pipelined: bool = True,
                 levels: int = 2, design: Optional[str] = None,
                 hybrid: Optional[ll.HybridConfig] = None,
                 backend: Optional[str] = None,
                 mag_bits: Optional[int] = None,
                 sink: Optional[Callable[[int, rf.Refactored], bytes]] = None,
                 fused: bool = True, dispatch_ahead: Optional[int] = None,
                 stage_timing: Optional[bool] = None,
                 mesh: shd.MeshLike = None,
                 config: Optional[tn.RefactorConfig] = None,
                 use_tune_cache: bool = True,
                 device: DeviceLike = None):
        # knob resolution order (most local wins): explicit legacy kwargs >
        # explicit config= > cached autotuned winner (out/tune, consulted by
        # default when no config is given) > built-in defaults
        force = hybrid.force if hybrid is not None else None
        base = tn.as_config(config, design=design, mag_bits=mag_bits,
                            hybrid=hybrid, backend=backend,
                            dispatch_ahead=dispatch_ahead,
                            chunk_elems=chunk_elems)
        if config is None and use_tune_cache:
            mesh_probe = shd.resolve_mesh(
                mesh if mesh is not None else base.mesh_devices, device)
            n_dev = len(mesh_probe) if mesh_probe is not None else 1
            cached = tn.cached_config(
                shape=(base.chunk_elems or (1 << 20),), levels=levels,
                backend=base.backend, n_devices=n_dev, device=device)
            if cached is not None:
                base = tn.as_config(cached, design=design, mag_bits=mag_bits,
                                    hybrid=hybrid, backend=backend,
                                    dispatch_ahead=dispatch_ahead,
                                    chunk_elems=chunk_elems)
        self.config = base
        self.chunk_elems = base.chunk_elems or (1 << 20)
        self.pipelined = pipelined
        self.levels = levels
        self.design = base.design
        self.hybrid = base.hybrid(force=force)
        self.backend = base.backend
        self.mag_bits = base.mag_bits
        # sink(chunk_idx, refactored) -> serialized bytes: lets a store writer
        # address individual segments instead of getting one opaque blob per
        # chunk.  Chunks reach the sink in index order.
        self.sink = sink
        self.fused = fused
        self.dispatch_ahead = max(int(base.dispatch_ahead), 1)
        self.stage_timing = (not pipelined) if stage_timing is None \
            else bool(stage_timing)
        # chunk -> device placement and the fused dispatch route; mesh=None
        # is the one default device
        self.sharded = shd.ShardedRefactorPlan(
            mesh if mesh is not None else base.mesh_devices,
            levels=levels, hybrid=self.hybrid, config=base, device=device)
        self.mesh = self.sharded.mesh
        self.stats = PipelineStats()

    @property
    def n_shards(self) -> int:
        return self.sharded.n_shards

    def chunk_shards(self, n_chunks: int) -> List[int]:
        """Round-robin chunk -> shard ordinals (recorded in store manifests)."""
        return [self.sharded.shard_for(ci) for ci in range(n_chunks)]

    # -- stages ------------------------------------------------------------
    # Each stage opens a span (``obs.trace``) carrying the chunk index (and
    # owning-device ordinal when a mesh is set).  Spans record wall time
    # WITHOUT any device barrier — dispatch-heavy stages show dispatch
    # latency, the sync-bearing ``finish`` span shows where execution is
    # actually awaited (its host_sync events mark the exact points).  The
    # legacy ``stage_timing`` barrier mode is unchanged and serial-only.
    def _span_attrs(self, ci: int) -> Dict[str, int]:
        if self.mesh is None:
            return {"chunk": ci}
        return {"chunk": ci, "device": self.sharded.shard_for(ci)}

    def _copy_in(self, host_chunk: np.ndarray, ci: int) -> shd.PlacedChunk:
        t0 = time.perf_counter()
        with obs_trace.span("write.copy_in", **self._span_attrs(ci)):
            # pipelined: pinned memory and a side stream, waited on by the
            # compute stream at dispatch; serial: a plain ordered copy
            placed = self.sharded.place(ci, host_chunk,
                                        async_copy=self.pipelined)
            if self.stage_timing:
                # barrier so copy_in_s measures the transfer, not its
                # dispatch; skipped on the overlap path (no per-chunk sync)
                _sync_stage(self.sharded.device_for(ci))
        self.stats.copy_in_s += time.perf_counter() - t0
        return placed

    def _dispatch(self, placed: shd.PlacedChunk, name: str, ci: int):
        """Launch one chunk's encode.  Fused mode: one plan invocation, no
        sync — returns a ``refactor_fused.PendingChunk`` whose device work
        overlaps later host stages (on the chunk's owning device).
        Non-fused: the full per-piece compute (returns the finished
        ``Refactored``) on the owning device too.

        The reference donates the placed input to its encode program; eager
        PyTorch has no counterpart: the encode allocates its outputs, and the
        placed buffer is freed when its last reference goes after the
        dispatch (``record_stream`` keeps it from being reused before the
        compute stream has read it)."""
        t0 = time.perf_counter()
        with obs_trace.span("write.dispatch", **self._span_attrs(ci)):
            if self.fused:
                out = self.sharded.dispatch(ci, placed, name=name)
            else:
                out = rf.refactor_array(placed.wait(), name=name,
                                        levels=self.levels,
                                        hybrid=self.hybrid, fused=False,
                                        config=self.config,
                                        device=self.sharded.device_for(ci))
        self.stats.compute_s += time.perf_counter() - t0
        return out

    def _finish(self, pending) -> rf.Refactored:
        """Resolve a dispatched chunk (fused: scalar sync + lossless engine)."""
        t0 = time.perf_counter()
        out = (rff.finish_encode(pending)
               if isinstance(pending, rff.PendingChunk) else pending)
        self.stats.compute_s += time.perf_counter() - t0
        return out

    def _finish_many(self, pendings: List[rff.PendingChunk]
                     ) -> List[rf.Refactored]:
        """Resolve a batch of dispatched chunks: ONE host sync gathers the
        whole batch's scalar metadata across devices and ONE stacked codec
        pass packs every chunk (``sharded.finish_many``) — 3 host syncs per
        drained window, not per chunk."""
        t0 = time.perf_counter()
        outs = self.sharded.finish_many(pendings)
        self.stats.compute_s += time.perf_counter() - t0
        return outs

    def _compute(self, placed: shd.PlacedChunk, name: str,
                 ci: int) -> rf.Refactored:
        return self._finish(self._dispatch(placed, name, ci))

    def _copy_out(self, ci: int, refd: rf.Refactored) -> bytes:
        t0 = time.perf_counter()
        with obs_trace.span("write.serialize", **self._span_attrs(ci)):
            if self.sink is not None:
                blob = self.sink(ci, refd)
            else:
                blob = rf.refactored_to_bytes(refd)
            obs_trace.event(obs_trace.EV_SERIALIZE, chunk=ci,
                            bytes=len(blob))
        self.stats.copy_out_s += time.perf_counter() - t0
        return blob

    # -- main loop -----------------------------------------------------------
    def refactor(self, x: np.ndarray, name: str = "var") -> List[bytes]:
        """Returns one serialized Refactored blob per chunk."""
        with obs_trace.span("write.refactor", name=name):
            return self._refactor(x, name)

    def _refactor(self, x: np.ndarray, name: str) -> List[bytes]:
        flat = np.ascontiguousarray(x).reshape(-1)
        slices = _chunk_slices(flat.shape[0], self.chunk_elems)
        t_start = time.perf_counter()
        # per-chunk budget gauges (write.syncs_per_chunk must stay O(1) on
        # the fused path: 3 — one scalar gather + two in the codec engine)
        syncs0 = lb.STATS.host_syncs
        disp0 = rff.STATS.dispatches
        blobs: List[Optional[bytes]] = [None] * len(slices)
        # async-drain attribution (pipelined path): chunks per device at
        # each drain, drain count, and host-blocked seconds during which a
        # device queue sat empty
        depth_at_drain: collections.Counter = collections.Counter()
        n_drains = [0]
        idle_at_drain = [0.0]

        if not self.pipelined:
            for ci, sl in enumerate(slices):
                dev = self._copy_in(flat[sl], ci)
                refd = self._compute(dev, f"{name}.{ci}", ci)
                blobs[ci] = self._copy_out(ci, refd)
        else:
            # Q1: prefetch (H2D), Q3: serialize (D2H); compute on main thread.
            # The prefetch queue holds at least one placed chunk per shard so
            # a mesh's devices never starve waiting on the H2D stage.
            prefetch_q: "queue.Queue[tuple]" = queue.Queue(
                maxsize=max(2, self.n_shards))
            out_q: "queue.Queue[tuple[int, rf.Refactored]]" = queue.Queue(maxsize=2)
            done = threading.Event()
            errors: List[BaseException] = []  # worker exceptions, re-raised

            def prefetcher():
                try:
                    for ci, sl in enumerate(slices):
                        prefetch_q.put((ci, self._copy_in(flat[sl], ci)))  # S -> I
                except BaseException as exc:  # noqa: BLE001 - to caller
                    errors.append(exc)
                prefetch_q.put((-1, None))

            def serializer():
                # on error, keep draining so the producer never blocks on the
                # bounded queue (a sink exception must not hang refactor()).
                while True:
                    item = out_q.get()
                    if item[0] < 0:
                        break
                    if errors:
                        continue
                    try:
                        blobs[item[0]] = self._copy_out(item[0], item[1])
                    except BaseException as exc:  # noqa: BLE001 - to caller
                        errors.append(exc)
                done.set()

            # workers join the caller's context (wrap_for_thread): their
            # spans land in the caller's trace and their counter mutations
            # in the caller's context-local stats
            t1 = threading.Thread(target=obs_trace.wrap_for_thread(prefetcher),
                                  daemon=True)
            t3 = threading.Thread(target=obs_trace.wrap_for_thread(serializer),
                                  daemon=True)
            t1.start(); t3.start()
            # dispatch-ahead window: chunk k+1's fused encode is dispatched
            # (in flight on device) before chunk k's finish (host lossless
            # selection + pack) runs — up to ``dispatch_ahead`` chunks deep.
            # With a mesh the window is per DEVICE: consecutive chunks land
            # on different devices (round-robin), so ``dispatch_ahead``
            # chunks in flight per device means dispatch_ahead * n_shards
            # in the window before the oldest chunk must finish.  Draining
            # is batched across the whole window (one scalar gather + one
            # stacked codec pass per drain, not per round), and the device
            # queues are opportunistically refilled from the prefetcher
            # BEFORE the host blocks on a drain, so the next dispatches
            # overlap the batched finish.
            window = self.dispatch_ahead * self.n_shards
            inflight: "collections.deque[tuple]" = collections.deque()

            def dispatch_one(cj: int, dev) -> None:
                pend = self._dispatch(dev, f"{name}.{cj}", cj)
                if isinstance(pend, rf.Refactored):
                    # non-fused: _dispatch already completed the chunk;
                    # buffering it would only delay the serializer
                    out_q.put((cj, pend))
                else:
                    inflight.append((cj, pend))

            def refill_nowait() -> None:
                # opportunistic, non-blocking: anything the prefetcher has
                # already staged is dispatched now so every device queue is
                # as deep as possible while the host resolves the batch
                while len(inflight) < window:
                    try:
                        cj, dev = prefetch_q.get_nowait()
                    except queue.Empty:
                        return
                    if cj < 0:
                        prefetch_q.put((cj, dev))  # re-park the sentinel
                        return
                    if errors:
                        continue
                    dispatch_one(cj, dev)

            def drain_batch() -> None:
                # pop exactly the oldest window (deterministic batch size,
                # so the sync budget is counter-testable: 3 host syncs per
                # drain — scalars + codec stats + codec payload), refill
                # the device queues, then resolve the batch in one go
                batch = [inflight.popleft()
                         for _ in range(min(window, len(inflight)))]
                refill_nowait()
                depth_at_drain.update(
                    self.sharded.shard_for(cj) for cj, _ in batch)
                live = {self.sharded.shard_for(cj) for cj, _ in inflight}
                n_drains[0] += 1
                t0 = time.perf_counter()
                outs = self._finish_many([p for _, p in batch])
                # idle-at-drain: devices with an empty queue during this
                # host-blocking finish had nothing to execute — attributable
                # scheduler slack (gauged as write.idle_at_drain_s)
                idle_at_drain[0] += (time.perf_counter() - t0) * sum(
                    1 for d in range(self.n_shards) if d not in live)
                for (cj, _), refd in zip(batch, outs):
                    out_q.put((cj, refd))

            try:
                while True:
                    ci, dev = prefetch_q.get()
                    if ci < 0:
                        break
                    if errors:
                        continue  # drain the prefetcher; skip further compute
                    dispatch_one(ci, dev)
                    while len(inflight) >= window:
                        drain_batch()  # O + next dispatch overlap the finish
                while inflight and not errors:
                    drain_batch()
            except BaseException as exc:  # noqa: BLE001 - compute failed
                errors.append(exc)
                while ci >= 0:  # release the prefetcher parked on its put
                    ci, _ = prefetch_q.get()
            out_q.put((-1, None))
            done.wait()
            if errors:
                raise errors[0]

        self.stats.chunks += len(slices)
        self.stats.bytes_in += flat.nbytes
        self.stats.bytes_out += sum(len(b) for b in blobs)
        self.stats.wall_s += time.perf_counter() - t_start
        if slices:
            m = obs_metrics.REGISTRY.get()
            m.gauge("write.syncs_per_chunk",
                    (lb.STATS.host_syncs - syncs0) / len(slices))
            m.gauge("write.dispatches_per_chunk",
                    (rff.STATS.dispatches - disp0) / len(slices))
            if n_drains[0]:
                for d in range(self.n_shards):
                    m.gauge(f"write.inflight_depth.d{d}",
                            depth_at_drain[d] / n_drains[0])
                m.gauge("write.idle_at_drain_s", idle_at_drain[0])
        return [b for b in blobs if b is not None]


class ChunkedReconstructPipeline:
    """Progressive reconstruction of chunked refactored data (Fig 4b).

    Per-chunk decode runs through the device-resident incremental engine
    (``incremental=True``, default): the compute stage decodes the fetched
    plane groups once, keeps the reconstruction on device, and only the
    final concatenation (the D2H copy-out of Fig 4b) pulls results to host.
    ``incremental=False`` drives the from-scratch oracle readers instead.

    ``depth`` is the overlap feeder's look-ahead (``overlap_map`` depth)
    AND the per-device drain window: staged chunks accumulate until
    ``depth * n_shards`` engines hold undecoded plane groups, then one
    per-device batched pass delta-decodes them all (``sharded.drain``) —
    no global round barrier; a device's engines drain together whenever
    the window fills.  Order and exception propagation are preserved at
    any depth.

    ``mesh`` shards reconstruction across devices (``core.sharded``): each
    chunk's incremental engine state lives on the chunk's round-robin
    owning device, decode kernels run there, and only the final host
    concatenation joins the shards.  ``mesh=None`` is the single-device
    path on ``device`` (bit-identical; so is a mesh of one device)."""

    def __init__(self, pipelined: bool = True, backend: Optional[str] = None,
                 incremental: bool = True, depth: Optional[int] = None,
                 mesh: shd.MeshLike = None,
                 config: Optional[tn.RefactorConfig] = None,
                 device: DeviceLike = None):
        # config= replays a store's tuned plan on the read side (kernel
        # tiling + overlap depth); explicit kwargs win, as on the write side
        cfg = tn.as_config(config, backend=backend, depth=depth)
        self.config = cfg
        self.pipelined = pipelined
        self.backend = cfg.backend
        self.incremental = incremental
        self.depth = max(int(cfg.depth), 1)
        self.sharded = shd.ShardedReconstructEngine(
            mesh if mesh is not None else cfg.mesh_devices, device=device)
        self.mesh = self.sharded.mesh
        self.stats = PipelineStats()

    def reconstruct(self, blobs: Sequence[bytes], tol: float) -> np.ndarray:
        with obs_trace.span("read.reconstruct", chunks=len(blobs)):
            return self._reconstruct(blobs, tol)

    def _reconstruct(self, blobs: Sequence[bytes], tol: float) -> np.ndarray:
        t_start = time.perf_counter()
        if not blobs:
            # np.concatenate([]) raises ValueError; an empty chunk list is a
            # valid zero-length dataset (e.g. refactoring an empty array)
            self.stats.wall_s += time.perf_counter() - t_start
            return np.zeros((0,), np.float32)
        outs: List[Optional[torch.Tensor]] = [None] * len(blobs)

        def _attrs(ci: int) -> Dict[str, int]:
            if self.mesh is None:
                return {"chunk": ci}
            return {"chunk": ci, "device": self.sharded.shard_for(ci)}

        def decompress(ci: int) -> rtv.ProgressiveReader:
            t0 = time.perf_counter()
            with obs_trace.span("read.decompress", **_attrs(ci)):
                reader = rtv.ProgressiveReader(
                    rf.refactored_from_bytes(blobs[ci]),
                    backend=self.backend,
                    incremental=self.incremental,
                    device=self.sharded.device_for(ci),
                    config=self.config)
            self.stats.copy_in_s += time.perf_counter() - t0
            return reader

        # Async per-device drains: each chunk's plan+fetch stages its delta
        # plane groups on the chunk's engine WITHOUT decoding (``read.stage``);
        # once a window of ``depth * n_shards`` chunks is staged, ONE
        # per-device batched pass (``sharded.drain`` -> ``reconstruct.
        # batch_apply_pending``) delta-decodes every staged engine — decode
        # launches amortize across the window and never mix devices — then
        # each chunk recomposes from its (already decoded) engine state.
        staged: List[tuple] = []
        window = max(self.depth * self.sharded.n_shards, 1)

        def flush() -> None:
            if not staged:
                return
            t0 = time.perf_counter()
            engines = [r.engine for _, r in staged if r.engine is not None]
            if engines:
                with obs_trace.span("read.drain", chunks=len(engines)):
                    self.sharded.drain(engines)
            for cj, reader in staged:
                with obs_trace.span("read.recompose", **_attrs(cj)):
                    outs[cj], _ = reader.reconstruct_device()
                    if not self.pipelined:
                        # serial mode: the stage ends when its device work
                        # does (the stage-sum contract)
                        _sync_stage(outs[cj].device)
            staged.clear()
            self.stats.compute_s += time.perf_counter() - t0

        def recompose(ci: int, reader: rtv.ProgressiveReader) -> None:
            t0 = time.perf_counter()
            with obs_trace.span("read.stage", **_attrs(ci)):
                fetched = reader.stage_retrieve(tol)
            self.stats.compute_s += time.perf_counter() - t0
            self.stats.bytes_in += fetched
            staged.append((ci, reader))
            if len(staged) >= window:
                flush()

        # X -> I edge: upcoming chunks' deserialization+fetch happens on the
        # overlap_map feeder thread, at most ``depth`` chunks ahead of the
        # compute stage.
        overlap_map(len(blobs), decompress, recompose,
                    pipelined=self.pipelined, depth=self.depth)
        flush()

        self.stats.chunks += len(blobs)
        t0 = time.perf_counter()
        out = np.concatenate([o.reshape(-1).cpu().numpy() for o in outs])
        self.stats.copy_out_s += time.perf_counter() - t0
        self.stats.bytes_out += out.nbytes
        self.stats.wall_s += time.perf_counter() - t_start
        return out
