"""Retrieval service: many concurrent progressive sessions over one store.

A port of ``repro.store.service``.  Sessions decode on the service's
``device`` (by default the store's, ``None`` meaning ``cuda``) or on the
devices of ``mesh``; reconstructions are torch tensors on the device
(``*_device``) or numpy arrays on the host.

Layering (read path)::

    RetrievalService
      └─ Session (per client; state = groups already shipped per variable)
           └─ StoreVariableReader (per variable; one ProgressiveReader per
              stored chunk, fed by StoreSegmentSource byte-range fetches)

Serving a request runs in two stages mapped onto the core pipeline's overlap
primitive (``core.pipeline.overlap_map``): the feeder thread *warms* the
backend cache with exactly the delta byte ranges the greedy plan needs
(I/O), while the caller thread runs lossless decompress + bitplane decode
(compute).  Every chunk reader owns a device-resident incremental
reconstruction engine (``core.reconstruct``), so serving decodes only the
*delta* plane groups a request fetched: ``reconstruct_many`` drains the
staged groups of every engine in the batch and decodes each same-shaped
(rows, words, n, offset) bucket — across chunks, variables, and sessions —
through one batched kernel launch, which is where multi-session serving wins
over running each reader alone.

Both max-norm (``Session.retrieve``) and QoI (``Session.retrieve_qoi``)
requests are incremental: repeating a request with a tighter tolerance
fetches (and decodes) only the additional plane groups.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tune as tn
from repro_torch.core import pipeline as pl
from repro_torch.core import qoi as qq
from repro_torch.core import sharded as shd
from repro_torch.core.retrieve import ProgressiveReader, SegmentSource
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.store import layout as lo
from repro_torch.store import serving as sv


class StoreSegmentSource(SegmentSource):
    """Resolves (piece, group) to byte-range reads on a store backend."""

    def __init__(self, store: lo.DatasetStore, var: str, chunk: int):
        self._store = store
        self._var = var
        self._pieces = store.variable(var).chunks[chunk].pieces

    def _ref(self, piece: int, group: int) -> lo.GroupRef:
        p = self._pieces[piece]
        return p.sign if group < 0 else p.groups[group]

    def sign(self, piece: int):
        return self._store.read_segment(self._var, self._ref(piece, -1))

    def group(self, piece: int, group: int):
        return self._store.read_segment(self._var, self._ref(piece, group))

    def prefetch(self, wants: List[Tuple[int, int]]) -> None:
        for piece, group in wants:
            self._store.prefetch_segment(self._var, self._ref(piece, group))

    def warm(self, wants: List[Tuple[int, int]]) -> int:
        """Synchronously pull the ranges into the backend cache (the overlap
        feeder's I/O stage).  No-op on cache-less backends, where the read
        would be discarded and the real fetch would re-issue it.  Best-effort:
        a failing range is skipped — warming is a cache hint, and the real
        fetch in ``_fetch_to`` is where failure policy (retry exhaustion,
        degradation) is decided.  Returns bytes read."""
        if not getattr(self._store.backend, "caches", False):
            return 0
        total = 0
        for piece, group in wants:
            ref_ = self._ref(piece, group)
            try:
                self._store.backend.read(
                    self._store.variable(self._var).segment_file,
                    ref_.offset, ref_.size)
            except Exception:  # noqa: BLE001 - warming is best-effort
                continue
            total += ref_.size
        return total


# ------------------------------------------------------------ batched decode --

def reconstruct_many(readers: Sequence[ProgressiveReader],
                     backend: str = "auto"
                     ) -> List[Tuple[torch.Tensor, float]]:
    """Decode + recompose many readers, batching same-shaped *delta* decodes.

    Each incremental reader's engine holds the newly fetched, still-undecoded
    plane groups; ``reconstruct.batch_apply_pending`` decodes every
    same-shaped (rows, words, n, offset) bucket — across pieces, chunks,
    variables, and sessions — through ONE batched
    ``kernels.ops.decode_bitplanes_offset_batch`` launch (grouping shared with
    the codec engine via ``lossless_batch.batch_jobs``).  Mesh-sharded
    readers drain per device (``core.sharded``): buckets never mix devices,
    each launch runs where its engine state lives.  Unlike the old
    cross-session *full* decode, already-decoded state is never re-run:
    clean engines serve their cached reconstruction.  Returns
    [(device tensor, bound)] aligned with ``readers``; oracle
    (``incremental=False``) readers fall back to their own full decode."""
    shd.ShardedReconstructEngine.drain(
        [r.engine for r in readers if r.incremental])
    return [r.reconstruct_device() for r in readers]


# ------------------------------------------------------------ variable reader --

class _VarRef:
    """Facade matching the slice of ``Refactored`` the QoI loop touches."""

    def __init__(self, var: lo.VariableEntry, readers: List[ProgressiveReader]):
        self.data_amax = var.amax
        self.data_range = var.range
        self.shape = var.shape
        self.n_elements = var.n_elements
        self.pieces = [pm for r in readers for pm in r.ref.pieces]


class StoreVariableReader:
    """Progressive reader over one stored (possibly chunked) variable.

    Chunk states are independent (each chunk was refactored separately), so
    the variable-level bound is the max over chunk bounds and a tolerance
    request maps to the same tolerance per chunk."""

    # ``incremental=False`` wires the chunk readers to the from-scratch
    # full-decode oracle: EVERY reconstruction re-decodes every chunk with
    # no cross-chunk batching or caching.  It exists for bit-exactness
    # debugging against the engine, not for serving.
    def __init__(self, store: lo.DatasetStore, name: str,
                 backend: Optional[str] = None, incremental: bool = True,
                 depth: Optional[int] = None, mesh: shd.MeshLike = None,
                 degrade: bool = False,
                 shared: Optional[sv.ServingTier] = None, tenant: int = 0,
                 device: DeviceLike = None):
        var = store.variable(name)
        self.var = var
        self.name = name
        # replay the write-time plan recorded in the manifest (decode
        # backend + overlap depth); absent on pre-autotune stores the
        # built-in defaults apply.  Explicit kwargs win over the plan, the
        # same resolution order as the write side.
        plan_cfg = (tn.RefactorConfig.from_json(var.plan)
                    if var.plan is not None else None)
        cfg = tn.as_config(plan_cfg, backend=backend, depth=depth)
        self.plan_config = cfg
        self.backend = cfg.backend
        self.incremental = incremental
        self.depth = max(int(cfg.depth), 1)  # overlap feeder look-ahead
        # chunk -> device placement: the manifest's recorded shard map (if
        # the variable was written sharded) taken modulo this mesh's size,
        # else round-robin; mesh=None puts every engine on ``device``
        self.sharded = shd.ShardedReconstructEngine(
            mesh, shards=var.shards,
            device=store.device if device is None else device)
        self.degrade = degrade
        # shared=: the service's serving tier (plane cache + coalescing +
        # cross-session batched decode).  Scope keys by (variable, chunk):
        # every session of one service replays the same manifest plan, so
        # decoded plane groups are exchangeable across its sessions.
        self.chunk_readers = [
            ProgressiveReader(lo.chunk_refactored(var, ci),
                              source=StoreSegmentSource(store, name, ci),
                              incremental=incremental,
                              device=self.sharded.device_for(ci),
                              config=cfg, degrade=degrade,
                              shared=shared, shared_scope=(name, ci),
                              shared_tenant=tenant)
            for ci in range(len(var.chunks))]
        self.ref = _VarRef(var, self.chunk_readers)
        # assembled-variable cache, keyed on the fetch signature; per-chunk
        # reconstructions are cached inside each chunk reader's engine.  The
        # host copy is memoized separately so repeat requests at a met
        # tolerance return the identical ndarray object (no re-decode, no
        # re-transfer).
        self._recon: Optional[Tuple[tuple, torch.Tensor, float]] = None
        self._recon_np: Optional[Tuple[tuple, np.ndarray]] = None

    # -- QoI-loop surface ----------------------------------------------------
    @property
    def state(self):
        return [s for r in self.chunk_readers for s in r.state]

    @property
    def total_bytes_fetched(self) -> int:
        return sum(r.total_bytes_fetched for r in self.chunk_readers)

    def current_bound(self) -> float:
        return max((r.current_bound() for r in self.chunk_readers), default=0.0)

    def floor_bound(self) -> float:
        return max((r.floor_bound() for r in self.chunk_readers), default=0.0)

    def peek_best(self) -> Tuple[float, Optional[Tuple[int, int]]]:
        best_score, best = -1.0, None
        for ci, r in enumerate(self.chunk_readers):
            score, piece = r.peek_best()
            if piece is not None and score > best_score:
                best_score, best = score, (ci, piece)
        return best_score, best

    def fetch_one_more_group(self) -> int:
        _, best = self.peek_best()
        if best is None:
            return 0
        ci, piece = best
        r = self.chunk_readers[ci]
        target = [s.groups_fetched for s in r.state]
        target[piece] += 1
        return r._fetch_to(target)

    def decoded_plane_bytes(self) -> int:
        return sum(r.decoded_plane_bytes() for r in self.chunk_readers)

    def delta_decoded_bytes(self) -> int:
        return sum(r.delta_decoded_bytes() for r in self.chunk_readers)

    @property
    def degraded_count(self) -> int:
        """Plane groups dropped by the degrade policy across all chunks."""
        return sum(r.degraded_count for r in self.chunk_readers)

    @property
    def degraded(self) -> List[Tuple[int, int, int, str]]:
        """(chunk, piece, group, errtype) degradation events, all chunks."""
        return [(ci, p, g, e) for ci, r in enumerate(self.chunk_readers)
                for (p, g, e) in r.degraded]

    def reset_degraded(self) -> None:
        for r in self.chunk_readers:
            r.reset_degraded()

    # -- retrieval -----------------------------------------------------------
    def _assemble(self, outs: List[Tuple[torch.Tensor, float]]
                  ) -> Tuple[torch.Tensor, float]:
        d0 = self.sharded.devices[0]
        if not outs:
            return torch.zeros(self.var.shape, dtype=torch.float32,
                               device=d0), 0.0
        # shards live on their owning devices; torch.cat requires colocated
        # operands, so gather to the first device (the read side's join —
        # values are bit-unchanged)
        flat = torch.cat([o[0].reshape(-1).to(d0) for o in outs])
        return flat.reshape(self.var.shape), max(o[1] for o in outs)

    # The assembled variable is cached on the fetch signature; chunk-level
    # reuse lives in each chunk reader's engine (clean engines return their
    # cached device array, partially-stale ones recompose only a suffix).
    # Returned arrays are shared — treat as read-only.
    def _signature(self) -> tuple:
        return tuple(s.groups_fetched
                     for r in self.chunk_readers for s in r.state)

    def reconstruct_device(self) -> Tuple[torch.Tensor, float]:
        sig = self._signature()
        if self._recon is not None and self._recon[0] == sig:
            return self._recon[1], self._recon[2]
        outs = reconstruct_many(self.chunk_readers, self.backend)
        x, bound = self._assemble(outs)
        self._recon = (sig, x, bound)
        return x, bound

    def reconstruct(self) -> Tuple[np.ndarray, float]:
        x_dev, bound = self.reconstruct_device()
        sig = self._recon[0]
        if self._recon_np is None or self._recon_np[0] != sig:
            self._recon_np = (sig, x_dev.cpu().numpy())
        return self._recon_np[1], bound

    def retrieve_device(self, tol: float, relative: bool = False
                        ) -> Tuple[torch.Tensor, float, int]:
        if relative:
            tol = tol * self.var.range
        fetched = _warm_and_fetch([(r, r.plan(tol)) for r in self.chunk_readers],
                                  depth=self.depth)
        x, bound = self.reconstruct_device()
        return x, bound, fetched

    def retrieve(self, tol: float, relative: bool = False
                 ) -> Tuple[np.ndarray, float, int]:
        _, bound, fetched = self.retrieve_device(tol, relative=relative)
        x, _ = self.reconstruct()  # memoized host copy of the same state
        return x, bound, fetched


def _warm_and_fetch(plans: List[Tuple[ProgressiveReader, List[int]]],
                    depth: int = 2) -> int:
    """Overlapped fetch of many chunk plans: backend I/O (cache warming) on
    the feeder thread, at most ``depth`` plans ahead of the lossless
    decompress running on the caller thread."""
    def warm(i: int):
        r, target = plans[i]
        wants = r.pending_deltas(target)
        if r.shared is not None:
            # serving tier: warming a byte range whose DECODED group is
            # already cached (or being decoded by another session) is pure
            # waste — and would break the one-backend-read-per-group
            # contract's accounting.  Empty pieces are never read at all.
            wants = [d for d in wants
                     if r.ref.pieces[d[0]].n > 0
                     and r.shared.should_warm(r.shared_scope + d)]
        if wants and hasattr(r.source, "warm"):
            with obs_trace.span("serve.warm", chunk=i, groups=len(wants)):
                r.source.warm(wants)
        return target

    def fetch(i: int, target) -> int:
        with obs_trace.span("serve.fetch", chunk=i):
            return plans[i][0]._fetch_to(target)

    return sum(pl.overlap_map(len(plans), warm, fetch, depth=depth))


# ---------------------------------------------------------------- sessions --

@dataclasses.dataclass
class SessionStats:
    """Per-session counters (thread-safe).  ``add`` applies a whole request's
    deltas atomically and ``snapshot`` reads under the same lock, so a
    snapshot taken mid-request never shows e.g. the request counted with its
    bytes missing (the historical torn-read race)."""
    requests: int = 0
    bytes_fetched: int = 0
    qoi_iterations: int = 0
    # plane groups served WITHOUT their data under the degrade policy —
    # every one of these widened some returned bound
    degraded_groups: int = 0

    def __post_init__(self):
        self._lock = threading.Lock()

    def add(self, **kw: int) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {f.name: getattr(self, f.name)
                    for f in dataclasses.fields(self)}


class Session:
    """One client's progressive state over the store (thread-confined; take
    ``Session.lock`` when driving one session from several threads)."""

    def __init__(self, service: "RetrievalService", sid: int):
        self.service = service
        self.sid = sid
        self.lock = threading.Lock()
        self.stats = SessionStats()
        self._readers: Dict[str, StoreVariableReader] = {}

    def reader(self, var: str) -> StoreVariableReader:
        r = self._readers.get(var)
        if r is None:
            r = StoreVariableReader(self.service.store, var,
                                    self.service.backend,
                                    incremental=self.service.incremental,
                                    depth=self.service.depth,
                                    mesh=self.service.mesh,
                                    degrade=self.service.degrade,
                                    shared=self.service.tier,
                                    tenant=self.sid,
                                    device=self.service.device)
            self._readers[var] = r
        return r

    def _record_degraded(self, readers: Sequence[StoreVariableReader],
                         before: int) -> int:
        """Fold NEW degradation events since ``before`` into stats/metrics."""
        delta = sum(r.degraded_count for r in readers) - before
        if delta > 0:
            self.stats.add(degraded_groups=delta)
            obs_metrics.REGISTRY.get().inc("serve.degraded_groups", delta)
        return delta

    @property
    def bytes_fetched(self) -> int:
        return sum(r.total_bytes_fetched for r in self._readers.values())

    def retrieve(self, var: str, tol: float, relative: bool = False
                 ) -> Tuple[np.ndarray, float, int]:
        """Progressive max-norm retrieval; incremental across calls."""
        t0 = time.perf_counter()
        with obs_trace.span("serve.retrieve", session=self.sid, var=var):
            r = self.reader(var)
            deg_before = r.degraded_count
            x, bound, fetched = r.retrieve(tol, relative=relative)
        self.stats.add(requests=1, bytes_fetched=fetched)
        self._record_degraded([r], deg_before)
        m = obs_metrics.REGISTRY.get()
        m.inc("serve.requests")
        m.inc("serve.bytes_fetched", fetched)
        m.observe("serve.retrieve_s", time.perf_counter() - t0)
        return x, bound, fetched

    def retrieve_qoi(self, variables: Sequence[str], q: qq.QoI, tau: float,
                     method: str = "mape", **kw) -> qq.QoIRetrievalResult:
        """Guaranteed-QoI retrieval (Algorithm 3) over store-backed readers;
        session state persists, so tightening tau is incremental too."""
        readers = [self.reader(v) for v in variables]
        before = sum(r.total_bytes_fetched for r in readers)
        deg_before = sum(r.degraded_count for r in readers)
        res = qq.progressive_qoi_retrieve(readers, q, tau, method=method, **kw)
        self.stats.add(
            requests=1, qoi_iterations=res.iterations,
            bytes_fetched=sum(r.total_bytes_fetched
                              for r in readers) - before)
        self._record_degraded(readers, deg_before)
        return res


class RetrievalService:
    """Multiplexes concurrent progressive-retrieval sessions over one store."""

    def __init__(self, store: lo.DatasetStore, backend: Optional[str] = None,
                 incremental: bool = True, depth: Optional[int] = None,
                 mesh: shd.MeshLike = None, degrade: bool = False,
                 serving: bool = True,
                 plane_cache_bytes: Optional[int] = None,
                 coalesce_window_s: float = sv.DEFAULT_WINDOW_S,
                 device: DeviceLike = None):
        self.store = store
        self.device = (store.device if device is None
                       else resolve_device(device))
        # None lets each variable reader replay its manifest plan (tuned
        # decode knobs); an explicit value overrides the plan for every var
        self.backend = backend
        self.incremental = incremental
        self.depth = depth
        # degrade=True: unreachable plane groups widen the served bound
        # instead of failing the request
        self.degrade = degrade
        # mesh-sharded serving: every session's variable readers place their
        # chunk engines across this mesh's devices (core.sharded)
        self.mesh = shd.resolve_mesh(mesh, self.device)
        # the serving tier (store.serving): shared plane cache + request
        # coalescing + cross-session batched decode.  One tier per service —
        # its sessions share manifest plans and mesh placement, which is
        # what makes decoded plane groups exchangeable between them.
        # ``plane_cache_bytes=0`` keeps coalescing but disables retention;
        # ``serving=False`` turns the tier off entirely (fully private
        # per-session decode).  The oracle path (incremental=False) is
        # always private by construction.
        self.tier = (sv.ServingTier(
            cache_bytes=(sv.DEFAULT_PLANE_CACHE_BYTES
                         if plane_cache_bytes is None
                         else int(plane_cache_bytes)),
            window_s=coalesce_window_s)
            if serving and incremental else None)
        self._sessions: Dict[int, Session] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    # -- session management --------------------------------------------------
    def open_session(self) -> Session:
        with self._lock:
            sid = next(self._ids)
            s = Session(self, sid)
            self._sessions[sid] = s
            return s

    def close_session(self, session: Session) -> None:
        with self._lock:
            self._sessions.pop(session.sid, None)

    @property
    def sessions(self) -> List[Session]:
        with self._lock:
            return list(self._sessions.values())

    # -- batched serving -----------------------------------------------------
    def retrieve_many(self, requests: Sequence[Tuple[Session, str, float]]
                      ) -> List[Tuple[np.ndarray, float, int]]:
        """Serve several (session, var, tol) requests in one batch.

        All requests' delta ranges are fetched through one overlapped pass,
        then the staged (still-undecoded) plane groups of every distinct
        reader are delta-decoded in one ``reconstruct.batch_apply_pending``
        pass — same-shaped groups across sessions share kernel launches, and
        state decoded for earlier requests is never re-decoded.  Duplicate
        (session, var) pairs in one batch share state: all get the
        (tightest) result, the fetched-byte delta is attributed to the first
        occurrence."""
        uniq: Dict[int, dict] = {}  # id(reader) -> accounting entry
        req_entries: List[Tuple[dict, bool]] = []
        # one plan per distinct chunk reader (elementwise max over duplicate
        # requests), so the overlapped fetch never touches a reader twice
        plan_map: Dict[int, Tuple[ProgressiveReader, List[int]]] = {}
        for session, var, tol in requests:
            vr = session.reader(var)
            ent = uniq.get(id(vr))
            first = ent is None
            if first:
                ent = {"session": session, "vr": vr,
                       "before": vr.total_bytes_fetched,
                       "deg_before": vr.degraded_count}
                uniq[id(vr)] = ent
            req_entries.append((ent, first))
            for r in vr.chunk_readers:
                target = r.plan(tol)
                prev = plan_map.get(id(r))
                if prev is not None:
                    target = [max(a, b) for a, b in zip(prev[1], target)]
                plan_map[id(r)] = (r, target)
        # service-level depth override wins; else the deepest involved
        # reader's (plan-replayed) look-ahead drives the batch fetch
        depth = (max((ent["vr"].depth for ent in uniq.values()),
                     default=tn.DEFAULT_CONFIG.depth)
                 if self.depth is None else max(int(self.depth), 1))
        t0 = time.perf_counter()
        with obs_trace.span("serve.retrieve_many", requests=len(requests),
                            readers=len(uniq)):
            _warm_and_fetch(list(plan_map.values()), depth=depth)
            # one cross-session batched delta decode over every distinct
            # reader's staged plane groups (per mesh device when sharded)
            with obs_trace.span("serve.decode", readers=len(uniq)):
                shd.ShardedReconstructEngine.drain(
                    [cr.engine for ent in uniq.values()
                     for cr in ent["vr"].chunk_readers if cr.incremental])
            results = []
            for ent, first in req_entries:
                vr = ent["vr"]
                x, bound = vr.reconstruct()  # drained: delta recompose only
                fetched = (vr.total_bytes_fetched - ent["before"]) \
                    if first else 0
                ent["session"].stats.add(requests=1, bytes_fetched=fetched)
                if first:
                    ent["session"]._record_degraded([vr], ent["deg_before"])
                results.append((x, bound, fetched))
        m = obs_metrics.REGISTRY.get()
        m.inc("serve.requests", len(requests))
        m.inc("serve.bytes_fetched",
              sum(ent["vr"].total_bytes_fetched - ent["before"]
                  for ent in uniq.values()))
        m.observe("serve.retrieve_s", time.perf_counter() - t0)
        return results

    # -- accounting ----------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        backend_stats = self.store.stats()
        with self._lock:
            per_session = {s.sid: s.stats.snapshot()
                           for s in self._sessions.values()}
        return {
            "store_bytes": self.store.stored_bytes,
            "backend": backend_stats.snapshot() if backend_stats else None,
            "serving": self.tier.snapshot() if self.tier else None,
            "sessions": per_session,
        }
