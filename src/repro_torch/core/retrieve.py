"""Error-controlled progressive retrieval (paper Fig 1, read path).

A port of ``repro.core.retrieve``.  ``ProgressiveReader`` keeps the
fetched-segment state across requests, so successive retrievals are
*incremental*: only the delta plane groups are fetched (and counted toward
bytes_fetched).  With ``incremental=True`` (default) the decode side is
incremental too: fetched groups stream into a device-resident
``core.reconstruct`` engine that delta-decodes them at their bit offsets
and re-runs only the recompose suffix below the coarsest changed piece;
``incremental=False`` is the from-scratch full-decode path, kept as the
bit-exactness oracle.

Rate allocation is greedy by error-reduction-per-byte over (piece, group)
candidates against the conservative max-norm bound
(``decompose.error_bound``).

The reader runs on ``device`` (``None`` means ``cuda``; see
``repro_torch.device``).  ``shared=`` routes plane-group fetches through a
store's serving tier (``store.serving.ServingTier``): a shared cross-session
plane cache, request coalescing and cross-session batched decode.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import align as al
from repro_torch.core import decompose as dc
from repro_torch.core import lossless as ll
from repro_torch.core import lossless_batch as lb
from repro_torch.core import reconstruct as rc
from repro_torch.core.refactor import Refactored
from repro_torch.device import DeviceLike, as_u32_bits, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


@dataclasses.dataclass
class _PieceState:
    groups_fetched: int = 0
    planes: Optional[np.ndarray] = None     # oracle mode: (P, W) host prefix
    sign: Optional[np.ndarray] = None       # oracle mode: sign plane (1, W)
    bytes_fetched: int = 0
    # degradation cap: max reachable group count for this piece this session
    # (None = all groups reachable).  Set when a fetch fails under degrade=
    # policy; planning never asks for groups at or beyond the cap, so the
    # reported bound stays honest about what was actually applied.
    cap: Optional[int] = None


class SegmentSource:
    """Where a reader gets segment payloads from.

    The default ``InlineSegmentSource`` serves the in-memory segments held by
    the ``Refactored`` itself; a store-backed source resolves (piece, group)
    to a byte range and fetches exactly that range.  ``sign`` and ``group``
    must return segments with payloads; ``prefetch`` is an optional hint
    listing (piece, group) pairs about to be fetched (group == -1 means the
    piece's sign segment)."""

    def sign(self, piece: int) -> ll.Segment:
        raise NotImplementedError

    def group(self, piece: int, group: int) -> ll.Segment:
        raise NotImplementedError

    def prefetch(self, wants: List[Tuple[int, int]]) -> None:
        pass


class InlineSegmentSource(SegmentSource):
    def __init__(self, ref: Refactored):
        self._ref = ref

    def sign(self, piece: int) -> ll.Segment:
        return self._ref.pieces[piece].sign_seg

    def group(self, piece: int, group: int) -> ll.Segment:
        return self._ref.pieces[piece].groups[group]


class ProgressiveReader:
    """Stateful reader over a ``Refactored`` variable.

    ``ref`` may hold real segments (then the default inline source serves
    them) or payload-free stubs (then ``source`` must resolve the payloads).
    Planning only ever touches segment *sizes*, so it works identically in
    both modes.

    ``incremental=True`` (default) routes decoding through a device-resident
    ``reconstruct.IncrementalReconstructor``; ``incremental=False`` keeps
    host plane prefixes and re-decodes everything per call — the
    bit-exactness oracle."""

    def __init__(self, ref: Refactored, backend: Optional[str] = None,
                 source: Optional[SegmentSource] = None,
                 incremental: bool = True,
                 device: DeviceLike = None,
                 config=None,
                 degrade: bool = False,
                 shared: Optional[object] = None,
                 shared_scope: Tuple[str, int] = ("", 0),
                 shared_tenant: int = 0):
        from repro_torch import tune as tn  # local: keep import graph flat
        # config= replays a store's tuned plan (here: its backend)
        cfg = tn.as_config(config, backend=backend)
        self.ref = ref
        self.backend = cfg.backend
        self.config = cfg
        self.source = source if source is not None else InlineSegmentSource(ref)
        self.state = [_PieceState() for _ in ref.pieces]
        self.total_bytes_fetched = 0
        self.incremental = incremental
        # degrade=True: a plane group whose fetch fails with a typed store
        # error is dropped for the session (the piece is capped below it) and
        # the reconstruction is served WITHOUT it, with the honestly widened
        # bound.  degrade=False (the default) re-raises.
        self.degrade = degrade
        self.degraded: List[Tuple[int, int, str]] = []  # (piece, group, errtype)
        self.device = resolve_device(device)
        self.engine = (rc.IncrementalReconstructor(ref, backend=self.backend,
                                                   device=self.device)
                       if incremental else None)
        # serving-tier mode (store.serving.ServingTier): plane-group fetches
        # route through a shared cross-session cache + coalescing claim
        # table, and decode jobs merge with other sessions' work.
        # Incremental-only — the oracle path stays private by construction.
        self.shared = shared if incremental else None
        self.shared_scope = tuple(shared_scope)
        self.shared_tenant = shared_tenant
        if self.engine is not None:
            self.engine.shared = self.shared

    # ----------------------------------------------------------- planning --
    def planes_kept(self) -> List[int]:
        return [sum(p.group_planes[:s.groups_fetched])
                for p, s in zip(self.ref.pieces, self.state)]

    def current_bound(self) -> float:
        return self.ref.bound(self.planes_kept())

    def floor_bound(self) -> float:
        return self.ref.bound([p.mag_bits for p in self.ref.pieces])

    # -------------------------------------------------------- degradation --
    def _limit(self, i: int) -> int:
        """Max reachable group count for piece ``i`` (cap-aware)."""
        n = len(self.ref.pieces[i].groups)
        cap = self.state[i].cap
        return n if cap is None else min(n, cap)

    @property
    def degraded_count(self) -> int:
        """Plane groups dropped by the degrade policy this session."""
        return len(self.degraded)

    def reset_degraded(self) -> None:
        """Forget degradation caps: the next fetch retries dropped groups."""
        self.degraded.clear()
        for st in self.state:
            st.cap = None

    def plan(self, tol: float) -> List[int]:
        """Greedy (piece, group) allocation: target planes-kept per piece."""
        r = self.ref
        kept = self.planes_kept()
        groups = [s.groups_fetched for s in self.state]
        bound = r.bound(kept)
        while bound > tol:
            best, best_score = None, 0.0
            for i, pm in enumerate(r.pieces):
                gi = groups[i]
                if gi >= self._limit(i):
                    continue
                new_kept = kept[i] + pm.group_planes[gi]
                d_eps = pm.weight * (r.piece_eps(i, kept[i]) - r.piece_eps(i, new_kept))
                cost = pm.groups[gi].stored_bytes
                if gi == 0:
                    cost += pm.sign_seg.stored_bytes
                score = d_eps / max(cost, 1)
                if score > best_score:
                    best, best_score = i, score
            if best is None:
                break  # everything fetched; bound is at the floor
            bound -= r.pieces[best].weight * (
                r.piece_eps(best, kept[best])
                - r.piece_eps(best, kept[best] + r.pieces[best].group_planes[groups[best]]))
            kept[best] += r.pieces[best].group_planes[groups[best]]
            groups[best] += 1
        return groups

    # ------------------------------------------------------------ fetching --
    def pending_deltas(self, target_groups: List[int]) -> List[Tuple[int, int]]:
        """(piece, group) pairs `_fetch_to(target_groups)` would fetch; the
        sign segment of a cold piece is listed as (piece, -1)."""
        wants: List[Tuple[int, int]] = []
        for i, st in enumerate(self.state):
            tg = min(target_groups[i], self._limit(i))
            if tg <= st.groups_fetched:
                continue
            if st.groups_fetched == 0:
                wants.append((i, -1))
            wants.extend((i, g) for g in range(st.groups_fetched, tg))
        return wants

    def _fetch_to(self, target_groups: List[int],
                  degrade: Optional[bool] = None) -> int:
        """Fetch segment deltas through the source; returns bytes fetched now.

        All newly-fetched segments of the request are decoded through ONE
        batched pass (``lossless_batch.decode_segments``, one host sync).  In
        incremental mode the resulting plane rows are staged on the
        reconstruction engine (device upload only — bitplane decode is
        deferred and batched); the oracle mode accumulates host plane
        prefixes instead.

        Failure policy: each segment fetch is independently guarded.  Under
        ``degrade`` (per-call override, else the reader's policy) a typed
        store failure CAPS the piece at the failed group; a sign-segment
        failure caps the piece at 0.  Without degrade the error propagates
        and no state is mutated for the failed request."""
        from repro_torch.store import reliability as rl  # store imports us
        if self.shared is not None:
            return self._fetch_to_shared(target_groups, degrade)
        deltas = self.pending_deltas(target_groups)
        self.source.prefetch(deltas)
        if degrade is None:
            degrade = self.degrade
        wants: List[Tuple[int, int, ll.Segment]] = []
        dead: set = set()  # pieces capped during THIS fetch
        for i, g in deltas:
            if i in dead:
                continue  # later groups of a capped piece are unusable
            try:
                seg = self.source.sign(i) if g < 0 else self.source.group(i, g)
            except (rl.StoreIOError, ValueError, OSError) as exc:
                if not degrade:
                    raise
                cap = 0 if g < 0 else g
                st = self.state[i]
                st.cap = cap if st.cap is None else min(st.cap, cap)
                self.degraded.append((i, g, type(exc).__name__))
                dead.add(i)
                continue
            wants.append((i, g, seg))
        blobs = lb.decode_segments([w[2] for w in wants], device=self.device)

        fetched = 0
        decoded: dict = {(i, g): (s, b) for (i, g, s), b in zip(wants, blobs)}
        for i, (pm, st) in enumerate(zip(self.ref.pieces, self.state)):
            tg = min(target_groups[i], self._limit(i))
            if tg <= st.groups_fetched:
                continue
            got = 0
            if st.groups_fetched == 0:
                w = pm.groups[0].meta["n_words"]
                sign = decoded[(i, -1)][1].view(np.uint32).reshape(1, w)
                if self.incremental:
                    self.engine.stage_sign(i, sign)
                else:
                    st.sign = sign
                got += pm.sign_seg.stored_bytes
            new_rows = []
            for g in range(st.groups_fetched, tg):
                seg, blob = decoded[(i, g)]
                w = seg.meta["n_words"]
                if w:
                    rows = blob.view(np.uint32).reshape(-1, w)
                else:  # empty piece: keep the (planes, 0) row structure
                    rows = np.zeros((pm.group_planes[g], 0), np.uint32)
                new_rows.append(rows)
                got += pm.groups[g].stored_bytes
            row_offset = sum(pm.group_planes[:st.groups_fetched])
            if self.incremental:
                self.engine.stage_rows(i, np.concatenate(new_rows, axis=0),
                                       row_offset)
            else:
                stack = [st.planes] if st.planes is not None else []
                st.planes = np.concatenate(stack + new_rows, axis=0)
            st.groups_fetched = tg
            st.bytes_fetched += got
            fetched += got
        self.total_bytes_fetched += fetched
        return fetched

    def _shared_job(self, i: int, g: int, seg: ll.Segment, key, fut,
                    blob: np.ndarray):
        """Package one owned plane group as a self-contained shared decode
        job (canonical row offset ``sum(group_planes[:g])``, so the decoded
        delta is session-independent and cacheable)."""
        from repro_torch.store import serving as sv  # store imports us
        pm = self.ref.pieces[i]
        if g < 0:
            w = pm.groups[0].meta["n_words"]
            rows = blob.view(np.uint32).reshape(1, w)
            kind, row_offset = "sign", 0
        else:
            w = seg.meta["n_words"]
            rows = (blob.view(np.uint32).reshape(-1, w) if w
                    else np.zeros((pm.group_planes[g], 0), np.uint32))
            kind, row_offset = "group", sum(pm.group_planes[:g])
        return sv.DecodeJob(
            key=key, kind=kind, rows=rows, row_offset=row_offset, n=pm.n,
            mag_bits=self.ref.mag_bits, design=self.ref.design,
            backend=self.backend, device=self.device, future=fut)

    def _fetch_to_shared(self, target_groups: List[int],
                         degrade: Optional[bool]) -> int:
        """Serving-tier variant of ``_fetch_to``: every wanted plane group is
        CLAIMED against the shared tier first — a cache hit skips fetch and
        decode entirely, a coalesced claim waits on the owning session's
        in-flight decode (exactly one backend read + one decode per group
        service-wide), and an owned claim fetches the bytes and enqueues a
        shared decode job (deferred: merged with other sessions' jobs into
        one batched round at drain).

        Byte accounting, degrade-cap semantics, and the resulting
        reconstruction are identical to the private path: ``bytes_fetched``
        stays the logical stored size of every group APPLIED to this
        session (whether its decode ran here, elsewhere, or was cached), and
        a typed store failure — local or propagated from the owning session
        — caps the piece exactly as a direct fetch failure would."""
        from repro_torch.store import reliability as rl  # store imports us
        from repro_torch.store import serving as sv
        tier = self.shared
        if degrade is None:
            degrade = self.degrade
        deltas = self.pending_deltas(target_groups)
        if not deltas:
            return 0
        r = self.ref
        # empty pieces decode to nothing (private staging drops them too):
        # keep them out of the tier, account their logical bytes below
        claimable = [(i, g) for i, g in deltas if r.pieces[i].n > 0]
        keys = {d: self.shared_scope + d for d in claimable}
        claims = tier.claim(self.shared_tenant,
                            [keys[d] for d in claimable])
        mine = [d for d in claimable if claims[keys[d]][0] == "mine"]
        # byte-range prefetch only what THIS session will read: coalesced
        # groups are fetched (once) by their owning session
        self.source.prefetch(mine)

        results: dict = {}
        dead: dict = {}  # piece -> the exception that capped it (this call)

        def _cap(i: int, g: int, exc: BaseException) -> None:
            st = self.state[i]
            cap = 0 if g < 0 else g
            st.cap = cap if st.cap is None else min(st.cap, cap)
            self.degraded.append((i, g, type(exc).__name__))
            dead[i] = exc

        # -- phase 1: owned claims — fetch + lossless decode + submit.
        # Every owned key resolves exactly one way (submit / fail /
        # abandon), so a coalesced waiter can never hang on this session.
        wants: List[Tuple[int, int, ll.Segment, object]] = []
        try:
            for (i, g) in claimable:
                kind, payload = claims[keys[(i, g)]]
                if kind != "mine":
                    continue
                if i in dead:
                    # an earlier group of this piece already failed: these
                    # bytes were never read and this session will never use
                    # them — propagate the piece's fault to any coalesced
                    # waiters (never cached: their next request retries)
                    tier.fail(keys[(i, g)], dead[i])
                    continue
                try:
                    seg = (self.source.sign(i) if g < 0
                           else self.source.group(i, g))
                except (rl.StoreIOError, ValueError, OSError) as exc:
                    tier.fail(keys[(i, g)], exc)
                    if not degrade:
                        raise
                    _cap(i, g, exc)
                    continue
                wants.append((i, g, seg, payload))
            blobs = lb.decode_segments([w[2] for w in wants],
                                        device=self.device)
            tier.submit(self.shared_tenant,
                        [self._shared_job(i, g, seg, keys[(i, g)], fut, blob)
                         for (i, g, seg, fut), blob in zip(wants, blobs)])
        except BaseException as exc:
            tier.abandon(self.shared_tenant, [keys[d] for d in mine], exc)
            raise
        for (i, g, _, fut) in wants:
            results[(i, g)] = ("future", fut)

        # -- phase 2a: coalesced claims — resolve ALL waits before touching
        # any state (non-degrade contract: a failed request mutates
        # nothing).  wait_for pumps the shared queue, so two sessions
        # blocked on each other's claims decode each other's jobs.
        for (i, g) in claimable:
            kind, payload = claims[keys[(i, g)]]
            if kind == "hit":
                results[(i, g)] = ("value", payload)
            elif kind == "theirs":
                if i in dead:
                    continue
                try:
                    v = tier.wait_for(payload)
                except (rl.StoreIOError, ValueError, OSError) as exc:
                    if not degrade:
                        raise
                    _cap(i, g, exc)
                    continue
                results[(i, g)] = ("value", v)

        # -- phase 2b: stage + account exactly as the private path.  Cache
        # hits and resolved waits stage as pre-resolved futures, owned jobs
        # as live ones; the tier OR-applies all of them at drain time.
        fetched = 0
        for i, (pm, st) in enumerate(zip(r.pieces, self.state)):
            tg = min(target_groups[i], self._limit(i))
            if tg <= st.groups_fetched:
                continue
            got = 0
            if st.groups_fetched == 0:
                if pm.n > 0:
                    self.engine.stage_shared(
                        "sign", i, sv.entry_future(results[(i, -1)]))
                got += pm.sign_seg.stored_bytes
            for g in range(st.groups_fetched, tg):
                if pm.n > 0:
                    self.engine.stage_shared(
                        "group", i, sv.entry_future(results[(i, g)]))
                got += pm.groups[g].stored_bytes
            st.groups_fetched = tg
            st.bytes_fetched += got
            fetched += got
        self.total_bytes_fetched += fetched
        return fetched

    def peek_best(self) -> Tuple[float, Optional[int]]:
        """(score, piece) of the single best next merged group by
        error-reduction-per-byte, or (-1.0, None) if everything is fetched."""
        r = self.ref
        kept = self.planes_kept()
        best, best_score = None, -1.0
        for i, pm in enumerate(r.pieces):
            gi = self.state[i].groups_fetched
            if gi >= self._limit(i) or pm.n == 0:
                continue
            new_kept = kept[i] + pm.group_planes[gi]
            d_eps = pm.weight * (r.piece_eps(i, kept[i]) - r.piece_eps(i, new_kept))
            cost = pm.groups[gi].stored_bytes
            if gi == 0:
                cost += pm.sign_seg.stored_bytes
            score = d_eps / max(cost, 1)
            if score > best_score:
                best, best_score = i, score
        return best_score, best

    def fetch_one_more_group(self) -> int:
        """MA primitive: fetch the single best next merged group (greedy by
        error-reduction-per-byte) — the finest augmentation granularity."""
        _, best = self.peek_best()
        if best is None:
            return 0
        target = [s.groups_fetched for s in self.state]
        target[best] += 1
        return self._fetch_to(target)

    # -------------------------------------------------------- reconstruction --
    def _reconstruct_full_device(self) -> torch.Tensor:
        """Oracle path: re-decode every fetched piece from its host plane
        prefix and recompose from scratch (no state reuse)."""
        r = self.ref
        kw = dict(backend=self.backend, device=self.device)
        pieces_dec = []
        for pm, st in zip(r.pieces, self.state):
            p_kept = sum(pm.group_planes[:st.groups_fetched])
            if p_kept == 0 or pm.n == 0:
                pieces_dec.append(torch.zeros((pm.n,), dtype=torch.float32,
                                              device=self.device))
                continue
            mag = kops.decode_bitplanes(as_u32_bits(st.planes, self.device),
                                        r.mag_bits, pm.n, r.design, **kw)
            sign = kops.decode_bitplanes(as_u32_bits(st.sign, self.device),
                                         1, pm.n, r.design, **kw)
            x = al.align_decode(mag, sign, pm.exponent,
                                r.mag_bits, planes_kept=p_kept)
            pieces_dec.append(x)
        return dc.recompose(pieces_dec, r.shape, r.levels)

    def reconstruct_device(self) -> Tuple[torch.Tensor, float]:
        """Decode current state -> (device tensor, max-norm error bound).

        Incremental mode costs only the staged delta decode + recompose
        suffix (engine-cached when nothing changed); the result stays on
        the device — no host sync on this path."""
        if self.incremental:
            out = self.engine.reconstruct_device()
        else:
            out = self._reconstruct_full_device()
        return out, self.current_bound()

    def reconstruct(self) -> Tuple[np.ndarray, float]:
        """Decode current state -> (host array, guaranteed max-norm bound)."""
        x, bound = self.reconstruct_device()
        return x.cpu().numpy(), bound

    def delta_decoded_bytes(self) -> int:
        """Delta plane bytes this reader's engine has actually decoded
        (0 in oracle mode — there is no delta path to account)."""
        return self.engine.bytes_decoded if self.incremental else 0

    def decoded_plane_bytes(self) -> int:
        """Plane + sign bytes a from-scratch decode of the current state runs
        through the bitplane decoder — the full-decode baseline that the
        engine's delta accounting is measured against."""
        total = 0
        for pm, st in zip(self.ref.pieces, self.state):
            if pm.n == 0 or st.groups_fetched == 0:
                continue
            w = kref.padded_words(pm.n, self.ref.design)
            kept = sum(pm.group_planes[:st.groups_fetched])
            total += 4 * w * (kept + 1)  # +1: the sign plane
        return total

    def stage_retrieve(self, tol: float, relative: bool = False) -> int:
        """Plan + fetch + stage WITHOUT reconstructing; returns bytes fetched.

        In incremental mode the newly-fetched plane groups land *staged* on
        the engine (device upload only — the delta bitplane decode is
        deferred), so many readers' staged groups can be drained in one
        batched pass (``reconstruct.batch_apply_pending``) before each
        reader's ``reconstruct_device``."""
        if relative:
            tol = tol * self.ref.data_range
        return self._fetch_to(self.plan(tol))

    def retrieve_device(self, tol: float, relative: bool = False
                        ) -> Tuple[torch.Tensor, float, int]:
        """``retrieve`` with the reconstruction left on the device."""
        fetched = self.stage_retrieve(tol, relative=relative)
        x, bound = self.reconstruct_device()
        return x, bound, fetched

    def retrieve(self, tol: float, relative: bool = False) -> Tuple[np.ndarray, float, int]:
        """Progressively retrieve to |x - x_hat|_inf <= tol.

        Returns (x_hat, achieved_bound, bytes_fetched_this_call)."""
        x, bound, fetched = self.retrieve_device(tol, relative=relative)
        return x.cpu().numpy(), bound, fetched
