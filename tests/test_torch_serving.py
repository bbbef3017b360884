"""The port's serving tier (shared plane cache, request coalescing,
cross-session batched decode) vs the JAX reference's, on the CPU.

Inputs are made with numpy from a seed; the port runs with ``device="cpu"``.
Tolerance: none.  The port's versions of tests/test_serving.py's contracts,
each also held against ``repro``'s tier on the same store where the quantity
is deterministic (sequential schedules: the whole tier snapshot; concurrent
ones: the values, bounds, bytes and the count of distinct decodes):

  * N concurrent sessions issue ONE backend read and ONE shared decode per
    distinct plane group, and get the oracle's values bit for bit;
  * one kernel call per (shape, offset) bucket of a round, whatever the
    number of sessions whose jobs it holds, and one upload per round;
  * an owner's error reaches every waiter and is never cached;
  * ``fail``/``abandon``, LRU eviction, popularity admission, oversized
    rejection, fair round-robin batching, the bounded prefetch queue, and
    torn-read-free stats snapshots;
  * QoI sessions and sessions under the chaos backend share the tier.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import store as jst  # noqa: E402
from repro.core import qoi as jqq  # noqa: E402
from repro_torch import store as tst  # noqa: E402
from repro_torch.core import qoi as qq  # noqa: E402
from repro_torch.data.fields import gaussian_field  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.store import backend as bk  # noqa: E402
from repro_torch.store import reliability as rl  # noqa: E402
from repro_torch.store import serving as sv  # noqa: E402
from repro_torch.store.service import SessionStats  # noqa: E402

torch.set_num_threads(1)

TOLS = (1e-2, 1e-3, 1e-4)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def field():
    return gaussian_field((24, 24, 24), slope=-2.2, seed=7)


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory, field):
    root = str(tmp_path_factory.mktemp("tserving"))
    with tst.DatasetWriter(root, chunk_elems=4000, use_tune_cache=False,
                           device="cpu") as w:
        w.write("v", field)
    return root


@pytest.fixture(scope="module")
def oracle(store_dir):
    """The REFERENCE's uncached single-session results per tolerance (fresh
    session each: ``fetched`` is the from-scratch plan cost)."""
    svc = jst.RetrievalService(jst.DatasetStore.open(store_dir),
                               serving=False)
    return {tol: svc.open_session().retrieve("v", tol) for tol in TOLS}


def _open(root, **kw):
    return tst.DatasetStore.open(root, device="cpu", **kw)


def _bits(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def _run_threads(n, fn, timeout=300):
    ts = [threading.Thread(target=fn, args=(k,)) for k in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)


def _concurrent(svc, n, tol):
    sessions = [svc.open_session() for _ in range(n)]
    outs = [None] * n
    barrier = threading.Barrier(n)

    def run(k):
        barrier.wait()
        outs[k] = sessions[k].retrieve("v", tol)

    _run_threads(n, run)
    assert all(o is not None for o in outs), "a session hung"
    return outs


# -------------------------------------------------- coalescing correctness --

def test_concurrent_sessions_one_read_one_decode(store_dir, oracle):
    """N sessions through a barrier: one backend read and one shared decode
    per distinct plane group, as many distinct decodes as the reference's
    tier, every reconstruction the reference oracle's bit for bit."""
    n, tol = 6, 1e-3
    backend = tst.CachingBackend(tst.LocalFileBackend(store_dir))
    svc = tst.RetrievalService(_open(store_dir, backend=backend))
    outs = _concurrent(svc, n, tol)
    ox, ob, of = oracle[tol]
    for k, (xk, bound, fetched) in enumerate(outs):
        assert _bits(xk) == _bits(ox), f"session {k}"
        assert (bound, fetched) == (ob, of)
    snap = svc.stats()
    tier, be = snap["serving"], snap["backend"]
    assert tier["requests"] == n * tier["decoded"]
    assert tier["plane_hits"] + tier["coalesced"] + tier["decoded"] \
        == tier["requests"]
    assert tier["coalesced"] + tier["plane_hits"] > 0
    assert be["fetches"] == tier["decoded"] + 1
    assert tier["errors_propagated"] == 0
    jsvc = jst.RetrievalService(jst.DatasetStore.open(store_dir))
    _concurrent(jsvc, n, tol)
    assert tier["decoded"] == jsvc.stats()["serving"]["decoded"]


def test_round_shares_kernel_calls_and_one_upload(store_dir, oracle,
                                                  monkeypatch):
    """Jobs of different sessions and chunks share kernel calls: one call per
    bucket (``decode_batches``), fewer than the jobs decoded, and one stacked
    upload per round (CPU: one staging buffer)."""
    calls = {"decode": 0, "upload": 0}
    real_decode = kops._ref.decode  # what a kernel launch is on the CPU

    def decode(*a, **kw):
        calls["decode"] += 1
        return real_decode(*a, **kw)
    monkeypatch.setattr(kops._ref, "decode", decode)
    real_upload = sv.ServingTier._upload

    def upload(buckets, device):
        calls["upload"] += 1
        return real_upload(buckets, device)
    monkeypatch.setattr(sv.ServingTier, "_upload", staticmethod(upload))
    svc = tst.RetrievalService(_open(store_dir), coalesce_window_s=0.05)
    outs = _concurrent(svc, 4, 1e-4)
    for xk, bound, fetched in outs:
        assert _bits(xk) == _bits(oracle[1e-4][0])
    tier = svc.stats()["serving"]
    assert calls["decode"] == tier["decode_batches"] < tier["decoded"]
    assert calls["upload"] == tier["decode_rounds"]


def test_tolerance_tightening_across_sessions_matches_reference(store_dir,
                                                                oracle):
    """Interleaved tightening schedules: every state the oracle's, and the
    whole tier snapshot (hits, decodes, rounds, batches, admissions) the
    reference tier's on the same schedule."""
    svcs = (tst.RetrievalService(_open(store_dir)),
            jst.RetrievalService(jst.DatasetStore.open(store_dir)))
    for svc in svcs:
        a, b = svc.open_session(), svc.open_session()
        for s, tol in [(a, 1e-2), (b, 1e-3), (a, 1e-4), (b, 1e-4),
                       (a, 1e-4)]:
            x, bound, _ = s.retrieve("v", tol)
            assert _bits(x) == _bits(oracle[tol][0])
            assert bound == oracle[tol][1]
    tier = svcs[0].stats()["serving"]
    assert tier["plane_hits"] > 0 and tier["decoded"] < tier["requests"]
    assert tier == svcs[1].stats()["serving"]


def test_cache_disabled_keeps_coalescing(store_dir, oracle):
    snaps = []
    for pkg, store in ((tst, _open(store_dir)),
                       (jst, jst.DatasetStore.open(store_dir))):
        svc = pkg.RetrievalService(store, plane_cache_bytes=0)
        for _ in range(2):
            x, _, _ = svc.open_session().retrieve("v", 1e-3)
            assert _bits(x) == _bits(oracle[1e-3][0])
        snaps.append(svc.stats()["serving"])
    tier = snaps[0]
    assert tier["plane_hits"] == 0 and tier["admitted"] == 0
    assert tier["decoded"] == tier["requests"]
    assert tier == snaps[1]


def test_qoi_concurrent_sessions_share_tier(store_dir):
    """Two QoI sessions at once through one tier: both converge with the
    values of the reference's single QoI session."""
    svc = tst.RetrievalService(_open(store_dir))
    res = [None, None]

    def run(k):
        res[k] = svc.open_session().retrieve_qoi(["v"], qq.V_TOTAL, 1e-2)

    _run_threads(2, run)
    ref = jst.RetrievalService(jst.DatasetStore.open(store_dir)) \
        .open_session().retrieve_qoi(["v"], jqq.V_TOTAL, 1e-2)
    for r in res:
        assert r is not None and r.converged
        assert (r.iterations, r.bytes_fetched, r.tau_estimated) == \
            (ref.iterations, ref.bytes_fetched, ref.tau_estimated)
        assert _bits(r.values[0]) == _bits(ref.values[0])
    assert svc.stats()["serving"]["decoded"] \
        < svc.stats()["serving"]["requests"]


# ------------------------------------------------------- error propagation --

class _RangeFaultBackend(bk.FetchBackend):
    """Fails reads of registered byte ranges until ``heal()``, with the
    typed error of the package whose stack reads through it."""

    def __init__(self, inner, error=rl.TransientFetchError):
        self.inner = inner
        self.error = error
        self.failing: set = set()

    def fail_range(self, offset: int, size: int) -> None:
        self.failing.add((offset, size))

    def heal(self) -> None:
        self.failing.clear()

    def read(self, key, offset, size):
        if (offset, size) in self.failing:
            raise self.error(f"injected: {key}@{offset}+{size}")
        return self.inner.read(key, offset, size)

    def size(self, key):
        return self.inner.size(key)

    def close(self):
        self.inner.close()


def test_error_propagates_to_all_waiters_never_cached(store_dir, oracle):
    faulty = _RangeFaultBackend(tst.LocalFileBackend(store_dir))
    store = _open(store_dir, backend=tst.CachingBackend(faulty))
    ref = store.variable("v").chunks[0].pieces[1].groups[0]
    faulty.fail_range(ref.offset, ref.size)
    svc = tst.RetrievalService(store, degrade=True)
    outs = _concurrent(svc, 4, 1e-3)
    ox, ob, _ = oracle[1e-3]
    # the reference degrades the same piece the same way
    jfaulty = _RangeFaultBackend(jst.LocalFileBackend(store_dir),
                                 jst.TransientFetchError)
    jfaulty.fail_range(ref.offset, ref.size)
    jx, jb, jf = jst.RetrievalService(
        jst.DatasetStore.open(store_dir,
                              backend=jst.CachingBackend(jfaulty)),
        degrade=True).open_session().retrieve("v", 1e-3)
    for xk, bound, fetched in outs:
        assert bound > ob and not np.array_equal(xk, ox)
        assert _bits(xk) == _bits(jx) and (bound, fetched) == (jb, jf)
    stats = svc.stats()
    for sid, st in stats["sessions"].items():
        assert st["degraded_groups"] >= 1, (sid, st)
    assert stats["serving"]["plane_cache"]["entries"] \
        == stats["serving"]["admitted"]
    assert svc.tier.inflight_count == 0
    faulty.heal()
    s = svc.open_session()
    x, bound, _ = s.retrieve("v", 1e-3)
    assert _bits(x) == _bits(ox) and bound == ob
    assert svc.stats()["sessions"][s.sid]["degraded_groups"] == 0


def test_tier_fail_unit_semantics():
    tier = tst.ServingTier(window_s=0.0)
    key = ("v", 0, 1, 2)
    (kind, fut), = tier.claim(1, [key]).values()
    assert kind == "mine"
    (kind2, fut2), = tier.claim(2, [key]).values()
    assert kind2 == "theirs" and fut2 is fut
    got = {}

    def waiter():
        try:
            tier.wait_for(fut2)
        except Exception as exc:  # noqa: BLE001
            got["exc"] = exc

    t = threading.Thread(target=waiter)
    t.start()
    boom = rl.TransientFetchError("boom")
    tier.fail(key, boom)
    t.join(timeout=30)
    assert got["exc"] is boom
    (kind3, _), = tier.claim(3, [key]).values()
    assert kind3 == "mine"
    assert tier.stats.snapshot()["errors_propagated"] == 1


def _job(tier, tenant, key, rows=(2, 4), n=128):
    (_, fut), = tier.claim(tenant, [key]).values()
    return sv.DecodeJob(key=key, kind="group",
                        rows=np.zeros(rows, np.uint32), row_offset=0, n=n,
                        mag_bits=30, design="register_block", backend="auto",
                        device=CPU, future=fut)


def test_abandon_withdraws_queued_jobs():
    tier = tst.ServingTier(window_s=0.0)
    key = ("v", 0, 0, 0)
    job = _job(tier, 7, key)
    tier.submit(7, [job])
    tier.abandon(7, [key], RuntimeError("unwinding"))
    assert job.future.done and isinstance(job.future.error, RuntimeError)
    with tier._lock:
        assert not tier._queued()
    assert tier.inflight_count == 0


def test_decode_round_publishes_kernel_values():
    """A submitted job decodes (on a waiter's pump) to the plain decode of
    its rows, is admitted to the cache and resolves its future."""
    tier = tst.ServingTier(window_s=0.0)
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 2 ** 32, (3, 128), dtype=np.uint64) \
        .astype(np.uint32)
    key = ("v", 0, 0, 1)
    (_, fut), = tier.claim(1, [key]).values()
    tier.submit(1, [sv.DecodeJob(key=key, kind="group", rows=rows,
                                 row_offset=4, n=4000, mag_bits=23,
                                 design="register_block", backend="auto",
                                 device=CPU, future=fut)])
    got = tier.wait_for(fut)
    want = kops.decode_bitplanes_offset(rows, 23, 4000, 4, device="cpu")
    assert torch.equal(got.array, want)
    assert (got.kind, got.n_rows, got.row_bytes) == ("group", 3, 4 * 3 * 128)
    assert tier.snapshot()["plane_cache"]["entries"] == 1


def test_cached_planes_own_their_storage():
    """The jobs of one round share one kernel call, yet every published
    entry holds only its own bytes: evicting an entry frees its memory even
    while the round's other entries stay cached."""
    tier = tst.ServingTier(cache_bytes=2 * 4 * 4000, window_s=0.0)
    rng = np.random.default_rng(1)
    keys = [("v", 0, 0, g) for g in range(4)]
    jobs = []
    for key in keys:
        (_, fut), = tier.claim(1, [key]).values()
        rows = rng.integers(0, 2 ** 32, (2, 128), dtype=np.uint64) \
            .astype(np.uint32)
        jobs.append(sv.DecodeJob(key=key, kind="group", rows=rows,
                                 row_offset=0, n=4000, mag_bits=30,
                                 design="register_block", backend="auto",
                                 device=CPU, future=fut))
    tier.submit(1, jobs)
    got = [tier.wait_for(j.future) for j in jobs]
    snap = tier.snapshot()
    assert snap["decode_batches"] == 1 and snap["evictions"] == 2
    assert snap["plane_cache"] == {"entries": 2, "bytes": 2 * 4 * 4000,
                                   "capacity_bytes": 2 * 4 * 4000}
    for j, planes in zip(jobs, got):
        want = kops.decode_bitplanes_offset(j.rows, 30, 4000, 0,
                                            device="cpu")
        assert torch.equal(planes.array, want)
        assert planes.array.untyped_storage().nbytes() == planes.nbytes
    ptrs = {p.array.untyped_storage().data_ptr() for p in got}
    assert len(ptrs) == len(got)


def test_tier_claims_under_thread_stress():
    """16 threads claim overlapping keys, own-and-submit or wait, with a
    shortened switch interval: every claim resolves exactly one way, every
    key decodes exactly once, and every waiter gets the owner's value."""
    import sys
    tier = tst.ServingTier(window_s=0.0)
    keys = [("v", 0, 0, i) for i in range(40)]
    rng = np.random.default_rng(5)
    rows = {k: rng.integers(0, 2 ** 32, (1, 128), dtype=np.uint64)
            .astype(np.uint32) for k in keys}
    got, errors = [], []
    barrier = threading.Barrier(16)

    def run(t):
        try:
            barrier.wait(timeout=60)
            order = np.random.default_rng(t).permutation(len(keys))
            for i in order:
                key = keys[i]
                (kind, v), = tier.claim(t, [key]).values()
                if kind == "mine":
                    tier.submit(t, [sv.DecodeJob(
                        key=key, kind="group", rows=rows[key], row_offset=0,
                        n=4096, mag_bits=23, design="register_block",
                        backend="auto", device=CPU, future=v)])
                    v = tier.wait_for(v)
                elif kind == "theirs":
                    v = tier.wait_for(v)
                got.append((key, v.array))
        except Exception as exc:  # noqa: BLE001
            errors.append(repr(exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run_threads(16, run, timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:3]
    assert len(got) == 16 * len(keys)
    snap = tier.snapshot()
    assert snap["decoded"] == len(keys) and snap["requests"] == len(got)
    assert snap["plane_hits"] + snap["coalesced"] + snap["decoded"] \
        == snap["requests"]
    assert snap["inflight"] == 0
    for key, arr in got:
        want = kops.decode_bitplanes(rows[key], 23, 4096, device="cpu")
        assert torch.equal(arr, want)


# ------------------------------------------------------------- plane cache --

def _planes(n_words: int) -> sv.DecodedPlanes:
    return sv.DecodedPlanes(array=torch.zeros((n_words,), dtype=torch.int32),
                            kind="group", n_rows=1, row_bytes=4 * n_words)


def test_plane_cache_lru_eviction_and_bytes():
    c = tst.PlaneCache(capacity_bytes=100)
    for k in ("a", "b"):
        c.touch((k, 0, 0, 0))
        assert c.offer((k, 0, 0, 0), _planes(10))[0]
    assert c.cached_bytes == 80 and len(c) == 2
    c.touch(("c", 0, 0, 0))
    admitted, evictions, rejects = c.offer(("c", 0, 0, 0), _planes(10))
    assert admitted and evictions == 1 and rejects == 0
    assert c.get(("a", 0, 0, 0)) is None
    assert c.get(("b", 0, 0, 0)) is not None


def test_plane_cache_popularity_guards_hot_set():
    c = tst.PlaneCache(capacity_bytes=80)
    hot = ("hot", 0, 0, 0)
    for _ in range(10):
        c.touch(hot)
    assert c.offer(hot, _planes(10))[0]
    warm = ("warm", 0, 0, 0)
    c.touch(warm)
    assert c.offer(warm, _planes(10))[0]
    c.get(warm)
    cold = ("cold", 0, 0, 0)
    c.touch(cold)
    admitted, evictions, rejects = c.offer(cold, _planes(10))
    assert not admitted and rejects == 1 and evictions in (0, 1)
    assert c.get(hot) is not None
    assert c.get(cold) is None


def test_plane_cache_oversized_candidate_rejected():
    c = tst.PlaneCache(capacity_bytes=30)
    big = ("big", 0, 0, 0)
    c.touch(big)
    admitted, _, rejects = c.offer(big, _planes(100))
    assert not admitted and rejects == 1
    assert len(c) == 0 and c.cached_bytes == 0


def test_plane_cache_decisions_match_reference():
    """The same touch/offer/get sequence gives the same admissions,
    evictions, rejections and contents in both packages' caches."""
    from repro.store import serving as jsv
    rng = np.random.default_rng(3)
    caches = (tst.PlaneCache(capacity_bytes=400),
              jsv.PlaneCache(capacity_bytes=400))
    outs = ([], [])
    for _ in range(400):
        key = (f"k{int(rng.zipf(1.5)) % 40}", 0, 0, 0)
        words = int(rng.integers(5, 60))
        op = rng.integers(3)
        for c, out, planes in zip(
                caches, outs,
                (_planes(words),
                 jsv.DecodedPlanes(np.zeros((words,), np.uint32), "group",
                                   1, 4 * words))):
            c.touch(key)
            if op == 0:
                out.append(c.get(key) is not None)
            else:
                out.append(c.offer(key, planes))
            out.append((len(c), c.cached_bytes))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------- fairness --

def test_fair_batch_round_robins_tenants():
    tier = tst.ServingTier(window_s=0.0, max_batch_jobs=4)
    tier.submit(1, [_job(tier, 1, ("t1", 0, 0, i), (1, 4), 64)
                    for i in range(10)])
    tier.submit(2, [_job(tier, 2, ("t2", 0, 0, i), (1, 4), 64)
                    for i in range(2)])
    with tier._lock:
        batch = tier._take_fair_batch()
    assert [j.key[0] for j in batch] == ["t1", "t2", "t1", "t2"]
    with tier._lock:
        rest = tier._take_fair_batch()
    assert [j.key[0] for j in rest] == ["t1"] * 4


# -------------------------------------------------- bounded prefetch queue --

def test_prefetch_queue_bounded_drops_oldest():
    gate = threading.Event()

    class _Slow(bk.FetchBackend):
        def read(self, key, offset, size):
            gate.wait(timeout=30)
            return b"\0" * size

        def size(self, key):
            return 1 << 20

    be = tst.CachingBackend(_Slow(), workers=1, prefetch_queue_max=4)
    try:
        for i in range(20):
            be.prefetch("k", i * 10, 10)
        snap = be.stats.snapshot()
        assert snap["prefetch_issued"] == 20
        assert snap["prefetch_dropped"] >= 14
        with be._lock:
            assert len(be._queue) <= 4
    finally:
        gate.set()
        be.close()


# ----------------------------------------------------- stats snapshot race --

@pytest.mark.parametrize("which", ["session", "backend"])
def test_stats_snapshot_hammer(which):
    """Snapshots taken mid-update are internally consistent: every add() is
    atomic."""
    if which == "session":
        st = SessionStats()

        def add():
            st.add(requests=1, bytes_fetched=7, qoi_iterations=2)

        def ok(s):
            return (s["bytes_fetched"] == 7 * s["requests"]
                    and s["qoi_iterations"] == 2 * s["requests"])
    else:
        st = bk.BackendStats()

        def add():
            st.add(reads=1, bytes_served=13, cache_hits=1)

        def ok(s):
            return (s["bytes_served"] == 13 * s["reads"]
                    and s["cache_hits"] == s["reads"])
    stop = threading.Event()
    bad = []

    def writer():
        while not stop.is_set():
            add()

    def reader():
        while not stop.is_set():
            s = st.snapshot()
            if not ok(s):
                bad.append(s)

    ts = [threading.Thread(target=writer) for _ in range(4)] \
        + [threading.Thread(target=reader) for _ in range(2)]
    for t in ts:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in ts:
        t.join(timeout=30)
    assert not bad, bad[:3]
    assert ok(st.snapshot())


# ----------------------------------------------------- lifecycle under chaos --

def test_session_lifecycle_concurrent_chaos(store_dir, oracle, monkeypatch):
    """Create/retrieve/close across 8 threads with the chaos backend wired in
    (REPRO_CHAOS): every result the oracle's through retries, no leaked
    sessions, no wedged claims, no degradation."""
    monkeypatch.setenv(rl.CHAOS_ENV, "transient=0.05,seed=97")
    svc = tst.RetrievalService(_open(store_dir))
    n = 8
    errors = []
    barrier = threading.Barrier(n)

    def run(k):
        barrier.wait()
        try:
            for tol in (1e-2, 1e-3):
                s = svc.open_session()
                try:
                    x, bound, _ = s.retrieve("v", tol)
                    ox, ob, _ = oracle[tol]
                    if _bits(x) != _bits(ox) or bound != ob:
                        errors.append((k, tol))
                    if s.stats.snapshot()["degraded_groups"] != 0:
                        errors.append((k, tol, "degraded"))
                finally:
                    svc.close_session(s)
        except Exception as exc:  # noqa: BLE001
            errors.append((k, repr(exc)))

    _run_threads(n, run, timeout=600)
    assert not errors, errors[:5]
    assert svc.sessions == []
    assert svc.tier.inflight_count == 0
