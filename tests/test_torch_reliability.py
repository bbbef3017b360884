"""The port's store reliability layer (taxonomy, checksums, retries, the
breaker, fault injection) and the read stack under injected faults, vs the
JAX reference, on the CPU.

Inputs are made with numpy from a seed; the port runs with ``device="cpu"``.
Tolerance: none.  The port's versions of tests/test_reliability.py and
tests/test_chaos.py, and against ``repro``: one seed injects the same fault
sequence in both packages' ``FaultInjectionBackend``; ``degrade=True``
under the same injected faults gives the same values, widened bounds,
bytes and degraded groups; seeded byte flips and truncations of a whole
store end the same way in both (a typed error of the same name, or the
fault-free result).
"""
import json
import os
import random
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import store as jst  # noqa: E402
from repro.core import qoi as jqq  # noqa: E402
from repro.store import reliability as jrl  # noqa: E402
from repro_torch import store as tst  # noqa: E402
from repro_torch.core import qoi as qq  # noqa: E402
from repro_torch.data.fields import gaussian_field  # noqa: E402
from repro_torch.store import backend as bk  # noqa: E402
from repro_torch.store import layout as lo  # noqa: E402
from repro_torch.store import reliability as rl  # noqa: E402

torch.set_num_threads(1)

TOLS = [1e-2, 1e-3, 1e-4]
PKGS = {"torch": (tst, rl), "jax": (jst, jrl)}


@pytest.fixture(scope="module")
def field():
    return gaussian_field((24, 24, 24), slope=-2.0, seed=5)


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory, field):
    root = str(tmp_path_factory.mktemp("tchaos"))
    with tst.DatasetWriter(root, chunk_elems=8000, use_tune_cache=False,
                           device="cpu") as w:
        w.write("v", field)
    return root


@pytest.fixture(scope="module")
def oracle(store_dir):
    """The reference's fault-free incremental ladder."""
    with jst.DatasetStore.open(store_dir) as store:
        s = jst.RetrievalService(store).open_session()
        return {tol: tuple(s.retrieve("v", tol)[:2]) for tol in TOLS}


def _bits(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def chaos_store(root, pkg="torch", attempts=8, **fault_kw):
    """Store whose reads run through FaultInjection + Retrying + Caching of
    package ``pkg``; the manifest is protected."""
    st, rel = PKGS[pkg]
    fault_kw.setdefault("seed", 1234)
    faults = rel.FaultConfig(protect=("manifest",), **fault_kw)
    policy = rel.RetryPolicy(attempts=attempts, base_delay_s=1e-4,
                             max_delay_s=1e-3)
    backend = st.CachingBackend(
        rel.RetryingBackend(rel.FaultInjectionBackend(
            st.LocalFileBackend(root), faults), policy,
            rng=random.Random(faults.seed)))
    kw = {"device": "cpu"} if pkg == "torch" else {}
    return st.DatasetStore.open(root, backend=backend, **kw)


# ------------------------------------------------------------------ helpers --

class FakeClock:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


class ScriptedInner:
    """Inner backend that raises scripted exceptions before succeeding."""

    def __init__(self, data=b"payload", failures=()):
        self.data = data
        self.failures = list(failures)
        self.calls = 0

    def read(self, key, offset, size):
        self.calls += 1
        if self.failures:
            raise self.failures.pop(0)
        return self.data

    def size(self, key):
        self.calls += 1
        if self.failures:
            raise self.failures.pop(0)
        return len(self.data)

    def prefetch(self, key, offset, size):
        pass

    def close(self):
        pass


def retrying(inner, **policy_kw):
    clock = FakeClock()
    policy = rl.RetryPolicy(**policy_kw) if policy_kw else rl.RetryPolicy()
    b = rl.RetryingBackend(inner, policy, clock=clock, sleep=clock.sleep,
                           rng=random.Random(0))
    return b, clock


# ----------------------------------------------------------------- taxonomy --

def test_error_taxonomy_classification():
    cases = [(rl.TransientFetchError("x"), "transient"),
             (TimeoutError(), "transient"), (ConnectionError(), "transient"),
             (OSError(5, "EIO"), "transient"),
             (rl.CorruptSegmentError("x"), "corrupt"),
             (rl.TruncatedReadError("x"), "corrupt"),
             (rl.FatalStoreError("x"), "fatal"),
             (FileNotFoundError(), "fatal"), (KeyError("k"), "fatal"),
             (RuntimeError(), "fatal")]
    for exc, kind in cases:
        assert rl.classify(exc) == kind
    # the reference classifies its own errors of the same names alike
    for exc, kind in cases:
        jexc = getattr(jrl, type(exc).__name__, type(exc))(*exc.args)
        assert jrl.classify(jexc) == kind
    assert issubclass(rl.CorruptSegmentError, ValueError)
    assert issubclass(rl.TruncatedReadError, rl.CorruptSegmentError)
    for t in (rl.TransientFetchError, rl.CorruptSegmentError,
              rl.TruncatedReadError, rl.FatalStoreError,
              rl.UnreachableSegmentError):
        assert issubclass(t, rl.StoreIOError)


def test_checksum_verify_and_manifest_body_match_reference():
    blob = b"some segment bytes"
    c = rl.checksum(blob)
    assert c == jrl.checksum(blob)
    rl.verify_checksum(blob, c)
    with pytest.raises(rl.CorruptSegmentError):
        rl.verify_checksum(blob + b"x", c)
    with pytest.raises(rl.CorruptSegmentError):
        rl.verify_checksum(blob, c ^ 1)
    body = {"v": {"shape": [3, 4], "amax": 0.25, "chunks": [[0, 10, "huff"]]}}
    c = rl.manifest_body_checksum(body)
    assert c == jrl.manifest_body_checksum(body)
    reparsed = json.loads(json.dumps({"variables": body, "crc32": c}))
    assert rl.manifest_body_checksum(reparsed["variables"]) == c


# -------------------------------------------------------------------- retry --

def test_retry_transient_then_success():
    inner = ScriptedInner(failures=[rl.TransientFetchError("flake"),
                                    TimeoutError()])
    b, clock = retrying(inner, attempts=4, base_delay_s=0.1, max_delay_s=1.0)
    assert b.read("k", 0, 7) == b"payload"
    assert inner.calls == 3
    assert b.stats.retries == 2 and b.stats.transient_errors == 2
    assert len(clock.sleeps) == 2
    assert 0.05 <= clock.sleeps[0] <= 0.1
    assert 0.1 <= clock.sleeps[1] <= 0.2
    # the reference draws the same jittered delays from the same rng
    jclock = FakeClock()
    jb = jrl.RetryingBackend(
        ScriptedInner(failures=[jrl.TransientFetchError("flake"),
                                TimeoutError()]),
        jrl.RetryPolicy(attempts=4, base_delay_s=0.1, max_delay_s=1.0),
        clock=jclock, sleep=jclock.sleep, rng=random.Random(0))
    jb.read("k", 0, 7)
    assert jclock.sleeps == clock.sleeps
    assert jb.stats.snapshot() == b.stats.snapshot()


def test_retry_never_retries_corruption_or_fatal():
    for exc in (rl.CorruptSegmentError("rot"), FileNotFoundError("gone")):
        inner = ScriptedInner(failures=[exc])
        b, clock = retrying(inner, attempts=5)
        with pytest.raises(type(exc)):
            b.read("k", 0, 7)
        assert inner.calls == 1
        assert clock.sleeps == []


def test_retry_exhaustion_raises_unreachable_with_cause():
    inner = ScriptedInner(failures=[rl.TransientFetchError(f"f{i}")
                                    for i in range(10)])
    b, _ = retrying(inner, attempts=3, base_delay_s=0.01)
    with pytest.raises(rl.UnreachableSegmentError) as ei:
        b.read("k", 0, 7)
    assert inner.calls == 3
    assert isinstance(ei.value.__cause__, rl.TransientFetchError)
    assert b.stats.exhausted == 1


def test_retry_deadline_cuts_attempts_short():
    inner = ScriptedInner(failures=[rl.TransientFetchError(f"f{i}")
                                    for i in range(100)])
    b, clock = retrying(inner, attempts=50, base_delay_s=10.0,
                        max_delay_s=10.0, deadline_s=1.0)
    with pytest.raises(rl.UnreachableSegmentError):
        b.read("k", 0, 7)
    assert inner.calls == 1
    assert clock.sleeps == []


def test_circuit_breaker_opens_fast_fails_and_half_opens():
    inner = ScriptedInner(failures=[rl.TransientFetchError(f"f{i}")
                                    for i in range(100)])
    b, clock = retrying(inner, attempts=1, breaker_threshold=3,
                        breaker_reset_s=5.0)
    for _ in range(3):
        with pytest.raises(rl.UnreachableSegmentError):
            b.read("k", 0, 7)
    calls = inner.calls
    with pytest.raises(rl.UnreachableSegmentError):
        b.read("k", 0, 7)
    assert inner.calls == calls
    assert b.stats.breaker_fast_fails == 1 and b.stats.breaker_opens == 1
    calls = inner.calls
    with pytest.raises(rl.UnreachableSegmentError):
        b.read("other", 0, 7)
    assert inner.calls == calls + 1
    clock.t += 10.0
    inner.failures = []
    assert b.read("k", 0, 7) == b"payload"
    assert b.read("k", 0, 7) == b"payload"


def test_retry_size_retried_prefetch_passthrough():
    b, _ = retrying(ScriptedInner(failures=[TimeoutError()]))
    assert b.size("k") == 7
    b.prefetch("k", 0, 7)
    b.close()


# --------------------------------------------------------- fault injection --

def _fault_reads(rel, backend_mod, seed, n=400, **kw):
    inner = backend_mod.InMemoryBackend({"seg": bytes(range(256)) * 16})
    fb = rel.FaultInjectionBackend(inner, rel.FaultConfig(seed=seed, **kw))
    out = []
    for i in range(n):
        off = (i * 13) % 1024
        try:
            out.append(fb.read("seg", off, 64))
        except rel.StoreIOError as e:
            out.append(type(e).__name__)
    return out, fb.stats.snapshot()


@pytest.mark.parametrize("kw", [dict(transient=0.2, corrupt=0.1),
                                dict(truncate=0.15, transient=0.05),
                                dict(corrupt=0.3)])
def test_fault_injection_same_sequence_as_reference(kw):
    """Deterministic across instances and seeds, and identical to the
    reference's draws for the same seed."""
    a, sa = _fault_reads(rl, bk, 42, **kw)
    b, sb = _fault_reads(rl, bk, 42, **kw)
    assert a == b and sa == sb
    from repro.store import backend as jbk
    j, sj = _fault_reads(jrl, jbk, 42, **kw)
    assert a == j and sa == sj
    assert sum(sa[k] for k in sa if k.endswith("_injected")) > 0
    c, _ = _fault_reads(rl, bk, 43, **kw)
    assert a != c


def test_fault_injection_corruption_is_sticky_single_bitflip():
    inner = bk.InMemoryBackend({"seg": os.urandom(4096)})
    fb = rl.FaultInjectionBackend(inner, rl.FaultConfig(corrupt=1.0, seed=7))
    clean = inner.read("seg", 128, 256)
    r1 = fb.read("seg", 128, 256)
    r2 = fb.read("seg", 128, 256)
    assert r1 == r2 and r1 != clean
    diff = [(i, a ^ b) for i, (a, b) in enumerate(zip(clean, r1)) if a != b]
    assert len(diff) == 1 and bin(diff[0][1]).count("1") == 1


def test_fault_injection_truncation_and_protect():
    inner = bk.InMemoryBackend({"seg": os.urandom(1024),
                                "manifest.json": b"{}" * 100})
    fb = rl.FaultInjectionBackend(
        inner, rl.FaultConfig(truncate=1.0, transient=1.0, seed=3,
                              protect=("manifest",)))
    assert fb.read("manifest.json", 0, 50) == inner.read("manifest.json", 0,
                                                         50)
    with pytest.raises(rl.TransientFetchError):
        fb.read("seg", 0, 100)


def test_fault_injection_slow_read_sleeps():
    inner = bk.InMemoryBackend({"seg": b"x" * 64})
    fb = rl.FaultInjectionBackend(
        inner, rl.FaultConfig(slow=1.0, slow_s=0.01, seed=1))
    t0 = time.perf_counter()
    assert fb.read("seg", 0, 64) == b"x" * 64
    assert time.perf_counter() - t0 >= 0.009
    assert fb.stats.slow_injected == 1


def test_chaos_from_env_parsing():
    inner = bk.InMemoryBackend({"k": b"data"})
    assert rl.chaos_from_env(inner, env="") is inner
    wrapped = rl.chaos_from_env(inner, env="transient=0.25,seed=9,attempts=3")
    assert isinstance(wrapped, rl.RetryingBackend)
    assert isinstance(wrapped.inner, rl.FaultInjectionBackend)
    assert wrapped.inner.faults.transient == 0.25
    assert wrapped.inner.faults.seed == 9
    assert wrapped.policy.attempts == 3
    assert wrapped.read("k", 0, 4) == b"data"
    payload = os.urandom(2048)
    wrapped = rl.chaos_from_env(bk.InMemoryBackend({"seg": payload}),
                                env="transient=0.3,seed=11,attempts=8")
    for i in range(64):
        off = (i * 37) % 1024
        assert wrapped.read("seg", off, 128) == payload[off:off + 128]


# -------------------------------------------- caching backend failure paths --

class _BlockingFlaky:
    """First read blocks until released, then raises; later reads
    succeed."""
    caches = False

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()
        self.calls = 0

    def read(self, key, offset, size):
        self.calls += 1
        if self.calls == 1:
            self.entered.set()
            self.release.wait(timeout=5.0)
            raise rl.TransientFetchError("flaky first read")
        return b"d" * size

    def size(self, key):
        return 1 << 20

    def prefetch(self, key, offset, size):
        pass

    def close(self):
        pass


def test_caching_backend_propagates_error_to_all_coalesced_waiters():
    inner = _BlockingFlaky()
    cb = bk.CachingBackend(inner, workers=0)
    results = []

    def reader():
        try:
            results.append(cb.read("k", 0, 8))
        except rl.TransientFetchError as e:
            results.append(type(e).__name__)

    t_owner = threading.Thread(target=reader)
    t_owner.start()
    assert inner.entered.wait(timeout=5.0)
    waiters = [threading.Thread(target=reader) for _ in range(4)]
    for t in waiters:
        t.start()
    time.sleep(0.05)
    inner.release.set()
    for t in [t_owner] + waiters:
        t.join(timeout=5.0)
    assert results.count("TransientFetchError") >= 1
    assert cb.read("k", 0, 8) == b"d" * 8
    assert ("k", 0, 8) not in cb._inflight


def test_caching_backend_prefetch_worker_survives_inner_failure():
    inner = _BlockingFlaky()
    inner.release.set()
    cb = bk.CachingBackend(inner, workers=1)
    cb.prefetch("k", 0, 8)
    deadline = time.time() + 5.0
    while cb._inflight and time.time() < deadline:
        time.sleep(0.01)
    cb.prefetch("k", 64, 8)
    while (("k", 64, 8) not in cb._cache) and time.time() < deadline:
        time.sleep(0.01)
    assert cb._cache.get(("k", 64, 8)) == b"d" * 8
    assert any(w.is_alive() for w in cb._workers)
    cb.close()


def test_truncated_reads_are_typed(tmp_path):
    p = tmp_path / "seg"
    p.write_bytes(b"0123456789")
    b = bk.LocalFileBackend(str(tmp_path))
    assert b.read("seg", 2, 5) == b"23456"
    with pytest.raises(rl.TruncatedReadError):
        b.read("seg", 5, 10)
    b.close()
    with pytest.raises(rl.TruncatedReadError):
        bk.InMemoryBackend({"seg": b"0123"}).read("seg", 2, 10)


# ------------------------------------------- the read stack under chaos ----

def test_transient_faults_retrieve_byte_identical(store_dir, oracle):
    # fault draws hash the (random) segment key under the process's hash
    # seed: 20% makes "some fault fired" certain for any of them
    with chaos_store(store_dir, transient=0.2) as store:
        s = tst.RetrievalService(store).open_session()
        for tol in TOLS:
            x, bound, _ = s.retrieve("v", tol)
            xo, bo = oracle[tol]
            assert _bits(x) == _bits(xo) and bound == bo
        assert s.stats.degraded_groups == 0
        retry = store.backend.inner
        assert retry.inner.stats.transient_injected > 0
        assert retry.stats.retries >= retry.inner.stats.transient_injected
        assert retry.stats.exhausted == 0


def test_transient_faults_via_env_knob(store_dir, oracle, monkeypatch):
    monkeypatch.setenv(rl.CHAOS_ENV, "transient=0.05,seed=1234")
    with tst.DatasetStore.open(store_dir, device="cpu") as store:
        assert isinstance(store.backend.inner, rl.RetryingBackend)
        s = tst.RetrievalService(store).open_session()
        x, bound, _ = s.retrieve("v", 1e-3)
        xo, bo = oracle[1e-3]
        assert _bits(x) == _bits(xo) and bound == bo


def test_transient_faults_retrieve_many_and_qoi(store_dir, oracle):
    with chaos_store(store_dir, transient=0.05) as store:
        svc = tst.RetrievalService(store)
        s1, s2 = svc.open_session(), svc.open_session()
        outs = svc.retrieve_many([(s1, "v", 1e-3), (s2, "v", 1e-2)])
        assert _bits(outs[0][0]) == _bits(oracle[1e-3][0])
        assert _bits(outs[1][0]) == _bits(oracle[1e-2][0])
        res = s1.retrieve_qoi(["v"], qq.V_TOTAL, tau=1.0)
        assert res.converged and res.degraded_groups == 0


def test_corruption_without_degrade_raises_typed(store_dir, oracle):
    with chaos_store(store_dir, corrupt=0.5) as store:
        s = tst.RetrievalService(store).open_session()
        try:
            x, bound, _ = s.retrieve("v", 1e-4)
        except (rl.StoreIOError, ValueError):
            return
        xo, bo = oracle[1e-4]
        assert _bits(x) == _bits(xo) and bound == bo


@pytest.mark.parametrize("faults", [dict(corrupt=0.4), dict(truncate=0.3),
                                    dict(corrupt=0.2, transient=0.1)])
def test_degrade_matches_reference_under_faults(store_dir, field, faults):
    """degrade=True under the same injected faults: the same values, the
    same widened bounds, bytes and degraded (chunk, piece, group, error) as
    the reference, and every bound covers the true error."""
    outs = {}
    for pkg in ("torch", "jax"):
        st = PKGS[pkg][0]
        with chaos_store(store_dir, pkg, **faults) as store:
            s = st.RetrievalService(store, degrade=True).open_session()
            steps = [s.retrieve("v", tol) for tol in TOLS]
            vr = s.reader("v")
            outs[pkg] = (steps, list(vr.degraded), s.stats.snapshot())
    (t_steps, t_deg, t_stats), (j_steps, j_deg, j_stats) = \
        outs["torch"], outs["jax"]
    for (xt, bt, ft), (xj, bj, fj) in zip(t_steps, j_steps):
        assert _bits(xt) == _bits(xj) and (bt, ft) == (bj, fj)
        assert float(np.abs(xt - field).max()) <= bt
    assert t_deg == j_deg and len(t_deg) > 0
    assert t_stats == j_stats
    assert all(e[3] in ("CorruptSegmentError", "UnreachableSegmentError",
                        "TruncatedReadError") for e in t_deg)


def test_degrade_qoi_matches_reference(store_dir, field):
    """Algorithm 3 under heavy corruption terminates at the degraded floor
    with converged=False, as the reference does, with the same result."""
    res = {}
    for pkg, q in (("torch", qq.V_TOTAL), ("jax", jqq.V_TOTAL)):
        with chaos_store(store_dir, pkg, corrupt=0.9) as store:
            s = PKGS[pkg][0].RetrievalService(store, degrade=True) \
                .open_session()
            res[pkg] = s.retrieve_qoi(["v"], q, tau=1e-6)
    a, b = res["torch"], res["jax"]
    assert not a.converged and a.degraded_groups > 0 and a.iterations < 100
    assert (a.iterations, a.bytes_fetched, a.degraded_groups,
            a.tau_estimated, a.eps_final) == \
        (b.iterations, b.bytes_fetched, b.degraded_groups, b.tau_estimated,
         b.eps_final)
    assert _bits(a.values[0]) == _bits(b.values[0])
    true_err = float(np.abs(a.values[0].astype(np.float64) ** 2
                            - np.asarray(field, np.float64) ** 2).max())
    assert true_err <= a.tau_estimated * (1 + 1e-6)


def test_degrade_reset_allows_recovery(store_dir, oracle):
    store = tst.DatasetStore.open(store_dir, device="cpu")
    s = tst.RetrievalService(store, degrade=True).open_session()
    vr = s.reader("v")
    r0 = vr.chunk_readers[0]
    r0.state[0].cap = 0
    r0.degraded.append((0, -1, "UnreachableSegmentError"))
    _, bound, _ = s.retrieve("v", 1e-3)
    assert bound > oracle[1e-3][1]
    vr.reset_degraded()
    assert vr.degraded_count == 0
    _, b2, _ = s.retrieve("v", 1e-3)
    assert b2 <= 1e-3 < bound or b2 <= oracle[1e-3][1]
    assert vr.chunk_readers[0].state[0].groups_fetched > 0
    store.close()


# ------------------------------------------------------------ fuzz property --

@pytest.fixture(scope="module")
def fuzz_corpus(tmp_path_factory):
    """A small store as memory buffers, written by the port."""
    root = str(tmp_path_factory.mktemp("tfuzz"))
    with tst.DatasetWriter(root, chunk_elems=1000, use_tune_cache=False,
                           device="cpu") as w:
        w.write("v", gaussian_field((12, 12, 12), slope=-2.0, seed=3))
    buffers = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                buffers[os.path.relpath(p, root).replace(os.sep, "/")] = \
                    fh.read()
    shutil.rmtree(root, ignore_errors=True)
    return buffers


def _serve(pkg, buffers):
    """(outcome, x, bound) of a 1e-4 read of ``buffers`` in ``pkg``."""
    st, rel = PKGS[pkg]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    try:
        store = st.DatasetStore.open("", backend=st.InMemoryBackend(buffers),
                                     **kw)
        x, bound, _ = st.RetrievalService(store).open_session().retrieve(
            "v", 1e-4)
    except (rel.StoreIOError, ValueError) as e:
        return type(e).__name__, None, None
    return "served", x, bound


def test_corruption_fuzz_matches_reference(fuzz_corpus):
    """Seeded flips and truncations anywhere in the store (segment file and
    manifest): a typed error, or the fault-free result bit for bit — never
    silent corruption — and the same outcome in both packages."""
    _, ox, ob = _serve("torch", fuzz_corpus)
    outcomes = []
    for entropy in range(24):
        rng = random.Random(entropy)
        mode = ("flip", "truncate")[entropy % 2]
        buffers = dict(fuzz_corpus)
        key = rng.choice(sorted(buffers))
        buf = bytearray(buffers[key])
        if mode == "flip":
            buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
        else:
            buf = buf[:rng.randrange(len(buf))]
        buffers[key] = bytes(buf)
        got = _serve("torch", buffers)
        want = _serve("jax", buffers)
        assert got[0] == want[0], (entropy, key, mode)
        if got[0] == "served":
            assert _bits(got[1]) == _bits(ox) and got[2] == ob, \
                f"SILENT CORRUPTION serving {key} ({mode})"
        outcomes.append(got[0])
    assert any(o != "served" for o in outcomes)


def test_raw_payload_flips_caught_by_crc(fuzz_corpus):
    man = [k for k in fuzz_corpus if k.endswith("manifest.json")][0]
    seg = [k for k in fuzz_corpus if k.endswith(".seg")][0]
    j = json.loads(fuzz_corpus[man])
    raw_refs = [lo.GroupRef.from_json(g)
                for v in j["variables"].values() for c in v["chunks"]
                for p in c["pieces"] for g in [p["sign"]] + p["groups"]
                if str(g[2]) == "dc"]
    assert raw_refs
    for ref in raw_refs[:8]:
        buf = bytearray(fuzz_corpus[seg])
        buf[ref.offset + ref.size // 2 + ref.size // 4] ^= 0x10
        store = tst.DatasetStore.open(
            "", backend=bk.InMemoryBackend({**fuzz_corpus, seg: bytes(buf)}),
            device="cpu")
        with pytest.raises(rl.CorruptSegmentError):
            store.read_segment("v", ref)
