"""The port's chunked pipelines, chunk placement and tune cache vs the JAX
reference, on the CPU.

Inputs are made with numpy from a seed; the port runs with ``device="cpu"``.
Tolerance: none.  Chunk blobs are byte-identical to the reference's, for
every design, pipelined and serial; reconstructions are bit-identical.  The
scheduling contracts mirror tests/test_pipeline_stats.py,
tests/test_async_pipeline.py and tests/test_refactor_fused.py: overlap_map
order, depth and exception propagation, serial stage sums, the sync budget
(3 host syncs per drained window) and no thread leaks.  The tune-cache tests
use a temporary cache root and never touch ``out/tune``.
"""
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import tune as jtn  # noqa: E402
from repro.core import pipeline as jpl  # noqa: E402
from repro.tune import cache as jcache  # noqa: E402
from repro_torch import tune as tn  # noqa: E402
from repro_torch.core import lossless_batch as lb  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core import sharded as shd  # noqa: E402
from repro_torch.data.fields import gaussian_field  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.tune import cache as tcache  # noqa: E402

torch.set_num_threads(1)

DESIGNS = ["register_block", "locality", "shuffle"]
X = gaussian_field((24, 20, 32), slope=-2.0, seed=17)   # 15,360 values


def _write(pipelined=True, dispatch_ahead=2, chunk_elems=2048, x=X,
           **kw):
    pipe = pl.ChunkedRefactorPipeline(chunk_elems=chunk_elems, levels=2,
                                      pipelined=pipelined,
                                      dispatch_ahead=dispatch_ahead,
                                      use_tune_cache=False, device="cpu",
                                      **kw)
    return pipe, pipe.refactor(x, name="v")


def _ref_write(pipelined=True, chunk_elems=2048, x=X, **kw):
    return jpl.ChunkedRefactorPipeline(
        chunk_elems=chunk_elems, levels=2, pipelined=pipelined,
        use_tune_cache=False, **kw).refactor(x, name="v")


# ------------------------------------------------ identity with the reference

@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("design", DESIGNS)
def test_chunk_blobs_match_reference(design, pipelined):
    _, blobs = _write(pipelined, design=design)
    assert len(blobs) == 8
    assert blobs == _ref_write(pipelined, design=design)


@pytest.mark.parametrize("design", DESIGNS)
def test_unfused_chunks_match_reference(design):
    _, blobs = _write(True, design=design, fused=False)
    assert blobs == _ref_write(True, design=design, fused=False)


@pytest.mark.parametrize("design", DESIGNS)
def test_reconstruct_matches_reference(design):
    blobs = _ref_write(False, design=design)
    tol = 1e-4
    want = jpl.ChunkedReconstructPipeline(pipelined=False).reconstruct(
        blobs, tol)
    for kw in ({"pipelined": True}, {"pipelined": False},
               {"pipelined": True, "depth": 3},
               {"pipelined": True, "incremental": False}):
        got = pl.ChunkedReconstructPipeline(device="cpu", **kw).reconstruct(
            blobs, tol)
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert np.abs(got - X.reshape(-1)).max() <= tol


def test_empty_inputs_like_the_reference():
    blobs = pl.ChunkedRefactorPipeline(pipelined=False, device="cpu").refactor(
        np.zeros((0,), np.float32), "e")
    assert blobs == jpl.ChunkedRefactorPipeline(pipelined=False).refactor(
        np.zeros((0,), np.float32), "e")
    for piped in (True, False):
        out = pl.ChunkedReconstructPipeline(pipelined=piped,
                                            device="cpu").reconstruct([], 1e-3)
        assert out.shape == (0,) and out.dtype == np.float32


# --------------------------------------------------------------- placement --

def test_round_robin_placement_is_byte_identical():
    """A 3-shard mesh (on the CPU: three shards of the host device) places
    chunks round-robin, batches per window and writes the same bytes."""
    _, base = _write(False)
    shd.STATS.reset()
    pipe, blobs = _write(True, mesh=3)
    assert blobs == base
    assert pipe.chunk_shards(8) == [0, 1, 2, 0, 1, 2, 0, 1]
    assert shd.STATS.snapshot()["dispatches_by_device"] == {0: 3, 1: 3, 2: 2}
    out = pl.ChunkedReconstructPipeline(mesh=3, device="cpu").reconstruct(
        blobs, 1e-3)
    want = pl.ChunkedReconstructPipeline(device="cpu").reconstruct(blobs,
                                                                   1e-3)
    assert out.tobytes() == want.tobytes()


def test_mesh_rules():
    assert shd.resolve_mesh(None) is None
    assert shd.chunk_devices(None, "cpu") == [torch.device("cpu")]
    assert shd.resolve_mesh(2, "cpu") == [torch.device("cpu")] * 2
    assert shd.resolve_mesh(["cpu"]) == [torch.device("cpu")]
    for bad, err in [(0, ValueError), ([], ValueError), ("x", TypeError)]:
        with pytest.raises(err):
            shd.resolve_mesh(bad, "cpu")
    eng = shd.ShardedReconstructEngine(2, shards=[1, 1, 0], device="cpu")
    assert [eng.shard_for(i) for i in range(4)] == [1, 1, 0, 1]


# ---------------------------------------------------------- sync budget --

def test_three_host_syncs_per_drained_window():
    """8 chunks at dispatch_ahead 2 are 4 drains, at 4 two: 3 host syncs
    each (scalars + codec stats + payload); serial mode is 3 per chunk.
    ``write.syncs_per_chunk`` reports the same budget."""
    for da, drains in [(2, 4), (4, 2)]:
        shd.STATS.reset()
        with obs_metrics.REGISTRY.scope(), lb.stats_scope() as st:
            _write(True, dispatch_ahead=da)
            gauges = obs_metrics.snapshot()["gauges"]
        assert shd.STATS.snapshot()["rounds"] == drains
        assert st.host_syncs == 3 * drains
        assert gauges["write.syncs_per_chunk"] == 3 * drains / 8
    with obs_metrics.REGISTRY.scope(), lb.stats_scope() as st:
        _write(False)
        gauges = obs_metrics.snapshot()["gauges"]
    assert st.host_syncs == 3 * 8
    assert gauges["write.syncs_per_chunk"] == 3.0


def test_pipelined_copy_in_never_syncs(monkeypatch):
    calls = []
    orig = pl._sync_stage
    monkeypatch.setattr(pl, "_sync_stage",
                        lambda dev: (calls.append(dev), orig(dev))[1])
    p, blobs = _write(True)
    assert p.stage_timing is False and calls == []
    s, serial = _write(False)
    assert s.stage_timing is True and len(calls) >= 8
    assert blobs == serial


def test_serial_stage_times_sum_to_wall():
    p, blobs = _write(False, chunk_elems=4096)
    st = p.stats
    ssum = st.copy_in_s + st.compute_s + st.copy_out_s
    assert ssum <= st.wall_s * 1.01
    assert ssum >= 0.6 * st.wall_s, (ssum, st.wall_s)
    r = pl.ChunkedReconstructPipeline(pipelined=False, device="cpu")
    out = r.reconstruct(blobs, tol=1e-4)
    assert np.abs(out - X.reshape(-1)).max() <= 1e-4
    rs = r.stats
    rsum = rs.copy_in_s + rs.compute_s + rs.copy_out_s
    assert rsum <= rs.wall_s * 1.01
    assert rsum >= 0.6 * rs.wall_s, (rsum, rs.wall_s)


# ------------------------------------------------------------- overlap_map --

@pytest.mark.parametrize("depth", [1, 2, 3, 7])
def test_overlap_map_preserves_order(depth):
    rng = np.random.default_rng(depth)
    delays = rng.uniform(0, 0.004, 12)
    seen_ahead = []
    done = [-1]

    def stage1(i):
        time.sleep(delays[i])
        return i * 10

    def stage2(i, s1):
        seen_ahead.append(i - done[0])
        done[0] = i
        assert s1 == i * 10
        return i

    assert pl.overlap_map(12, stage1, stage2, depth=depth) == list(range(12))
    assert all(a == 1 for a in seen_ahead)
    assert pl.overlap_map(3, stage1, stage2, pipelined=False) == [0, 1, 2]


@pytest.mark.parametrize("depth", [2, 4])
def test_overlap_map_stage1_exception_propagates(depth):
    def stage1(i):
        if i == 5:
            raise ValueError("feeder boom")
        return i

    with pytest.raises(ValueError, match="feeder boom"):
        pl.overlap_map(10, stage1, lambda i, s: s, depth=depth)


@pytest.mark.parametrize("depth", [2, 4])
def test_overlap_map_stage2_exception_stops_feeder(depth):
    started = []
    before = threading.active_count()

    def stage1(i):
        started.append(i)
        return i

    def stage2(i, s):
        if i == 3:
            raise RuntimeError("consumer boom")
        return s

    with pytest.raises(RuntimeError, match="consumer boom"):
        pl.overlap_map(50, stage1, stage2, depth=depth)
    assert max(started) <= 3 + depth + 2
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


# ------------------------------------------------------ failure propagation

def _threads():
    return {t for t in threading.enumerate() if t.is_alive()}


def test_dispatch_failure_propagates_and_leaks_no_threads(monkeypatch):
    before = _threads()
    orig = shd.ShardedRefactorPlan.dispatch

    def bad_dispatch(self, ci, chunk, name="chunk"):
        if ci == 3:
            raise RuntimeError("device queue failed")
        return orig(self, ci, chunk, name=name)

    monkeypatch.setattr(shd.ShardedRefactorPlan, "dispatch", bad_dispatch)
    with pytest.raises(RuntimeError, match="device queue failed"):
        _write(True)
    assert not [t for t in _threads() - before if t.is_alive()]


def test_sink_exception_propagates():
    def sink(ci, refd):
        if ci == 2:
            raise RuntimeError("sink boom")
        return b""

    with pytest.raises(RuntimeError, match="sink boom"):
        _write(True, dispatch_ahead=3, sink=sink)


# --------------------------------------------------------------- tune cache

def test_tune_cache_round_trip(tmp_path, monkeypatch):
    """A stored winner is replayed by the pipeline (one memoized read),
    under a fingerprint of the port's own: the JAX package's lookup for the
    same problem misses, and nothing is written under ``out/tune``."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path))
    tcache.invalidate_memo()
    jcache.invalidate_memo()
    tcache.STATS.reset()
    fp = tcache.backend_fingerprint("auto", 1, device="cpu")
    assert fp.startswith("repro_torch-torch-cpu-1dev-torch")
    problem = tcache.problem_key((2048,), levels=2)
    tcache.store(fp, problem, tn.RefactorConfig(design="shuffle",
                                                 dispatch_ahead=4))
    pipe = pl.ChunkedRefactorPipeline(chunk_elems=2048, levels=2,
                                      device="cpu")
    assert pipe.design == "shuffle" and pipe.dispatch_ahead == 4
    assert tcache.STATS.snapshot() == {"hits": 1, "misses": 0, "stores": 1}
    assert pipe.refactor(X, "v") == _write(True, design="shuffle")[1]
    # explicit kwargs win over the cached winner
    assert pl.ChunkedRefactorPipeline(chunk_elems=2048, levels=2,
                                      design="locality",
                                      device="cpu").design == "locality"
    # the packages never read each other's entries
    assert jtn.cached_config(shape=(2048,), levels=2) is None
    assert tcache.load(jcache.backend_fingerprint(), problem) is None
    assert sorted(p.name for p in tmp_path.iterdir()) == [fp]
    # a corrupt entry is a miss, never an error
    (tmp_path / fp / f"{problem}.json").write_text("{not json")
    tcache.invalidate_memo()
    assert tn.cached_config((2048,), levels=2, device="cpu") is None
    path = tcache.store(fp, problem, tn.RefactorConfig(design="locality"))
    assert json.loads(path.read_text())["meta"]["fingerprint"] == fp
    tcache.invalidate_memo()
