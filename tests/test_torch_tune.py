"""The port's autotuner (``repro_torch.tune.search``) vs the JAX reference, on
the CPU (ports of tests/test_tune.py's ``tune()`` tests).

The measures are monkeypatched as the reference's tests do, so the search
logic runs without probe writes: the model's best probed candidate wins
when it measures fastest, then the cache hits with no search;
``force=True`` searches again; the default heads the probes and wins ties;
failed probes give the default and are counted, as are candidates that
fail to score; ``dispatch_ahead`` and ``depth`` are probed through the
pipelines.  The oracle test gives both packages the same constant-score
stand-in for ``CostModel`` and the same fake times, with ``probes`` 3 and
9, and requires the same probes in the same order, the same winner and
the same cached JSON.  One test runs the real model and probes on a small
shape.  Every test uses a temporary cache root.  Tolerance: none (equal
configs and JSON).
"""
import math
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import tune as jtn  # noqa: E402
from repro.tune import cache as jcache  # noqa: E402
from repro.tune import search as jsearch  # noqa: E402
from repro_torch import tune as tn  # noqa: E402
from repro_torch.tune import cache as tcache  # noqa: E402
from repro_torch.tune import search as tsearch  # noqa: E402
from repro_torch.tune.config import DEFAULT_CONFIG  # noqa: E402

torch.set_num_threads(1)


def _isolate(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune"))
    tcache.invalidate_memo()
    jcache.invalidate_memo()
    tsearch.STATS.reset()
    jsearch.STATS.reset()


def _patch(monkeypatch, module, measure, pipeline_measure=None,
           read_measure=None, default=DEFAULT_CONFIG):
    """Fake every probe of ``module`` (either package's search): program
    writes by ``measure``, pipelined writes and reads by the given fakes or
    by ones where the default window and depth measure fastest."""
    monkeypatch.setattr(module, "_measure_write", measure)
    monkeypatch.setattr(
        module, "_measure_pipeline_write",
        pipeline_measure if pipeline_measure is not None
        else (lambda x, cfg, levels, repeats=2, **kw:
              0.5 if cfg.dispatch_ahead == default.dispatch_ahead else 1.0))
    monkeypatch.setattr(
        module, "_probe_blobs",
        lambda best, n, levels, dtype, n_chunks, **kw:
        (np.linspace(0.0, 1.0, n_chunks * n, dtype=np.float32),
         [b"blob"] * n_chunks))
    monkeypatch.setattr(
        module, "_measure_pipeline_read",
        read_measure if read_measure is not None
        else (lambda blobs, cfg, tol, repeats=2, **kw:
              0.5 if cfg.depth == default.depth else 1.0))


def _cached_meta(shape, levels):
    p = tcache._path(tcache.cache_root(),
                     tcache.backend_fingerprint("auto", 1, "cpu"),
                     tcache.problem_key(shape, "float32", levels))
    return json.loads(p.read_text())


def test_candidate_space_is_design_by_group_size():
    cands = tsearch.candidate_space(DEFAULT_CONFIG)
    assert len(cands) == 9 and len(set(cands)) == 9
    assert {(c.design, c.group_size) for c in cands} == {
        (d, g) for d in tsearch.DESIGNS for g in tsearch.GROUP_SIZES}
    assert all((c.tiles_per_block, c.unroll, c.mag_bits)
               == (DEFAULT_CONFIG.tiles_per_block, DEFAULT_CONFIG.unroll,
                   DEFAULT_CONFIG.mag_bits) for c in cands)
    jcands = jsearch.candidate_space(jtn.DEFAULT_CONFIG, "jnp")
    assert [c.to_json() for c in cands] == [c.to_json() for c in jcands]


def test_probe_data_is_the_reference_s():
    for shape in [(1,), (1000,), (7, 9)]:
        assert np.array_equal(tsearch._probe_chunk(shape, "float32"),
                              jsearch._probe_chunk(shape, "float32"))


def test_the_cost_model_is_the_port_s():
    from repro_torch.tune import cost
    assert tn.CostModel is cost.CostModel is tsearch.CostModel
    assert "CostModel" in tn.__all__


class _RankedModel:
    """A stand-in ``CostModel`` that scores shuffle/8 best, locality/2
    second, and every other candidate alike."""

    def __init__(self, shape, levels=None, dtype="float32", peaks=None,
                 device=None):
        self.scale = 1.0

    def score(self, cfg):
        return {("shuffle", 8): 0.1, ("locality", 2): 0.2}.get(
            (cfg.design, cfg.group_size), 1.0) * self.scale

    def calibrate(self, cfg, measured_s):
        self.scale = measured_s / self.score(cfg)
        return self.scale


def test_tune_measured_best_wins_then_cache_hit(tmp_path, monkeypatch):
    _isolate(tmp_path, monkeypatch)

    def measure(x, cfg, levels, repeats=2, **kw):
        return 0.25 if (cfg.design == "shuffle" and cfg.group_size == 8) \
            else 1.0

    _patch(monkeypatch, tsearch, measure)
    monkeypatch.setattr(tsearch, "CostModel", _RankedModel)
    r1 = tn.tune((1024,), levels=2, probes=2, device="cpu")
    assert not r1.cache_hit
    assert r1.config.design == "shuffle" and r1.config.group_size == 8
    assert r1.config.dispatch_ahead in tsearch.DISPATCH_AHEAD
    # the default, then the model's best two
    assert [(c.design, c.group_size) for c, _ in r1.probes] == [
        ("register_block", 4), ("shuffle", 8), ("locality", 2)]
    assert min(s for _, s in r1.probes) == 0.25
    # the scores are the model's, best first, taken before calibration
    assert len(r1.scores) == 9 and [s for _, s in r1.scores][:2] == [0.1,
                                                                     0.2]
    assert r1.model_scale == 1.0       # the default measured its score
    s1 = tsearch.STATS.snapshot()
    assert s1["searches"] == 1 and s1["candidates_scored"] == 9
    assert s1["probes_failed"] == 0 and r1.failures == ()
    meta = _cached_meta((1024,), 2)["meta"]
    assert meta["model_scale"] == r1.model_scale
    assert meta["n_candidates"] == 9

    # second call: cached winner replayed, NO search, NO probe
    r2 = tn.tune((1024,), levels=2, probes=2, device="cpu")
    assert r2.cache_hit and r2.config == r1.config
    assert r2.scores == () and r2.probes == ()
    assert tsearch.STATS.snapshot() == s1
    # force=True ignores the hit but refreshes the cache
    r3 = tn.tune((1024,), levels=2, probes=2, force=True, device="cpu")
    assert not r3.cache_hit and r3.config == r1.config
    assert tsearch.STATS.snapshot()["searches"] == 2


def test_tune_winner_never_loses_to_default(tmp_path, monkeypatch):
    """The default config heads the probe set; when nothing measures
    faster, the tuner returns it unchanged."""
    _isolate(tmp_path, monkeypatch)
    probed = []

    def measure(x, cfg, levels, repeats=2, **kw):
        probed.append(cfg)
        return 1.0                       # everything ties: first probe wins

    _patch(monkeypatch, tsearch, measure)
    r = tn.tune((512,), levels=1, probes=3, device="cpu")
    assert probed[0] == DEFAULT_CONFIG
    assert len(probed) == 4 and len(set(probed)) == 4
    assert r.config == DEFAULT_CONFIG


def test_tune_counts_probe_failures(tmp_path, monkeypatch):
    """A failed probe is skipped as in the reference, but counted in
    ``probes_failed`` and kept, with its message, in the cache entry."""
    _isolate(tmp_path, monkeypatch)

    def measure(x, cfg, levels, repeats=2, **kw):
        raise RuntimeError("probe exploded")

    _patch(monkeypatch, tsearch, measure)
    r = tn.tune((512,), levels=1, probes=2, device="cpu")
    assert r.config == DEFAULT_CONFIG    # pathological: default, cached
    assert tsearch.STATS.snapshot()["probes_failed"] == 3
    assert len(r.failures) == 3 and "probe exploded" in r.failures[0]
    assert r.model_scale == 1.0          # nothing to calibrate from
    assert r.failures[0].startswith("register_block/group_size=4")
    assert _cached_meta((512,), 1)["meta"]["failures"] == list(r.failures)
    assert tn.tune((512,), levels=1, device="cpu").cache_hit


def test_tune_counts_failed_pipeline_probes(tmp_path, monkeypatch):
    _isolate(tmp_path, monkeypatch)

    def boom(*a, **kw):
        raise RuntimeError("no launch")

    _patch(monkeypatch, tsearch, lambda x, cfg, levels, repeats=2, **kw: 1.0,
           pipeline_measure=boom, read_measure=boom)
    r = tn.tune((1024,), levels=2, device="cpu")
    assert r.config == DEFAULT_CONFIG
    assert tsearch.STATS.snapshot()["probes_failed"] == 6
    assert [f.split(":")[0] for f in r.failures] == [
        "dispatch_ahead 1", "dispatch_ahead 2", "dispatch_ahead 4",
        "depth 1", "depth 2", "depth 4"]


def test_tune_probes_dispatch_ahead_through_pipeline(tmp_path, monkeypatch):
    """The window depth is picked by measured pipelined writes on probe-shape
    chunks, and the probe chunking never leaks into the cached winner."""
    _isolate(tmp_path, monkeypatch)
    seen = []

    def pmeasure(x, cfg, levels, repeats=2, device=None):
        seen.append((cfg.dispatch_ahead, cfg.chunk_elems, x.size, device))
        return {1: 0.9, 2: 0.2, 4: 0.8}[cfg.dispatch_ahead]

    _patch(monkeypatch, tsearch, lambda x, cfg, levels, repeats=2, **kw: 1.0,
           pipeline_measure=pmeasure)
    r = tn.tune((1024,), levels=2, probes=1, device="cpu")
    assert r.config.dispatch_ahead == 2
    assert [d for d, *_ in seen] == list(tsearch.DISPATCH_AHEAD)
    assert all(ce == 1024 and nx == 6 * 1024 and dev == "cpu"
               for _, ce, nx, dev in seen)
    assert r.config.chunk_elems == DEFAULT_CONFIG.chunk_elems
    assert [c.dispatch_ahead for c, _ in r.dispatch_probes] == [1, 2, 4]
    assert tn.tune((1024,), levels=2, device="cpu").config.dispatch_ahead == 2


def test_tune_probes_read_depth_through_pipeline(tmp_path, monkeypatch):
    _isolate(tmp_path, monkeypatch)
    seen = []

    def rmeasure(blobs, cfg, tol, repeats=2, device=None):
        seen.append((cfg.depth, cfg.chunk_elems, len(blobs), device))
        return {1: 0.8, 2: 0.9, 4: 0.1}[cfg.depth]

    _patch(monkeypatch, tsearch, lambda x, cfg, levels, repeats=2, **kw: 1.0,
           read_measure=rmeasure)
    r = tn.tune((1024,), levels=2, probes=1, device="cpu")
    assert r.config.depth == 4
    assert [d for d, *_ in seen] == list(tsearch.DEPTHS)
    assert all(ce == 1024 and nb == 6 and dev == "cpu"
               for _, ce, nb, dev in seen)
    assert r.config.chunk_elems == DEFAULT_CONFIG.chunk_elems
    assert tn.tune((1024,), levels=2, device="cpu").config.depth == 4
    meta = _cached_meta((1024,), 2)["meta"]
    assert [d for d, _ in meta["depth_probes"]] == list(tsearch.DEPTHS)


def test_tune_counts_candidates_that_fail_to_score(tmp_path, monkeypatch):
    """A candidate the model cannot score is not eligible for a probe, as
    in the reference, but it is counted in ``scores_failed`` and named."""
    _isolate(tmp_path, monkeypatch)
    real_score = tsearch.CostModel.score

    def score(self, cfg):
        if cfg.design == "locality":
            raise RuntimeError("no fake for this operator")
        return real_score(self, cfg)

    monkeypatch.setattr(tsearch.CostModel, "score", score)
    _patch(monkeypatch, tsearch, lambda x, cfg, levels, repeats=2, **kw: 1.0)
    r = tn.tune((1024,), levels=2, probes=8, device="cpu")
    st = tsearch.STATS.snapshot()
    assert st["scores_failed"] == 3 and st["candidates_scored"] == 6
    assert st["probes_failed"] == 0
    assert [f.split(":")[0] for f in r.failures] == [
        f"score locality/group_size={g}" for g in tsearch.GROUP_SIZES]
    assert "no fake" in r.failures[0]
    assert len(r.scores) == 6 and len(r.probes) == 6
    assert all(c.design != "locality" for c, _ in r.probes)
    assert _cached_meta((1024,), 2)["meta"]["failures"] == list(r.failures)


class _ConstantModel:
    """The reference's ``CostModel`` with every candidate scored alike, so
    that both packages probe in candidate order."""

    def __init__(self, shape, levels=None, dtype="float32", peaks=None,
                 device=None):
        self.scale = 1.0

    def score(self, cfg):
        return 1.0

    def calibrate(self, cfg, measured_s):
        self.scale = measured_s
        return self.scale


@pytest.mark.parametrize("probes", [3, 9])
@pytest.mark.parametrize("fastest", [None, ("locality", 2), ("shuffle", 8)])
def test_tune_matches_reference_on_equal_times(tmp_path, monkeypatch,
                                               fastest, probes):
    """With the same constant-score model, both packages probe the same
    programs in the same order (the default and ``probes`` more: 4, or all
    9) with the same fake times, then the same window and depth probes:
    the same winner, and the same JSON in each package's cache."""
    _isolate(tmp_path, monkeypatch)
    probed = {"port": [], "ref": []}

    def measure_for(pkg):
        def measure(x, cfg, levels, repeats=2, **kw):
            probed[pkg].append((cfg.design, cfg.group_size, x.tobytes()))
            return 0.25 if (cfg.design, cfg.group_size) == fastest else 1.0
        return measure

    def pmeasure(x, cfg, levels, repeats=2, **kw):
        return {1: 0.3, 2: 0.5, 4: 0.1}[cfg.dispatch_ahead]

    def rmeasure(blobs, cfg, tol, repeats=2, **kw):
        return {1: 0.2, 2: 0.1, 4: 0.7}[cfg.depth]

    _patch(monkeypatch, tsearch, measure_for("port"), pmeasure, rmeasure)
    _patch(monkeypatch, jsearch, measure_for("ref"), pmeasure, rmeasure,
           default=jtn.DEFAULT_CONFIG)
    monkeypatch.setattr(jsearch, "CostModel", _ConstantModel)
    monkeypatch.setattr(tsearch, "CostModel", _ConstantModel)
    got = tn.tune((2048,), levels=2, probes=probes, device="cpu")
    want = jtn.tune((2048,), levels=2, probes=probes)
    assert probed["port"] == probed["ref"]
    assert len(probed["port"]) == min(probes + 1, 9)
    assert got.config.to_json() == want.config.to_json()
    assert [(c.to_json(), s) for c, s in got.probes] == [
        (c.to_json(), s) for c, s in want.probes]
    port_entry = _cached_meta((2048,), 2)
    ref_path = jcache._path(jcache.cache_root(),
                            jcache.backend_fingerprint("auto", 1),
                            jcache.problem_key((2048,), "float32", 2))
    ref_entry = json.loads(ref_path.read_text())
    assert port_entry["config"] == ref_entry["config"]
    for key in ("scores", "probes", "dispatch_probes", "depth_probes",
                "model_scale", "n_candidates"):
        assert port_entry["meta"][key] == ref_entry["meta"][key]


def test_tune_runs_its_real_probes(tmp_path, monkeypatch):
    """No fakes: the model scores every candidate on ``meta`` (9 finite,
    positive scores), every probe writes and reads through the port on the
    CPU, none fails, the default heads 4 program probes, the winner's probe
    time is at most the default's, the model's scale is calibrated, and a
    pipeline with the cache on picks the winner up."""
    from repro_torch.core import pipeline as pl

    _isolate(tmp_path, monkeypatch)
    r = tn.tune((2048,), levels=1, device="cpu")
    assert tsearch.STATS.snapshot()["probes_failed"] == 0 and not r.failures
    assert len(r.scores) == 9 and all(
        math.isfinite(s) and s > 0 for _, s in r.scores)
    assert math.isfinite(r.model_scale) and r.model_scale > 0
    assert len(r.probes) == 4 and r.probes[0][0] == DEFAULT_CONFIG
    assert min(s for _, s in r.probes) <= r.probes[0][1]
    assert len(r.dispatch_probes) == 3 and len(r.depth_probes) == 3
    assert tsearch.STATS.snapshot()["probes_run"] == 10
    assert tn.tune((2048,), levels=1, device="cpu").cache_hit
    pipe = pl.ChunkedRefactorPipeline(chunk_elems=2048, levels=1,
                                      device="cpu")
    assert pipe.config == r.config.replace(chunk_elems=2048)


def test_tune_defaults_to_the_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    _isolate(tmp_path, monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tn.tune((1024,), levels=1)
    assert tsearch.STATS.snapshot()["searches"] == 0
