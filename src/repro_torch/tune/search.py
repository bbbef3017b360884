"""Autotuner: cost-model-guided search with measured probe runs.

A port of ``repro.tune.search``.  ``tune(shape, ...)`` finds the write-path
config for one problem class (shape, dtype, levels, backend, n_devices) on
one device:

  1. consult the on-disk cache (``tune.cache``): a warm cache returns the
     winner with NO search and NO probe;
  2. on a miss, enumerate the candidate space (bitplane design x lossless
     group size: 9 programs) and score every candidate's fused program with
     the roofline model (``tune.cost``: the program's operators counted on
     a ``meta`` tensor, nothing executed);
  3. run measured probe writes of the default config (always) and the
     ``probes`` best-scored candidates (a stable sort: ties in candidate
     order) through the real fused ``refactor_array`` path; the winner is
     the best MEASURED probe, and the default's probe calibrates the
     model's scale;
  4. probe-search the pure-scheduling knobs the program cannot show:
     ``dispatch_ahead`` through the real chunked pipelined WRITE and the
     read-side ``depth`` through the real chunked pipelined READ of the
     winner's own blobs;
  5. cache the measured winner keyed by backend fingerprint.

The default config is always a probe and the winner is the best measured
probe, so a tuned config can only tie or beat the default on the probe
workload, on the machine that tuned it.

A candidate that fails to score, or a probe that raises, is skipped, as in
the reference, but never silently: it counts in ``STATS.scores_failed`` or
``STATS.probes_failed`` and its message goes into the cache entry's
``meta["failures"]`` (and ``TuneResult.failures``).  On the card a failed
probe means a kernel that did not build or launch.

Quality knobs (``mag_bits``) are never searched: tuning changes how bytes
are produced, not which bytes the user asked to keep.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.metrics import StatCounters
from repro_torch.tune import cache as tcache
from repro_torch.tune.config import DEFAULT_CONFIG, RefactorConfig
from repro_torch.tune.cost import CostModel

DESIGNS = ("register_block", "locality", "shuffle")
GROUP_SIZES = (2, 4, 8)
DISPATCH_AHEAD = (1, 2, 4)
DEPTHS = (1, 2, 4)  # read-side overlap look-ahead / drain window

Timed = List[Tuple[RefactorConfig, float]]


@dataclasses.dataclass
class SearchStats(StatCounters):
    """Process-global tuner counters (thread-safe).  ``searches`` counts
    actual searches (a cache hit must NOT increment it);
    ``candidates_scored`` the program candidates the model scored,
    ``scores_failed`` those it could not; ``probes_failed`` the probes that
    raised and were skipped."""
    searches: int = 0
    candidates_scored: int = 0
    scores_failed: int = 0
    probes_run: int = 0
    probes_failed: int = 0


STATS = SearchStats()


@dataclasses.dataclass(frozen=True)
class TuneResult:
    config: RefactorConfig
    cache_hit: bool
    fingerprint: str
    problem: str
    # (config, model_seconds) for every scored candidate, best first;
    # empty on cache hit
    scores: Tuple[Tuple[RefactorConfig, float], ...] = ()
    # (config, measured_seconds) for every program probe in probe order
    # (the default first); empty on cache hit
    probes: Tuple[Tuple[RefactorConfig, float], ...] = ()
    tune_s: float = 0.0
    # (config, seconds) of the dispatch_ahead and depth probes
    dispatch_probes: Tuple[Tuple[RefactorConfig, float], ...] = ()
    depth_probes: Tuple[Tuple[RefactorConfig, float], ...] = ()
    # "what: error" of every score and probe that raised; empty on cache hit
    failures: Tuple[str, ...] = ()
    # the model's scale after calibration on the default's probe
    model_scale: float = 1.0


def candidate_space(base: RefactorConfig) -> List[RefactorConfig]:
    """Program-level candidates: design x group_size.  ``tiles_per_block``
    and ``unroll`` stay the base's: they select nothing in the CUDA kernels
    (the reference's space on its ``jnp`` backend, too)."""
    return [base.replace(design=design, group_size=gs)
            for design in DESIGNS for gs in GROUP_SIZES]


def _probe_chunk(shape: Sequence[int], dtype: str) -> np.ndarray:
    """Deterministic smooth-plus-noise probe data (the reference's bytes):
    representative of the scientific fields the refactorer targets, and
    identical across runs so cached winners are reproducible."""
    rng = np.random.default_rng(20240817)
    n = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
    t = np.linspace(0.0, 6.0, n, dtype=np.float64)
    x = np.sin(t) + 0.05 * rng.standard_normal(n)
    return x.astype(dtype).reshape(shape)


def _sync(device: DeviceLike) -> None:
    """Wait for the device, so that a probe's clock neither starts with the
    previous probe's work still queued nor stops before its own is done."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best_of(once, repeats: int) -> float:
    once()  # warmup: first-call costs (kernel build, allocator) excluded
    best = min(once() for _ in range(max(repeats, 1)))
    STATS.add(probes_run=1)
    return best


def _measure_write(x: np.ndarray, cfg: RefactorConfig,
                   levels: Optional[int], repeats: int = 2,
                   device: DeviceLike = None) -> float:
    """Measured seconds for one chunk through the fused write path with
    ``cfg`` (one warmup, then best-of-``repeats``)."""
    from repro_torch.core import refactor as rf

    def once() -> float:
        _sync(device)
        t0 = time.perf_counter()
        r = rf.refactor_array(x, levels=levels, config=cfg, fused=True,
                              device=device)
        # serialization is part of the write budget the tuner optimizes
        for _ in rf.iter_segments(r):
            pass
        _sync(device)
        return time.perf_counter() - t0

    return _best_of(once, repeats)


def _measure_pipeline_write(x: np.ndarray, cfg: RefactorConfig,
                            levels: Optional[int], repeats: int = 2,
                            device: DeviceLike = None) -> float:
    """Measured seconds for a multi-chunk PIPELINED write with ``cfg``: the
    probe that sees ``dispatch_ahead``, which a single-chunk probe cannot."""
    from repro_torch.core import pipeline as pl

    def once() -> float:
        _sync(device)
        t0 = time.perf_counter()
        pl.ChunkedRefactorPipeline(levels=levels, pipelined=True, config=cfg,
                                   use_tune_cache=False,
                                   device=device).refactor(x)
        _sync(device)
        return time.perf_counter() - t0

    return _best_of(once, repeats)


def _measure_pipeline_read(blobs: Sequence[bytes], cfg: RefactorConfig,
                           tol: float, repeats: int = 2,
                           device: DeviceLike = None) -> float:
    """Measured seconds for a multi-chunk PIPELINED read with ``cfg``: the
    probe that sees ``depth``.  A fresh pipeline per run: incremental
    readers are stateful, so reusing one would time the engine cache."""
    from repro_torch.core import pipeline as pl

    def once() -> float:
        _sync(device)
        t0 = time.perf_counter()
        pl.ChunkedReconstructPipeline(pipelined=True, config=cfg,
                                      device=device).reconstruct(blobs, tol)
        return time.perf_counter() - t0  # the host values are the sync

    return _best_of(once, repeats)


def _probe_blobs(best: RefactorConfig, n: int, levels: Optional[int],
                 dtype: str, n_chunks: int, device: DeviceLike = None
                 ) -> Tuple[np.ndarray, List[bytes]]:
    """Refactor the read probe's data once with the winning config: the
    serialized chunk blobs every depth candidate reconstructs from."""
    from repro_torch.core import pipeline as pl

    x = _probe_chunk((n_chunks * n,), dtype)
    blobs = pl.ChunkedRefactorPipeline(
        levels=levels, pipelined=True, config=best.replace(chunk_elems=n),
        use_tune_cache=False, device=device).refactor(x)
    return x, blobs


def _failed(failures: List[str], what: str, exc: Exception,
            counter: str = "probes_failed") -> None:
    STATS.add(**{counter: 1})
    failures.append(f"{what}: {exc!r}")


def _levels_for(n: int, levels: Optional[int]) -> int:
    if levels is not None:
        return levels
    from repro_torch.core import decompose as dc
    return dc.num_levels((n,))


def _tune_read_depth(best: RefactorConfig, shape: Sequence[int],
                     dtype: str, levels: Optional[int], n_chunks: int = 6,
                     device: DeviceLike = None,
                     failures: Optional[List[str]] = None
                     ) -> Tuple[RefactorConfig, Timed]:
    """Probe-search the read-side overlap ``depth`` through the real
    pipelined read: refactor the probe data ONCE with the winning config,
    then reconstruct the same blobs at every candidate depth and keep the
    fastest (the reconstruction is bit-identical at any depth).  Returns
    (winner, [(cfg, seconds) per depth probed])."""
    failures = [] if failures is None else failures
    n = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
    fallback = (best if best.depth in DEPTHS
                else best.replace(depth=DEPTHS[1]))
    if n == 0:
        return fallback, []
    levels = _levels_for(n, levels)
    try:
        x, blobs = _probe_blobs(best, n, levels, dtype, n_chunks,
                                device=device)
    except Exception as exc:  # noqa: BLE001 - counted and kept, as below
        _failed(failures, "depth probe blobs", exc)
        return fallback, []
    # mid-curve tolerance: deep enough that every chunk fetches several
    # plane groups (the staged-drain schedule depth actually controls)
    tol = 1e-3 * float(np.ptp(x)) if np.ptp(x) > 0 else 1e-3
    timed: Timed = []
    for dp in DEPTHS:
        cfg = best.replace(depth=dp, chunk_elems=n)
        try:
            timed.append((cfg, _measure_pipeline_read(blobs, cfg, tol,
                                                      device=device)))
        except Exception as exc:  # noqa: BLE001 - a failed probe is skipped
            _failed(failures, f"depth {dp}", exc)
    if not timed:
        return fallback, []
    dp = min(timed, key=lambda cs: cs[1])[0].depth
    # probe chunking stays out of the winner: only the depth is adopted
    return best.replace(depth=dp), timed


def _tune_dispatch_ahead(best_prog: RefactorConfig, shape: Sequence[int],
                         dtype: str, levels: Optional[int],
                         n_chunks: int = 6, device: DeviceLike = None,
                         failures: Optional[List[str]] = None
                         ) -> Tuple[RefactorConfig, Timed]:
    """Probe-search the per-device in-flight window depth: run the winning
    program through the real chunked pipeline (``n_chunks`` chunks of the
    probe shape) at every candidate depth and keep the fastest.  Returns
    (winner, [(cfg, seconds) per depth probed])."""
    failures = [] if failures is None else failures
    n = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
    fallback = (best_prog if best_prog.dispatch_ahead in DISPATCH_AHEAD
                else best_prog.replace(dispatch_ahead=DISPATCH_AHEAD[1]))
    if n == 0:
        return fallback, []
    levels = _levels_for(n, levels)
    x = _probe_chunk((n_chunks * n,), dtype)
    timed: Timed = []
    for da in DISPATCH_AHEAD:
        cfg = best_prog.replace(dispatch_ahead=da, chunk_elems=n)
        try:
            timed.append((cfg, _measure_pipeline_write(x, cfg, levels,
                                                       device=device)))
        except Exception as exc:  # noqa: BLE001 - a failed probe is skipped
            _failed(failures, f"dispatch_ahead {da}", exc)
    if not timed:
        return fallback, []
    da = min(timed, key=lambda cs: cs[1])[0].dispatch_ahead
    # probe chunking stays out of the winner: only the depth is adopted
    return best_prog.replace(dispatch_ahead=da), timed


def _label(c: RefactorConfig) -> str:
    return f"{c.design}/group_size={c.group_size}"


def tune(shape: Sequence[int], dtype: str = "float32",
         levels: Optional[int] = None, backend: str = "auto",
         n_devices: int = 1, probes: int = 3,
         base: Optional[RefactorConfig] = None,
         cache_root: Optional[os.PathLike] = None,
         force: bool = False, device: DeviceLike = None) -> TuneResult:
    """Find (or recall) the winning ``RefactorConfig`` for a problem class,
    measured on ``device`` (``None`` means ``cuda``).

    Returns a ``TuneResult``; ``result.config`` is what ``DatasetWriter``
    records in the manifest.  ``force=True`` ignores a cached winner (but
    still stores the fresh one).  ``probes`` is the count of best-scored
    candidates measured besides the default."""
    t0 = time.perf_counter()
    shape = tuple(int(d) for d in shape)
    fp = tcache.backend_fingerprint(backend, n_devices, device)
    problem = tcache.problem_key(shape, dtype, levels)
    if not force:
        hit = tcache.load(fp, problem, root=cache_root)
        if hit is not None:
            return TuneResult(config=hit, cache_hit=True, fingerprint=fp,
                              problem=problem,
                              tune_s=time.perf_counter() - t0)

    STATS.add(searches=1)
    base = (base if base is not None else DEFAULT_CONFIG).replace(
        backend=backend, mesh_devices=(n_devices if n_devices > 1 else None))
    cands = candidate_space(base)

    failures: List[str] = []
    model = CostModel(shape, levels, dtype, device=device)
    scored: Timed = []
    for c in cands:
        try:
            scored.append((c, model.score(c)))
        except Exception as exc:  # noqa: BLE001 - counted, not eligible
            _failed(failures, f"score {_label(c)}", exc, "scores_failed")
    STATS.add(candidates_scored=len(scored))
    scored.sort(key=lambda cs: cs[1])

    # measured probes: the default, then the model's best ``probes``
    # programs; the winner is the best MEASURED probe, so tuned >= default
    # on this machine
    probe_set: List[RefactorConfig] = [base]
    for c, _ in scored:
        if len(probe_set) >= max(probes, 1) + 1:
            break
        if c not in probe_set:
            probe_set.append(c)

    x = _probe_chunk(shape, dtype)
    measured: Timed = []
    for c in probe_set:
        try:
            measured.append((c, _measure_write(x, c, levels, device=device)))
        except Exception as exc:  # noqa: BLE001 - a failed probe is skipped
            _failed(failures, _label(c), exc)
    if measured and measured[0][0] == base:
        model.calibrate(base, measured[0][1])
    if not measured:            # pathological: keep the default, cache it
        measured = [(base, float("inf"))]
    best_prog = min(measured, key=lambda cs: cs[1])[0]

    # pipeline knob branch: dispatch_ahead and depth change scheduling, not
    # the program, so the model cannot rank them and each is probed through
    # its real pipeline.  If every program probe failed the machine cannot
    # be trusted to probe more: keep the default window.
    if np.isfinite(min(s for _, s in measured)):
        best, da_probes = _tune_dispatch_ahead(
            best_prog, shape, dtype, levels, device=device,
            failures=failures)
        best, depth_probes = _tune_read_depth(
            best, shape, dtype, levels, device=device, failures=failures)
    else:
        best = (best_prog if best_prog.dispatch_ahead in DISPATCH_AHEAD
                else best_prog.replace(dispatch_ahead=DISPATCH_AHEAD[1]))
        da_probes, depth_probes = [], []

    tcache.store(
        fp, problem, best,
        meta={"scores": [[c.to_json(), s] for c, s in scored[:8]],
              "probes": [[c.to_json(), s] for c, s in measured],
              "dispatch_probes": [[c.dispatch_ahead, s]
                                  for c, s in da_probes],
              "depth_probes": [[c.depth, s] for c, s in depth_probes],
              "failures": failures,
              "model_scale": model.scale,
              "n_candidates": len(cands)},
        root=cache_root)
    return TuneResult(config=best, cache_hit=False, fingerprint=fp,
                      problem=problem, scores=tuple(scored),
                      probes=tuple(measured),
                      tune_s=time.perf_counter() - t0,
                      dispatch_probes=tuple(da_probes),
                      depth_probes=tuple(depth_probes),
                      failures=tuple(failures), model_scale=model.scale)
