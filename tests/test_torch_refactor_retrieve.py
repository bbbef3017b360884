"""The port's write and read paths vs the JAX reference, on the CPU.

* ``refactored_to_bytes`` is byte-identical to the reference's over the
  shapes, levels and designs of tests/test_serialization.py and
  tests/test_core.py, 0-d and empty arrays included, through all three
  write paths (fused, ``fused=False``, ``batched=False``);
* the write path makes 3 host syncs per chunk, as the reference counts them;
* over a tolerance ladder the port plans the same groups, fetches the same
  bytes, reports the same bound, and reconstructs bit-identically, with
  ``incremental=True`` and ``False``;
* each package reads the other's wire blobs, and a reference-written
  ``RefactorConfig`` loads in the port;
* ``degrade=`` drops the same groups as the reference when a segment source
  fails.
Exact equality everywhere.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import tune as jtn  # noqa: E402
from repro.core import lossless as jll  # noqa: E402
from repro.core import lossless_batch as jlb  # noqa: E402
from repro.core import refactor as jrf  # noqa: E402
from repro.core import retrieve as jrt  # noqa: E402
from repro.store import reliability as jrl  # noqa: E402
from repro_torch import tune as tn  # noqa: E402
from repro_torch.core import lossless as ll  # noqa: E402
from repro_torch.core import lossless_batch as lb  # noqa: E402
from repro_torch.core import refactor as rf  # noqa: E402
from repro_torch.core.align import MagnitudeOverflowError  # noqa: E402
from repro_torch.core import refactor_fused as rff  # noqa: E402
from repro_torch.core import retrieve as rt  # noqa: E402
from repro_torch.data.fields import gaussian_field  # noqa: E402
from repro_torch.store import reliability as rl  # noqa: E402

torch.set_num_threads(1)

DESIGNS = ["register_block", "locality", "shuffle"]
PATHS = {"fused": {}, "batched": {"fused": False}, "pergroup":
         {"batched": False}}


def _random_array(seed: int) -> np.ndarray:
    """The generator of tests/test_serialization.py (0-d, empty and
    degenerate axes included)."""
    rng = np.random.default_rng(seed)
    ndim = int(rng.integers(0, 4))
    if ndim == 0:
        return rng.normal(size=()).astype(np.float32)
    dims = [int(d) for d in rng.integers(0, 18, size=ndim)]
    if rng.uniform() < 0.7:
        dims = [max(d, 2) for d in dims]
    x = np.zeros(tuple(dims), np.float32)
    if x.size:
        x = (rng.normal(size=x.shape)
             * 10.0 ** float(rng.integers(-4, 5))).astype(np.float32)
    return x


def _bits(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("path", list(PATHS))
def test_overflowing_magnitude_raises_instead_of_breaking_the_bound(path):
    """The input recorded under ROADMAP's faults: the reference stores it
    with a top bit dropped and reconstructs outside its own bound; the port
    refuses to store it, on every write path."""
    x = np.array([1023.99994, 511.99997, -1023.99994], np.float32)
    r = jrf.refactor_array(x, "t", **PATHS[path])
    xh, bound, _ = jrt.ProgressiveReader(r).retrieve(0.0)
    assert np.abs(xh - x).max() > bound
    with pytest.raises(ValueError, match="2\\*\\*23"):
        rf.refactor_array(x, "t", device="cpu", **PATHS[path])


TINY_TOLS = (1e-1, 1e-2, 1e-5, 0.0)


@pytest.mark.parametrize("k", [-90, -100, -104])
def test_tiny_fields_byte_and_bit_identical(k):
    """A field scaled by 2**k, down to the last k whose quantization scale
    ``exp2(23 - e)`` stays finite: byte-identical blobs, and reconstructions
    bit-identical at every tolerance, which needs the reference's
    flush-to-zero and fused multiply-add in the merges."""
    x = gaussian_field((32, 32, 32), seed=0) * np.float32(2.0 ** k)
    want = jrf.refactored_to_bytes(jrf.refactor_array(x, "t"))
    blob = rf.refactored_to_bytes(rf.refactor_array(x, "t", device="cpu"))
    assert blob == want
    jreader = jrt.ProgressiveReader(jrf.refactored_from_bytes(want))
    reader = rt.ProgressiveReader(rf.refactored_from_bytes(blob),
                                  device="cpu")
    for tol in TINY_TOLS:
        xj, bj, fj = jreader.retrieve(tol, relative=True)
        xt, bt, ft = reader.retrieve(tol, relative=True)
        assert (bt, ft) == (bj, fj), tol
        assert _bits(xt) == _bits(np.asarray(xj)), tol


@pytest.mark.parametrize("k", [-105, -110, -126])
def test_fields_past_the_scale_range_raise(k):
    """From 2**-105 on, this field's coarsest piece has an exponent that puts
    ``exp2(23 - e)`` past float32's range, and the port refuses to store the
    field."""
    x = gaussian_field((32, 32, 32), seed=0) * np.float32(2.0 ** k)
    with pytest.raises(MagnitudeOverflowError):
        rf.refactor_array(x, "t", device="cpu")


@pytest.mark.parametrize("shape", [(), (1,), (0,), (3, 0), (1, 1), (2,),
                                   (1, 5, 1)])
@pytest.mark.parametrize("path", list(PATHS))
def test_degenerate_shapes_byte_identical(shape, path):
    rng = np.random.default_rng(1)
    n = int(np.prod(shape, dtype=int))
    x = (rng.normal(size=shape).astype(np.float32) if n
         else np.zeros(shape, np.float32))
    want = jrf.refactored_to_bytes(jrf.refactor_array(x, "t", **PATHS[path]))
    r = rf.refactor_array(x, "t", device="cpu", **PATHS[path])
    assert rf.refactored_to_bytes(r) == want
    xh, bound, _ = rt.ProgressiveReader(r, device="cpu").retrieve(1e-4)
    assert xh.shape == shape
    if n:
        assert np.abs(xh - x).max() <= bound <= 1e-4


@pytest.mark.parametrize("seed", [3, 11, 17, 23, 42, 77])
@pytest.mark.parametrize("design", DESIGNS)
def test_random_arrays_byte_identical(seed, design):
    x = _random_array(seed)
    levels = 1 + seed % 4
    want = jrf.refactored_to_bytes(jrf.refactor_array(
        x, "t", levels=levels, design=design))
    for kw in PATHS.values():
        got = rf.refactored_to_bytes(rf.refactor_array(
            x, "t", levels=levels, design=design, device="cpu", **kw))
        assert got == want, kw


@pytest.mark.parametrize("shape", [(64,), (33, 47), (16, 20, 24)])
def test_fields_byte_identical_with_options(shape):
    """Smooth fields (tests/test_core.py shapes), mag_bits and hybrid
    overrides, and a config= spelling of the same knobs."""
    x = gaussian_field(shape, seed=1)
    hyb = jll.HybridConfig(group_size=3, size_threshold=256)
    want = jrf.refactored_to_bytes(jrf.refactor_array(
        x, "f", mag_bits=20, hybrid=hyb))
    got = rf.refactored_to_bytes(rf.refactor_array(
        x, "f", mag_bits=20, hybrid=ll.HybridConfig(group_size=3,
                                                    size_threshold=256),
        device="cpu"))
    assert got == want
    cfg = tn.RefactorConfig(mag_bits=20, group_size=3, size_threshold=256)
    assert rf.refactored_to_bytes(rf.refactor_array(
        x, "f", config=cfg, device="cpu")) == want


def test_three_host_syncs_per_chunk():
    x = gaussian_field((40, 36), seed=5)
    with jlb.stats_scope() as js:
        jrf.refactor_array(x, "s")
    for kw in ({}, {"fused": False}):
        with lb.stats_scope() as ts:
            rf.refactor_array(x, "s", device="cpu", **kw)
        assert ts.host_syncs == js.host_syncs == 3, kw
    rff.STATS.reset()
    rf.refactor_array(x, "s", device="cpu")
    assert rff.STATS.dispatches == 1
    # read side: one sync per fetch that decodes a compressed segment
    r = rf.refactor_array(x, "s", device="cpu")
    reader = rt.ProgressiveReader(r, device="cpu")
    for tol in (1e-2, 1e-5):
        with lb.stats_scope() as ts:
            reader.retrieve(tol)
        assert ts.host_syncs <= 1


LADDER = [1e-1, 1e-2, 1e-3, 1e-4, 1e-5, 1e-6, 1e-7]


@pytest.mark.parametrize("shape,design", [((48, 40), "register_block"),
                                          ((20, 18, 12), "register_block"),
                                          ((300,), "locality"),
                                          ((24, 30), "shuffle")])
def test_ladder_plans_bytes_bounds_and_reconstructions(shape, design):
    x = gaussian_field(shape, slope=-2.5, seed=len(shape))
    blob = jrf.refactored_to_bytes(jrf.refactor_array(x, "l", design=design))
    jreader = jrt.ProgressiveReader(jrf.refactored_from_bytes(blob))
    readers = [rt.ProgressiveReader(rf.refactored_from_bytes(blob),
                                    device="cpu", incremental=inc)
               for inc in (True, False)]
    for tol in LADDER:
        plan = jreader.plan(tol * jreader.ref.data_range)
        xj, bj, fj = jreader.retrieve(tol, relative=True)
        for reader in readers:
            assert reader.plan(tol * reader.ref.data_range) == plan
            xt, bt, ft = reader.retrieve(tol, relative=True)
            assert (bt, ft) == (bj, fj), (tol, reader.incremental)
            assert reader.total_bytes_fetched == jreader.total_bytes_fetched
            assert _bits(xt) == _bits(np.asarray(xj)), (tol, reader.incremental)
            assert np.abs(xt - x).max() <= bt
    assert readers[0].delta_decoded_bytes() == \
        jreader.delta_decoded_bytes()
    assert readers[0].decoded_plane_bytes() == jreader.decoded_plane_bytes()


def test_fetch_one_more_group_matches_reference():
    x = gaussian_field((30, 26), seed=9)
    blob = jrf.refactored_to_bytes(jrf.refactor_array(x, "g"))
    a = jrt.ProgressiveReader(jrf.refactored_from_bytes(blob))
    b = rt.ProgressiveReader(rf.refactored_from_bytes(blob), device="cpu")
    for _ in range(12):
        assert b.peek_best() == a.peek_best()
        assert b.fetch_one_more_group() == a.fetch_one_more_group()
        xa, ba = a.reconstruct()
        xb, bb = b.reconstruct()
        assert ba == bb and _bits(xa) == _bits(xb)


def test_blobs_cross_read():
    """A reference-written blob reads in the port and the reverse, with
    identical reconstructions on both sides."""
    x = gaussian_field((26, 22, 10), seed=2)
    jblob = jrf.refactored_to_bytes(jrf.refactor_array(x, "c", levels=2))
    tblob = rf.refactored_to_bytes(rf.refactor_array(x, "c", levels=2,
                                                     device="cpu"))
    assert jblob == tblob
    in_port = rf.refactored_from_bytes(jblob)
    in_ref = jrf.refactored_from_bytes(tblob)
    assert rf.refactored_to_bytes(in_port) == jblob
    assert jrf.refactored_to_bytes(in_ref) == tblob
    xa, ba, _ = jrt.ProgressiveReader(in_ref).retrieve(1e-4)
    xb, bb, _ = rt.ProgressiveReader(in_port, device="cpu").retrieve(1e-4)
    assert ba == bb and _bits(xa) == _bits(xb)
    # the payload-free header and the segment stream layers agree too
    assert rf.refactored_meta(in_port) == jrf.refactored_meta(in_ref)
    assert [s.to_bytes() for *_, s in rf.iter_segments(in_port)] == \
        [s.to_bytes() for *_, s in jrf.iter_segments(in_ref)]


def test_stub_refactored_plans_like_real():
    x = gaussian_field((24, 24), seed=3)
    r = rf.refactor_array(x, "t", levels=2, device="cpu")

    def stub(pi, kind, gi):
        seg = (r.pieces[pi].sign_seg if kind == "sign"
               else r.pieces[pi].groups[gi])
        return ll.Segment(seg.method, 0, payload={},
                          meta={"stored_bytes": seg.stored_bytes,
                                **dict(seg.meta)})

    r2 = rf.refactored_from_meta(rf.refactored_meta(r), stub)
    for tol in [1e-1, 1e-3, 1e-5]:
        assert (rt.ProgressiveReader(r, device="cpu").plan(tol)
                == rt.ProgressiveReader(r2, device="cpu").plan(tol)), tol


def test_reference_config_loads_in_port():
    for jb, tb in [("pallas", "cuda"), ("jnp", "torch"),
                   ("pallas_interpret", "torch"), ("auto", "auto")]:
        j = jtn.RefactorConfig(design="shuffle", tiles_per_block=4,
                               unroll="naive", group_size=3,
                               backend=jb).to_json()
        j["future_knob"] = 7
        cfg = tn.RefactorConfig.from_json(j)
        assert cfg.backend == tb
        assert (cfg.design, cfg.tiles_per_block, cfg.unroll,
                cfg.group_size) == ("shuffle", 4, "naive", 3)
    with pytest.raises(ValueError):
        tn.RefactorConfig(backend="jnp")
    assert tn.RefactorConfig.from_json(tn.DEFAULT_CONFIG.to_json()) == \
        tn.DEFAULT_CONFIG


class _FailingSource:
    """Serves the inline segments but fails on a set of (piece, group)."""

    def __init__(self, ref, fail, exc):
        self._ref, self._fail, self._exc = ref, set(fail), exc

    def sign(self, piece):
        if (piece, -1) in self._fail:
            raise self._exc("sign unreachable")
        return self._ref.pieces[piece].sign_seg

    def group(self, piece, group):
        if (piece, group) in self._fail:
            raise self._exc("group unreachable")
        return self._ref.pieces[piece].groups[group]

    def prefetch(self, wants):
        pass


@pytest.mark.parametrize("fail", [[(1, 1)], [(2, -1)], [(0, 2), (3, 0)]])
def test_degrade_matches_reference(fail):
    x = gaussian_field((36, 30), seed=6)
    blob = jrf.refactored_to_bytes(jrf.refactor_array(x, "d", levels=3))
    jr = jrf.refactored_from_bytes(blob)
    tr = rf.refactored_from_bytes(blob)
    a = jrt.ProgressiveReader(
        jr, source=_FailingSource(jr, fail, jrl.UnreachableSegmentError),
        degrade=True)
    b = rt.ProgressiveReader(
        tr, source=_FailingSource(tr, fail, rl.UnreachableSegmentError),
        degrade=True, device="cpu")
    for tol in (1e-2, 1e-5):
        xa, ba, fa = a.retrieve(tol)
        xb, bb, fb = b.retrieve(tol)
        assert (bb, fb) == (ba, fa)
        assert _bits(xb) == _bits(xa)
    assert b.degraded == a.degraded and b.degraded_count > 0
    strict = rt.ProgressiveReader(
        tr, source=_FailingSource(tr, fail, rl.UnreachableSegmentError),
        device="cpu")
    with pytest.raises(rl.StoreIOError):
        strict.retrieve(1e-6)
    assert strict.total_bytes_fetched == 0
    assert rl.classify(rl.UnreachableSegmentError()) == "fatal"
    assert rl.classify(rl.CorruptSegmentError()) == "corrupt"
    assert rl.classify(rl.TransientFetchError()) == "transient"


def test_reader_rules():
    r = rf.refactor_array(np.ones((8, 8), np.float32), device="cpu")
    # shared= routes through a serving tier (same values as a private
    # reader); the full-decode oracle stays private
    from repro_torch.store.serving import ServingTier
    tier = ServingTier()
    a = rt.ProgressiveReader(r, device="cpu", shared=tier)
    b = rt.ProgressiveReader(r, device="cpu")
    xa, ba, fa = a.retrieve(1e-3)
    xb, bb, fb = b.retrieve(1e-3)
    assert _bits(xa) == _bits(xb) and (ba, fa) == (bb, fb)
    assert tier.stats.snapshot()["decoded"] > 0
    assert rt.ProgressiveReader(r, device="cpu", shared=tier,
                                incremental=False).shared is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            rt.ProgressiveReader(r)
        with pytest.raises(RuntimeError):
            rf.refactor_array(np.ones(4, np.float32))
