"""Core numerics of the PyTorch port vs the JAX reference, on the CPU.

Alignment, the multilevel decomposition, the lossless codecs and the batched
lossless engine must be bit-identical (exact equality of bits and bytes).
Inputs are made with numpy from a seed and handed to both packages.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import align as jal  # noqa: E402
from repro.core import decompose as jdc  # noqa: E402
from repro.core import lossless as jll  # noqa: E402
from repro.core import lossless_batch as jlb  # noqa: E402
from repro_torch.core import align as al  # noqa: E402
from repro_torch.core import decompose as dc  # noqa: E402
from repro_torch.core import lossless as ll  # noqa: E402
from repro_torch.core import lossless_batch as lb  # noqa: E402
from repro_torch.data import fields  # noqa: E402
from repro.data import fields as jfields  # noqa: E402

torch.set_num_threads(1)


def bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


# ------------------------------------------------------------------- align --

def _align_input(case: str) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if case == "zeros":
        return np.zeros(64, np.float32)
    if case == "empty":
        return np.zeros(0, np.float32)
    if case == "subnormal":
        return np.array([1e-40, -2e-40, 0.0, 3e-41, -1e-45], np.float32)
    if case == "mixed_subnormal":
        return np.array([1e-30, -2e-38, 0.0, 3e-41, 5e-39], np.float32)
    if case == "signed_zero":
        return np.array([-0.0, 0.0, -1.5, 2.25], np.float32)
    scale = float(case.split("=")[1])
    return (rng.normal(size=700) * scale).astype(np.float32)


ALIGN_CASES = (["zeros", "empty", "subnormal", "mixed_subnormal",
                "signed_zero"]
               + [f"scale=1e{k}" for k in (-36, -30, -20, -9, -3, 0, 2, 7,
                                           15, 30, 37)])


@pytest.mark.parametrize("case", ALIGN_CASES)
@pytest.mark.parametrize("mag_bits", [23, 12])
def test_align_bit_identical(case, mag_bits):
    x = _align_input(case)
    jm, js, je = jal.align_encode(jnp.asarray(x), mag_bits)
    m, s, e = al.align_encode(torch.from_numpy(x), mag_bits)
    assert np.array_equal(bits(m), bits(jm))
    assert np.array_equal(bits(s), bits(js))
    assert int(e) == int(je)
    for kept in (None, 1, 5, mag_bits):
        tail = mag_bits - (mag_bits if kept is None else kept)
        jmt = (np.asarray(jm) >> tail) << tail
        want = jal.align_decode(jnp.asarray(jmt), js, je, mag_bits,
                                planes_kept=kept)
        got = al.align_decode(torch.from_numpy(jmt.view(np.int32)), s,
                              int(e), mag_bits, planes_kept=kept)
        assert np.array_equal(bits(got), bits(want)), kept
        assert al.truncation_error(int(e), kept or mag_bits, mag_bits) == \
            jal.truncation_error(int(je), kept or mag_bits, mag_bits)


OVERFLOW_CASES = {
    # |x| just below 2**e rounds up to 2**Bm (the fault recorded in ROADMAP)
    "recorded": np.array([1023.99994, 511.99997, -1023.99994], np.float32),
    "below_4": np.array([np.nextafter(np.float32(4), np.float32(0)), 1.0],
                        np.float32),
    "power_of_two": np.array([4.0, -2.0, 1.0], np.float32),
    "random": _align_input("scale=1e0"),
    "empty": _align_input("empty"),
}


@pytest.mark.parametrize("case", list(OVERFLOW_CASES))
@pytest.mark.parametrize("mag_bits", [23, 12])
def test_overflow_flag_marks_exactly_the_reference_overflows(case, mag_bits):
    """``overflows`` is set exactly where the reference's magnitudes need a
    bit at or above ``mag_bits`` (which its planes then drop)."""
    x = OVERFLOW_CASES[case]
    jm, _, _ = jal.align_encode(jnp.asarray(x), mag_bits)
    want = bool((np.asarray(jm).astype(np.uint64) >> mag_bits).any())
    m, _, _ = al.align_encode(torch.from_numpy(x), mag_bits)
    assert bool(al.overflows(m, mag_bits)) == want
    if case in ("recorded", "below_4"):
        assert want
        with pytest.raises(al.MagnitudeOverflowError):
            al.check_fits([False, bool(al.overflows(m, mag_bits))], mag_bits,
                          case)


def test_scale_table_is_the_reference_exp2():
    """The port's scale values are the reference's exp2 of every integer
    exponent an alignment can ask for (including inf / flushed ends)."""
    ks = np.arange(-160, 200, dtype=np.int32)
    want = np.asarray(jax.jit(lambda k: jnp.exp2(k.astype(jnp.float32)))(
        jnp.asarray(ks)))
    got = al.exp2_int(torch.from_numpy(ks))
    assert np.array_equal(bits(got), want.view(np.uint32))


# --------------------------------------------------------------- decompose --

SHAPES = [(64,), (33, 47), (16, 20, 24), (1, 17), (0, 5), (5, 1, 9), (1,),
          (2, 3, 1), (), (9, 0, 4), (40, 2)]


@pytest.mark.parametrize("shape", SHAPES)
def test_decompose_recompose_bit_identical(shape):
    rng = np.random.default_rng(len(shape) * 31 + sum(shape))
    x = rng.normal(size=shape).astype(np.float32) * 3.0
    lv = jdc.num_levels(shape, min_size=4, max_levels=3)
    assert dc.num_levels(shape, min_size=4, max_levels=3) == lv
    assert dc.level_shapes(shape, lv) == jdc.level_shapes(shape, lv)
    jp = jdc.decompose(jnp.asarray(x), lv)
    tp = dc.decompose(torch.from_numpy(np.array(x)), lv)
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        assert np.array_equal(bits(b), bits(a))
    # recompose from identical (perturbed) pieces
    noisy = [np.asarray(p) + rng.normal(size=p.shape).astype(np.float32)
             * np.float32(1e-3) for p in jp]
    want = jdc.recompose([jnp.asarray(p) for p in noisy], shape, lv)
    got = dc.recompose([torch.from_numpy(p) for p in noisy], shape, lv)
    assert tuple(got.shape) == tuple(shape)
    assert np.array_equal(bits(got), bits(want))
    # the staged plan (what the incremental engine runs) stage by stage
    cur_j = jnp.asarray(noisy[0]).reshape(jdc.level_shapes(shape, lv)[-1])
    cur_t = torch.from_numpy(noisy[0]).reshape(dc.level_shapes(shape, lv)[-1])
    jplan = jdc.recompose_plan(shape, lv)
    tplan = dc.recompose_plan(shape, lv, torch.device("cpu"))
    for i, ((js, jm), (ts, tm)) in enumerate(zip(jplan, tplan)):
        assert js == ts
        cur_j = jm(cur_j, jnp.asarray(noisy[i + 1]))
        cur_t = tm(cur_t, torch.from_numpy(noisy[i + 1]))
        assert np.array_equal(bits(cur_t), bits(cur_j)), i


def test_error_bound_and_field_generator_match():
    eps = [1e-3, 2e-4, 5e-5]
    assert dc.error_bound(eps, 3, 2.5) == jdc.error_bound(eps, 3, 2.5)
    a = fields.gaussian_field((12, 10, 6), slope=-2.0, seed=4)
    b = jfields.gaussian_field((12, 10, 6), slope=-2.0, seed=4)
    assert np.array_equal(a, b)


# ---------------------------------------------------------------- lossless --

CASES = {
    "skewed": lambda rng: (rng.geometric(0.25, 30000) % 256).astype(np.uint8),
    "zeros": lambda rng: np.zeros(40000, np.uint8),
    "uniform": lambda rng: rng.integers(0, 256, 30000).astype(np.uint8),
    "runs": lambda rng: np.repeat(rng.integers(0, 5, 60),
                                  rng.integers(1, 3000, 60)).astype(np.uint8),
    "long_run": lambda rng: np.zeros(70000, np.uint8),
    "tiny": lambda rng: rng.integers(0, 256, 3).astype(np.uint8),
    "empty": lambda rng: np.zeros(0, np.uint8),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("codec", ["huffman", "rle", "dc", "hybrid",
                                   "force_huffman", "force_rle", "force_dc"])
def test_lossless_segments_identical(case, codec):
    data = CASES[case](np.random.default_rng(1))
    if codec == "hybrid":
        a, b = jll.compress_group(data), ll.compress_group(data, device="cpu")
    elif codec.startswith("force_"):
        f = codec.split("_")[1]
        a = jll.compress_group(data, jll.HybridConfig(force=f))
        b = ll.compress_group(data, ll.HybridConfig(force=f), device="cpu")
    elif codec == "dc":
        a, b = jll.dc_encode(data), ll.dc_encode(data)
    else:
        a = getattr(jll, f"{codec}_encode")(data)
        b = getattr(ll, f"{codec}_encode")(data, device="cpu")
    assert b.to_bytes() == a.to_bytes()
    # each side decodes the other's segment
    out_t = ll.decompress_group(ll.Segment.from_bytes(a.to_bytes()),
                                device="cpu")
    out_j = jll.decompress_group(jll.Segment.from_bytes(b.to_bytes()))
    assert np.array_equal(out_t, data) and np.array_equal(out_j, data)


def test_codebook_and_estimators_identical():
    rng = np.random.default_rng(2)
    for data in [(rng.geometric(0.3, 50000) % 256).astype(np.uint8),
                 rng.integers(0, 256, 9000).astype(np.uint8),
                 np.zeros(100, np.uint8)]:
        hist = np.bincount(data, minlength=256)
        for x, y in zip(ll.build_codebook(hist), jll.build_codebook(hist)):
            assert np.array_equal(x, y)
        assert ll.estimate_huffman(hist, data.size)[0] == \
            jll.estimate_huffman(hist, data.size)[0]
    for m in ("dc", "huffman", "rle"):
        assert ll.exact_stored_bytes(m, 5000, 7000, 31) == \
            jll.exact_stored_bytes(m, 5000, 7000, 31)
    assert ll.MAX_GROUP_SYMS == jll.MAX_GROUP_SYMS


@pytest.mark.parametrize("force", [None, "huffman", "rle"])
def test_batched_engine_identical_and_counts_syncs(force):
    """``encode_groups`` / ``encode_groups_stacked`` / ``decode_segments``
    against the reference engine: same segment bytes, same decoded blobs,
    two host syncs per encode call and one per decode call."""
    rng = np.random.default_rng(8)
    blobs = [CASES[c](rng) for c in ("skewed", "zeros", "uniform", "runs",
                                     "tiny", "empty")]
    blobs += [(rng.geometric(0.4, 30000) % 7).astype(np.uint8)]
    cfg_j = jll.HybridConfig(force=force)
    cfg_t = ll.HybridConfig(force=force)
    want = jlb.encode_groups([jnp.asarray(b) for b in blobs], cfg_j)
    with lb.stats_scope() as st:
        got = lb.encode_groups(blobs, cfg_t, device="cpu")
        assert st.host_syncs == 2
    assert [s.to_bytes() for s in got] == [s.to_bytes() for s in want]
    same = [b for b in blobs if b.size == 30000]
    stacked = lb.encode_groups_stacked(
        [torch.from_numpy(np.stack(same))], cfg_t)
    assert [s.to_bytes() for s in stacked] == \
        [s.to_bytes() for s in jlb.encode_groups([jnp.asarray(b)
                                                  for b in same], cfg_j)]
    with lb.stats_scope() as st:
        dec = lb.decode_segments(want, device="cpu")
        assert st.host_syncs == (1 if any(s.method != "dc" for s in want)
                                 else 0)
    for d, b in zip(dec, blobs):
        assert np.array_equal(d, b)


def test_group_stats_device_pass_matches_host_twin():
    rng = np.random.default_rng(4)
    rows = np.stack([(rng.geometric(0.2, 70000) % 256).astype(np.uint8),
                     np.zeros(70000, np.uint8)])
    h_dev, n_dev = lb._group_stats_batch(torch.from_numpy(rows))
    h_host, n_host = lb._group_stats_host(rows)
    assert np.array_equal(h_dev.numpy(), h_host)
    assert np.array_equal(n_dev.numpy(), n_host)
    h_ref, n_ref = jlb._group_stats_batch(jnp.asarray(rows))
    assert np.array_equal(h_host, np.asarray(h_ref))
    assert np.array_equal(n_host, np.asarray(n_ref))
