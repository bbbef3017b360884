"""Bitplane formats of the PyTorch port vs the JAX reference.

The port's plain versions (``repro_torch.kernels.ref``) and dispatch ops
(``repro_torch.kernels.ops``) must be bit-identical to the reference's jnp
oracle, its numpy twin and its Pallas kernels in interpret mode.  Exact
equality everywhere.  The CUDA kernels themselves need the card: their tests
are in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

torch.set_num_threads(1)

DESIGNS = ["register_block", "locality", "shuffle"]


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("n", [1, 100, 4096, 5000, 12289])
@pytest.mark.parametrize("planes", [1, 7, 30, 32])
def test_plain_matches_reference(design, n, planes):
    rng = np.random.default_rng(n + planes)
    mag = rng.integers(0, 2 ** planes, n, dtype=np.uint64).astype(np.uint32)
    p = ops.encode_bitplanes(mag, planes, design, device="cpu")
    want = np.asarray(jref.encode(jnp.asarray(mag), planes, design))
    assert np.array_equal(u32(p), want)
    assert np.array_equal(u32(p), jref.encode_np(mag, planes, design))
    assert np.array_equal(ref.encode_np(mag, planes, design), want)
    assert p.shape[1] == ref.padded_words(n) == jref.padded_words(n)
    k = max(planes // 2, 1)
    dec = ops.decode_bitplanes(p[:k], planes, n, design, device="cpu")
    dec_ref = np.asarray(jref.decode(jnp.asarray(want[:k]), planes, n, design))
    assert np.array_equal(u32(dec), dec_ref)
    full = ops.decode_bitplanes(p, planes, n, design, device="cpu")
    assert np.array_equal(u32(full), mag)


@pytest.mark.parametrize("design", DESIGNS)
def test_prefix_is_truncation(design):
    rng = np.random.default_rng(7)
    n = 4500
    mag = rng.integers(0, 2 ** 30, n).astype(np.uint32)
    planes = ops.encode_bitplanes(mag, 30, design, device="cpu")
    for p in [1, 4, 17, 30]:
        dec = u32(ops.decode_bitplanes(planes[:p], 30, n, design,
                                       device="cpu"))
        assert np.array_equal(dec, (mag >> (30 - p)) << (30 - p)), p


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
def test_batch_and_offset_forms_match_reference(design, backend):
    """(B, N) batch encode, (B, P, W) batch decode and the plane-offset forms
    against ``repro.kernels.ops`` (jnp oracle and Pallas interpret; the
    interpreted kernels run a smaller case to stay fast)."""
    rng = np.random.default_rng(11)
    if backend == "jnp":
        b, n, total, cases = 3, 5000, 23, [(0, 4), (4, 4), (20, 3)]
    else:
        b, n, total, cases = 2, 5000, 8, [(0, 4), (4, 4)]
    kw = dict(backend=backend, tiles_per_block=1)
    mags = rng.integers(0, 2 ** total, (b, n)).astype(np.uint32)
    enc = ops.encode_bitplanes_batch(mags, total, design, device="cpu")
    want = np.asarray(jops.encode_bitplanes_batch(
        jnp.asarray(mags), total, design, **kw))
    assert np.array_equal(u32(enc), want)
    for off, rows in cases:
        sl = want[:, off:off + rows]
        got = ops.decode_bitplanes_offset_batch(sl, total, n, off, design,
                                                device="cpu")
        exp = jops.decode_bitplanes_offset_batch(
            jnp.asarray(sl), total, n, off, design, **kw)
        assert np.array_equal(u32(got), np.asarray(exp)), (off, rows)
        one = ops.decode_bitplanes_offset(sl[1], total, n, off, design,
                                          device="cpu")
        assert np.array_equal(u32(one), np.asarray(exp)[1])
    dec = ops.decode_bitplanes_batch(want, total, n, design, device="cpu")
    assert np.array_equal(u32(dec), mags)


@pytest.mark.parametrize("design", DESIGNS)
def test_offset_slices_or_to_full_decode(design):
    """Decoding disjoint plane groups at their offsets and OR-ing them
    reproduces the full-stack decode exactly (the incremental read path)."""
    rng = np.random.default_rng(5)
    n, total = 9000, 23
    mag = rng.integers(0, 2 ** total, n).astype(np.uint32)
    planes = ops.encode_bitplanes(mag, total, design, device="cpu")
    acc = torch.zeros(n, dtype=torch.int32)
    for off in range(0, total, 4):
        acc |= ops.decode_bitplanes_offset(planes[off:off + 4], total, n, off,
                                           design, device="cpu")
    assert np.array_equal(u32(acc), mag)


@pytest.mark.parametrize("unroll", ["naive", "butterfly"])
@pytest.mark.parametrize("tiles_per_block", [1, 4, 8])
def test_kernel_knobs_do_not_change_plain_output(unroll, tiles_per_block):
    rng = np.random.default_rng(29)
    n, planes = 13000, 10
    mag = rng.integers(0, 2 ** planes, n).astype(np.uint32)
    enc = ops.encode_bitplanes(mag, planes, tiles_per_block=tiles_per_block,
                               unroll=unroll, device="cpu")
    assert np.array_equal(u32(enc), jref.encode_np(mag, planes))
    dec = ops.decode_bitplanes(enc[:7], planes, n,
                               tiles_per_block=tiles_per_block,
                               unroll=unroll, device="cpu")
    assert np.array_equal(u32(dec), (mag >> 3) << 3)


def test_numpy_and_torch_inputs_agree():
    rng = np.random.default_rng(3)
    mag = rng.integers(0, 2 ** 32, 7000, dtype=np.uint64).astype(np.uint32)
    a = ops.encode_bitplanes(mag, 32, device="cpu")
    b = ops.encode_bitplanes(torch.from_numpy(mag.view(np.int32)), 32,
                             device="cpu")
    c = ops.encode_bitplanes(torch.from_numpy(mag.astype(np.int64)), 32,
                             device="cpu")
    assert torch.equal(a, b) and torch.equal(a, c)
    assert a.dtype == torch.int32


def test_backend_rules_on_cpu():
    mag = np.arange(100, dtype=np.uint32)
    with pytest.raises(ValueError):
        ops.encode_bitplanes(mag, 8, backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        ops.encode_bitplanes(mag, 8, backend="pallas", device="cpu")
    with pytest.raises(ValueError):
        ops.encode_bitplanes(mag, 8, design="nope", device="cpu")
    with pytest.raises(ValueError):
        ops.encode_bitplanes(mag, 33, device="cpu")
    with pytest.raises(ValueError):
        ops.decode_bitplanes(np.zeros((2, 128), np.uint32), 8, 4097,
                             device="cpu")
    # 'torch' is the plain version by explicit choice, on any device
    assert torch.equal(ops.encode_bitplanes(mag, 8, backend="torch",
                                            device="cpu"),
                       ops.encode_bitplanes(mag, 8, device="cpu"))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError):
        ops.encode_bitplanes(np.arange(10, dtype=np.uint32), 4)
    with pytest.raises(RuntimeError):
        ops.decode_bitplanes(np.zeros((1, 128), np.uint32), 4, 10)


def test_module_import_builds_nothing():
    from repro_torch.kernels import bitplane as bp
    assert not bp._libs or torch.cuda.is_available()
    assert bp.encode_register_block_cuda.launches >= 0


@pytest.mark.parametrize("mangled,want", [
    ("_ZN12_GLOBAL__N_112stats_kernelEPKhxiiPyS2_S2_",
     "(anonymous namespace)::stats_kernel"),
    ("_ZN12_GLOBAL__N_118huff_decode_kernelILb1EEEvPKjx",
     "(anonymous namespace)::huff_decode_kernel"),
    ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIiEE",
     "at::native::vectorized_elementwise_kernel"),
    ("_Z13rb_encode_ker", "rb_encode_ker"),
    ("rle_expand_kernel", "rle_expand_kernel"),
])
def test_device_activity_names(mangled, want):
    """``device_activities`` names a kernel node by its nested
    identifiers; a name that is not mangled stays as it is."""
    from repro_torch.kernels import bitplane as bp
    assert bp.demangle(mangled) == want
