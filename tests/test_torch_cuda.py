"""Card-only tests of the PyTorch port (``cuda`` marker; skip without a card).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only torch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The CUDA kernels are held bit-exact against their plain torch versions, and
the whole port on the card against the port on the CPU (which the other
``tests/test_torch_*.py`` files hold against the reference).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import lossless_batch as lb  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core import qoi as qq  # noqa: E402
from repro_torch.core import refactor as rf  # noqa: E402
from repro_torch.core import retrieve as rt  # noqa: E402
from repro_torch.core import sharded as shd  # noqa: E402
from repro_torch.data.fields import gaussian_field, velocity_field  # noqa: E402
from repro_torch.kernels import bitplane as bp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_kernels_match_plain(cuda):
    rng = np.random.default_rng(1)
    for n, p, b in [(1, 1, 1), (4095, 7, 1), (4097, 23, 3), (12289, 32, 2)]:
        mags = rng.integers(0, 2 ** 32, (b, n), dtype=np.uint64
                            ).astype(np.uint32)
        x = torch.from_numpy(mags.view(np.int32)).to(cuda)
        before = bp.encode_register_block_cuda.launches
        got = ops.encode_bitplanes_batch(x, p, device=cuda)
        assert bp.encode_register_block_cuda.launches == before + 1
        assert torch.equal(got.cpu(), ref.encode(x.cpu(), p))
        for off in (0, min(4, p - 1)):
            sl = got[:, off:].contiguous()
            dec = ops.decode_bitplanes_offset_batch(sl, p, n, off,
                                                    device=cuda)
            assert torch.equal(dec.cpu(), ref.decode(sl.cpu(), p - off, n))


ENCODERS = {"locality": bp.encode_locality_cuda,
            "shuffle": bp.encode_shuffle_cuda}


@pytest.mark.parametrize("design", ["locality", "shuffle"])
def test_locality_and_shuffle_kernels_match_plain(cuda, design):
    """Each design encodes through its own kernel and decodes through
    ``loc_decode``; both are bit-exact against the plain version, batch and
    plane-offset forms included."""
    rng = np.random.default_rng(2)
    enc = ENCODERS[design]
    for n, p, b in [(1, 1, 1), (31, 5, 2), (4095, 7, 1), (4097, 23, 3),
                    (12289, 32, 2)]:
        mags = rng.integers(0, 2 ** 32, (b, n), dtype=np.uint64
                            ).astype(np.uint32)
        x = torch.from_numpy(mags.view(np.int32)).to(cuda)
        e0, d0 = enc.launches, bp.decode_locality_cuda.launches
        got = ops.encode_bitplanes_batch(x, p, design, device=cuda)
        assert enc.launches == e0 + 1
        want = ref.encode_locality(x.cpu(), p)
        assert torch.equal(got.cpu(), want)
        for off in sorted({0, min(4, p - 1), min(20, p - 1)}):
            sl = got[:, off:].contiguous()
            dec = ops.decode_bitplanes_offset_batch(sl, p, n, off, design,
                                                    device=cuda)
            assert torch.equal(dec.cpu(),
                               ref.decode_locality(sl.cpu(), p - off, n))
        assert bp.decode_locality_cuda.launches > d0
    # the plain version stays an explicit choice
    x = torch.arange(100, dtype=torch.int32, device=cuda)
    assert torch.equal(
        ops.encode_bitplanes(x, 8, design, backend="torch", device=cuda).cpu(),
        ops.encode_bitplanes(x.cpu(), 8, design, device="cpu"))


DECODE_ROWS = (1, 2, 3, 4, 5, 8, 9, 16, 17, 31, 32)


@pytest.mark.parametrize("encoder", [bp.encode_shuffle_cuda,
                                     bp.encode_locality_cuda],
                         ids=["shuffle_encode", "loc_encode"])
@pytest.mark.parametrize("n", [4096 + 1000 + 17, 4096 + 2048],
                         ids=["ends-mid-warp", "ends-mid-cta"])
@pytest.mark.parametrize("p", [1, 8, 9, 31, 32])
def test_shuffle_encode_and_loc_decode_at_layout_edges(cuda, p, n, encoder):
    """The kernels built on a 32x32 bit transpose within a warp's words (both
    warp encoders and ``loc_decode``), held against the plain versions at
    the edges of their layout: 1, 31 and 32 planes, 8 and 9 on either side
    of ``loc_encode``'s direct-gather bound (``kDirectPlanes``), every row
    count at the edge of a row bucket, a batch of 3 with plane offsets, and
    a length that ends inside a warp's 1,024 elements or at a warp boundary
    inside a CTA's 4,096."""
    rng = np.random.default_rng(p + n)
    mags = rng.integers(0, 2 ** 32, (3, n), dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(mags.view(np.int32)).to(cuda)
    want = ref.encode_locality(x.cpu(), p)
    before = encoder.launches
    got = encoder(x, p)
    assert encoder.launches == before + 1
    assert torch.equal(got.cpu(), want)
    for off in sorted({0, min(4, p - 1), min(20, p - 1)}):
        for rows in sorted({r for r in DECODE_ROWS if r < p - off}
                           | {p - off}):
            sl = got[:, off:off + rows].contiguous()
            before = bp.decode_locality_cuda.launches
            dec = bp.decode_locality_cuda(sl, p - off, n)
            assert bp.decode_locality_cuda.launches == before + 1
            assert torch.equal(dec.cpu(),
                               ref.decode_locality(sl.cpu(), p - off, n))


@pytest.mark.parametrize("wrapper", [bp.encode_locality_cuda,
                                     bp.encode_shuffle_cuda])
def test_new_encoders_reject_what_the_kernel_does_not_take(cuda, wrapper):
    x = torch.zeros((2, 300), dtype=torch.int32, device=cuda)
    for bad, err in [((x, 33), ValueError), ((x, 0), ValueError),
                     ((x[:, ::2], 8), ValueError),
                     ((x.to(torch.int64), 8), TypeError),
                     ((x[0], 8), ValueError), ((x.cpu(), 8), ValueError)]:
        before = wrapper.launches
        with pytest.raises(err):
            wrapper(*bad)
        assert wrapper.launches == before


@pytest.mark.parametrize("wrapper", bp.WRAPPERS, ids=lambda w: w.__name__)
def test_empty_calls_launch_and_count_nothing(cuda, wrapper):
    """A count is a launch: a call with nothing to do returns an empty
    tensor of the right shape and leaves ``launches`` as it was."""
    before = wrapper.launches
    if wrapper in (bp.decode_register_block_cuda, bp.decode_locality_cuda):
        planes = torch.zeros((0, 4, 128), dtype=torch.int32, device=cuda)
        assert wrapper(planes, 23, 100).shape == (0, 100)
        planes = torch.zeros((2, 4, 128), dtype=torch.int32, device=cuda)
        assert wrapper(planes, 23, 0).shape == (2, 0)
    else:
        mags = torch.zeros((0, 300), dtype=torch.int32, device=cuda)
        assert wrapper(mags, 8).shape == (0, 8, 128)
        mags = torch.zeros((2, 0), dtype=torch.int32, device=cuda)
        assert wrapper(mags, 8).shape == (2, 8, 0)
    assert wrapper.launches == before


def test_locality_decoder_rejects_what_the_kernel_does_not_take(cuda):
    dec = bp.decode_locality_cuda
    z = torch.zeros((1, 4, 128), dtype=torch.int32, device=cuda)
    for args, err in [((z, 3, 100), ValueError), ((z, 33, 100), ValueError),
                      ((z, 4, 32 * 128 + 1), ValueError),
                      ((z[:, :, :100].contiguous(), 4, 100), ValueError),
                      ((z.to(torch.int64), 4, 100), TypeError),
                      ((z[0], 4, 100), ValueError),
                      ((z.cpu(), 4, 100), ValueError)]:
        with pytest.raises(err):
            dec(*args)


def test_wrappers_reject_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 300), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        bp.encode_register_block_cuda(x, 33)
    with pytest.raises(ValueError):
        bp.encode_register_block_cuda(x, 0)
    with pytest.raises(ValueError):
        bp.encode_register_block_cuda(x[:, ::2], 8)
    with pytest.raises(TypeError):
        bp.encode_register_block_cuda(x.to(torch.int64), 8)
    with pytest.raises(ValueError):
        bp.decode_register_block_cuda(torch.zeros((1, 5, 128),
                                                  dtype=torch.int32,
                                                  device=cuda), 4, 100)
    with pytest.raises(ValueError):
        bp.decode_register_block_cuda(torch.zeros((1, 4, 100),
                                                  dtype=torch.int32,
                                                  device=cuda), 4, 100)
    with pytest.raises(ValueError):
        bp.encode_register_block_cuda(x.cpu(), 8)


@pytest.mark.parametrize("shape", [(), (0,), (1, 5, 1), (33, 47),
                                   (16, 20, 24)])
@pytest.mark.parametrize("path", [{}, {"fused": False}, {"batched": False}])
def test_card_matches_cpu(cuda, shape, path):
    rng = np.random.default_rng(7)
    x = (gaussian_field(shape, seed=3) if np.prod(shape, dtype=int) > 100
         else rng.normal(size=shape).astype(np.float32))
    blobs = {d: rf.refactored_to_bytes(rf.refactor_array(
        x, "c", device=d, **path)) for d in (cuda, "cpu")}
    assert blobs[cuda] == blobs["cpu"]
    want = rt.ProgressiveReader(rf.refactored_from_bytes(blobs["cpu"]),
                                device="cpu")
    readers = [rt.ProgressiveReader(rf.refactored_from_bytes(blobs["cpu"]),
                                    device=cuda, incremental=inc)
               for inc in (True, False)]
    for tol in (1e-2, 1e-4, 1e-6):
        b = want.retrieve(tol, relative=True)
        for reader in readers:
            a = reader.retrieve(tol, relative=True)
            assert a[1:] == b[1:]
            assert a[0].tobytes() == b[0].tobytes()


def test_host_syncs_on_the_card(cuda):
    """3 host syncs per chunk on write and at most 1 per fetch on read, as
    the reference counts them; the kernels serve both sides."""
    x = gaussian_field((40, 36, 20), seed=5)
    enc0 = bp.encode_register_block_cuda.launches
    dec0 = bp.decode_register_block_cuda.launches
    with lb.stats_scope() as st:
        r = rf.refactor_array(x, "s", device=cuda)
    assert st.host_syncs == 3
    reader = rt.ProgressiveReader(r, device=cuda)
    for tol in (1e-2, 1e-5):
        with lb.stats_scope() as st:
            reader.retrieve(tol)
        assert st.host_syncs <= 1
    assert bp.encode_register_block_cuda.launches > enc0
    assert bp.decode_register_block_cuda.launches > dec0


@pytest.mark.parametrize("path", [{}, {"fused": False}, {"batched": False}])
def test_overflowing_magnitude_raises_on_the_card(cuda, path):
    x = np.array([1023.99994, 511.99997, -1023.99994], np.float32)
    with pytest.raises(ValueError, match="2\\*\\*23"):
        rf.refactor_array(x, "o", device=cuda, **path)


@pytest.mark.parametrize("design", ["register_block", "locality", "shuffle"])
def test_qoi_card_matches_cpu(cuda, design):
    """Algorithm 3 on the card gives the CPU's result exactly: the same
    iterations, bytes, bounds and bit-identical values."""
    vs = list(velocity_field((16, 18, 20), seed=2))
    refs = [rf.refactor_array(v, f"v{i}", design=design, device="cpu")
            for i, v in enumerate(vs)]
    for method in ("cp", "ma", "mape"):
        res = {}
        for d in (cuda, "cpu"):
            readers = [rt.ProgressiveReader(r, device=d) for r in refs]
            res[d] = [qq.progressive_qoi_retrieve(readers, qq.V_TOTAL, tau,
                                                  method=method)
                      for tau in (1e-2, 1e-4)]
        for a, b in zip(res[cuda], res["cpu"]):
            assert (a.iterations, a.bytes_fetched, a.converged,
                    a.tau_estimated, a.eps_final, a.per_iteration) == (
                b.iterations, b.bytes_fetched, b.converged,
                b.tau_estimated, b.eps_final, b.per_iteration)
            assert all(x.tobytes() == y.tobytes()
                       for x, y in zip(a.values, b.values))


@pytest.mark.parametrize("q", [qq.V_TOTAL, qq.QoI("magnitude"),
                               qq.QoI("linear", (2.0, -0.5, 3.0)),
                               qq.QoI("product")], ids=lambda q: q.kind)
def test_qoi_fields_card_match_cpu(cuda, q):
    """The QoI and its pointwise error bound are bit-identical on the card
    and the CPU, the magnitude's square roots included (float32 on the
    card, float64 rounded once on the CPU)."""
    rng = np.random.default_rng(5)
    n = 3 if q.kind != "product" else 2
    vs = [(rng.standard_normal(200_000) * 10.0 ** rng.uniform(
        -20, 20, 200_000)).astype(np.float32) for _ in range(n)]
    for eps in ([1e-3] * n, [1e-40] * n, [3e-7, 1e2, 0.0][:n]):
        a = qq.qoi_error_pointwise(vs, eps, q, device=cuda).cpu()
        b = qq.qoi_error_pointwise(vs, eps, q, device="cpu")
        assert a.numpy().tobytes() == b.numpy().tobytes()
    a = qq.qoi_value(vs, q, device=cuda).cpu()
    assert a.numpy().tobytes() == qq.qoi_value(vs, q, device="cpu"
                                               ).numpy().tobytes()


@pytest.mark.parametrize("design", ["register_block", "locality", "shuffle"])
def test_pipeline_card_matches_cpu(cuda, design):
    """Pipelined (pinned memory, side-stream uploads) and serial writes on
    the card give the CPU's chunk blobs; both read modes reconstruct the
    CPU's values bit for bit."""
    x = gaussian_field((32, 64, 64), seed=4)
    kw = dict(chunk_elems=1 << 14, design=design, use_tune_cache=False)
    want = pl.ChunkedRefactorPipeline(pipelined=False, device="cpu",
                                      **kw).refactor(x, "v")
    for piped in (True, False):
        got = pl.ChunkedRefactorPipeline(pipelined=piped, device=cuda,
                                         **kw).refactor(x, "v")
        assert got == want
    ref = pl.ChunkedReconstructPipeline(device="cpu").reconstruct(want, 1e-4)
    for piped in (True, False):
        out = pl.ChunkedReconstructPipeline(pipelined=piped,
                                            device=cuda).reconstruct(want,
                                                                     1e-4)
        assert out.tobytes() == ref.tobytes()


def test_round_robin_placement_on_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    x = gaussian_field((32, 64, 64), seed=6)
    kw = dict(chunk_elems=1 << 14, use_tune_cache=False)
    want = pl.ChunkedRefactorPipeline(device=cuda, **kw).refactor(x, "v")
    shd.STATS.reset()
    pipe = pl.ChunkedRefactorPipeline(mesh=2, **kw)
    assert pipe.refactor(x, "v") == want
    assert shd.STATS.snapshot()["dispatches_by_device"] == {0: 4, 1: 4}
    a = pl.ChunkedReconstructPipeline(mesh=2).reconstruct(want, 1e-4)
    b = pl.ChunkedReconstructPipeline(device=cuda).reconstruct(want, 1e-4)
    assert a.tobytes() == b.tobytes()


def test_store_and_shared_tier_card_match_cpu(cuda, tmp_path):
    """A store written on the card has the CPU write's segment bytes; four
    concurrent sessions served through the shared tier on the card get the
    CPU service's values, bounds and bytes, with launches shared across
    sessions."""
    import json
    import threading
    from repro_torch.store import DatasetStore, DatasetWriter, RetrievalService
    from repro_torch.store import layout as lo
    x = gaussian_field((40, 40, 40), slope=-2.0, seed=6)
    for dev in ("cuda", "cpu"):
        with DatasetWriter(str(tmp_path / dev), chunk_elems=16384,
                           use_tune_cache=False, device=dev) as w:
            w.write("v", x)

    def entry(root):
        with open(tmp_path / root / lo.MANIFEST_NAME) as f:
            v = json.load(f)["variables"]["v"]
        with open(lo.segment_path(str(tmp_path / root),
                                  v.pop("segment_file")), "rb") as f:
            return v, f.read()
    assert entry("cuda") == entry("cpu")
    cpu = RetrievalService(DatasetStore.open(str(tmp_path / "cpu"),
                                             device="cpu")).open_session()
    want = {tol: cpu.retrieve("v", tol) for tol in (1e-2, 1e-4)}
    svc = RetrievalService(DatasetStore.open(str(tmp_path / "cuda")))
    outs = [[] for _ in range(4)]
    barrier = threading.Barrier(4)

    def run(k):
        s = svc.open_session()
        barrier.wait(timeout=60)
        for tol in (1e-2, 1e-4):
            outs[k].append(s.retrieve("v", tol))

    bp.reset_launches()
    ts = [threading.Thread(target=run, args=(k,)) for k in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in ts)
    for out in outs:
        for (xa, ba, fa), tol in zip(out, (1e-2, 1e-4)):
            xb, bb, fb = want[tol]
            assert xa.tobytes() == xb.tobytes() and (ba, fa) == (bb, fb)
    tier = svc.stats()["serving"]
    assert 0 < bp.decode_register_block_cuda.launches < tier["decoded"]
