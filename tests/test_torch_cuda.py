"""Card-only tests of the PyTorch port (``cuda`` marker; skip without a card).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only torch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The CUDA kernels are held bit-exact against their plain torch versions, and
the whole port on the card against the port on the CPU (which the other
``tests/test_torch_*.py`` files hold against the reference).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _lossless_cases as cases  # noqa: E402
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


# ------------------------------------- sharded engines, tuner, ckpt (slice 6)

ONE_CARD_MESH = ["cuda:0"] * 4


@pytest.mark.parametrize("design", ["register_block", "locality", "shuffle"])
def test_sharded_ops_on_one_card_match_batch_op(cuda, design):
    """A mesh naming one card four times runs the split path on it: four
    batch launches, whose blocks are the batch op's rows bit for bit."""
    rng = np.random.default_rng(7)
    mags = torch.from_numpy(rng.integers(0, 2 ** 23, (8, 12289)
                                         ).astype(np.int32)).to(cuda)
    want = ops.encode_bitplanes_batch(mags, 23, design, device=cuda)
    bp.reset_launches()
    blocks = ops.encode_bitplanes_sharded(mags, 23, design,
                                          mesh=ONE_CARD_MESH)
    assert sum(w.launches for w in bp.WRAPPERS) == 4
    assert torch.equal(torch.cat(blocks), want)
    prefix = want[:, :8].contiguous()
    dec = ops.decode_bitplanes_sharded(prefix, 23, 12289, design,
                                       mesh=ONE_CARD_MESH)
    assert torch.equal(torch.cat(dec), ops.decode_bitplanes_batch(
        prefix, 23, 12289, design, device=cuda))
    with pytest.raises(ValueError, match="not divisible"):
        ops.encode_bitplanes_sharded(mags[:6], 23, mesh=ONE_CARD_MESH)


def test_sharded_engines_on_one_card_match_cpu(cuda):
    x = gaussian_field((20, 64, 64), seed=8).reshape(-1)
    chunks = [x[i:i + 16384] for i in range(0, x.size, 16384)]
    want = [rf.refactored_to_bytes(r) for r in shd.ShardedRefactorPlan(
        None, levels=2, device="cpu").refactor_chunks(chunks)]
    got = shd.ShardedRefactorPlan(ONE_CARD_MESH, levels=2).refactor_chunks(
        chunks)
    assert [rf.refactored_to_bytes(r) for r in got] == want
    eng = shd.ShardedReconstructEngine(ONE_CARD_MESH)
    readers = []
    for ci, blob in enumerate(want):
        ref = rf.refactored_from_bytes(blob)
        reader = rt.ProgressiveReader(ref, device=eng.device_for(ci))
        reader.engine = eng.engine_for(ci, ref)
        reader.stage_retrieve(1e-4)
        readers.append(reader)
    eng.drain([r.engine for r in readers])
    out = np.concatenate([r.reconstruct()[0].reshape(-1) for r in readers])
    ref_out = pl.ChunkedReconstructPipeline(device="cpu").reconstruct(want,
                                                                      1e-4)
    assert out.tobytes() == ref_out.tobytes()
    # the pipelines on the same mesh: the four entries share one side
    # stream for their uploads, each placement waited on by its own event
    piped = pl.ChunkedRefactorPipeline(chunk_elems=16384, levels=2,
                                       mesh=ONE_CARD_MESH,
                                       use_tune_cache=False).refactor(x)
    assert piped == pl.ChunkedRefactorPipeline(
        chunk_elems=16384, levels=2, use_tune_cache=False,
        device="cpu").refactor(x)
    out = pl.ChunkedReconstructPipeline(mesh=ONE_CARD_MESH).reconstruct(
        piped, 1e-4)
    assert out.tobytes() == pl.ChunkedReconstructPipeline(
        device="cpu").reconstruct(piped, 1e-4).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int32",
                                   "float64"])
def test_codec_card_matches_cpu(cuda, dtype):
    from repro_torch.ckpt import bitcast_codec as bc
    g = torch.Generator().manual_seed(3)
    if dtype == "int32":
        x = torch.randint(-2 ** 31, 2 ** 31, (20000,), generator=g,
                          dtype=torch.int64).to(torch.int32)
    else:
        x = (torch.randn(20000, generator=g, dtype=torch.float64)
             * 2.0 ** torch.randint(-30, 30, (20000,), generator=g)
             ).to(bc.TORCH_DTYPES[dtype])
    bp.reset_launches()
    card = bc.exact_refactor(x.to(cuda))
    assert bp.encode_register_block_cuda.launches == (2 if dtype == "float64"
                                                      else 1)
    blob = bc.exact_to_bytes(card)
    assert blob == bc.exact_to_bytes(bc.exact_refactor(x, device="cpu"))
    for rel in (1e-2, None):
        a, na = bc.exact_retrieve(bc.exact_from_bytes(blob), rel)
        b, nb = bc.exact_retrieve(bc.exact_from_bytes(blob), rel,
                                  device="cpu")
        assert a.device.type == "cuda" and na == nb
        assert torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8))
    assert torch.equal(a.cpu(), x)


def test_tune_on_the_card_then_cache_hit(cuda, tmp_path):
    from repro_torch.tune import search as ts
    ts.STATS.reset()
    r1 = ts.tune((1 << 16,), levels=2, cache_root=tmp_path)
    assert not r1.cache_hit and not r1.failures
    assert ts.STATS.snapshot()["probes_failed"] == 0
    assert ts.STATS.snapshot()["scores_failed"] == 0
    assert len(r1.scores) == 9 and all(s > 0 for _, s in r1.scores)
    assert len(r1.probes) == 4 and r1.model_scale > 0
    assert min(s for _, s in r1.probes) <= r1.probes[0][1]
    r2 = ts.tune((1 << 16,), levels=2, cache_root=tmp_path)
    assert r2.cache_hit and r2.config == r1.config
    assert ts.STATS.snapshot()["searches"] == 1


def test_checkpoint_moves_between_card_and_cpu(cuda, tmp_path):
    from repro_torch.ckpt import manager as ck
    g = torch.Generator().manual_seed(5)
    tree = {"w": torch.randn(256, 64, generator=g),
            "h": [torch.randn(4096, generator=g).to(torch.bfloat16)],
            "b": torch.randn(16, generator=g), "step": torch.tensor(7)}
    card_tree = {"w": tree["w"].to(cuda), "h": [tree["h"][0].to(cuda)],
                 "b": tree["b"].to(cuda), "step": tree["step"].to(cuda)}
    ck.save(tmp_path / "card", 7, card_tree)
    ck.save(tmp_path / "cpu", 7, tree, device="cpu")
    for name in ("w.mdr", "h.0.mdr", "b.raw", "step.raw"):
        assert ((tmp_path / "card" / "step_00000007" / name).read_bytes()
                == (tmp_path / "cpu" / "step_00000007" / name).read_bytes())
    on_cpu, _ = ck.load(tmp_path / "card", 7, tree, device="cpu")
    on_card, _ = ck.load(tmp_path / "cpu", 7, tree)
    for a, b, want in zip((on_cpu["w"], on_cpu["h"][0], on_cpu["step"]),
                          (on_card["w"], on_card["h"][0], on_card["step"]),
                          (tree["w"], tree["h"][0], tree["step"])):
        assert a.device.type == "cpu" and b.device.type == "cuda"
        assert torch.equal(a, want) and torch.equal(b.cpu(), want)


def test_sharded_engines_and_ops_across_cards(cuda):
    """Chunks round-robin over every card: the same blobs and values as the
    CPU, and the sharded ops' blocks, one per card, are the batch op's
    rows."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    mesh = shd.make_chunk_mesh()
    x = gaussian_field((20, 64, 64), seed=9).reshape(-1)
    chunks = [x[i:i + 8192] for i in range(0, x.size, 8192)]
    want = [rf.refactored_to_bytes(r) for r in shd.ShardedRefactorPlan(
        None, levels=2, device="cpu").refactor_chunks(chunks)]
    shd.STATS.reset()
    got = shd.ShardedRefactorPlan(mesh, levels=2).refactor_chunks(chunks)
    assert [rf.refactored_to_bytes(r) for r in got] == want
    assert set(shd.STATS.snapshot()["dispatches_by_device"]) == set(
        range(len(mesh)))
    eng = shd.ShardedReconstructEngine(mesh)
    readers = []
    for ci, blob in enumerate(want):
        ref = rf.refactored_from_bytes(blob)
        reader = rt.ProgressiveReader(ref, device=eng.device_for(ci))
        reader.engine = eng.engine_for(ci, ref)
        reader.stage_retrieve(1e-4)
        readers.append(reader)
    eng.drain([r.engine for r in readers])
    out = np.concatenate([r.reconstruct()[0].reshape(-1) for r in readers])
    assert out.tobytes() == pl.ChunkedReconstructPipeline(
        device="cpu").reconstruct(want, 1e-4).tobytes()
    rng = np.random.default_rng(11)
    mags = rng.integers(0, 2 ** 23, (2 * len(mesh), 12289)).astype(np.int32)
    want_planes = ops.encode_bitplanes_batch(mags, 23, device="cpu")
    blocks = ops.encode_bitplanes_sharded(mags, 23, mesh=mesh)
    assert [b.device for b in blocks] == mesh
    assert torch.equal(torch.cat([b.cpu() for b in blocks]), want_planes)
    dec = ops.decode_bitplanes_sharded(want_planes[:, :8].contiguous(), 23,
                                       12289, mesh=mesh)
    assert torch.equal(torch.cat([d.cpu() for d in dec]),
                       ops.decode_bitplanes_batch(
                           want_planes[:, :8].contiguous(), 23, 12289,
                           device="cpu"))


# ------------------------------------------------- the LLM serving path --

# card against CPU, float32 compute (TF32 off): relative to max|logit|;
# jamba's Mamba state reaches 1e7 at its smoke size, so float32 rounding
# differences grow through its 8 layers (tests/_torch_model_oracle.py)
SERVE_TOL = {"jamba-v0.1-52b": 1e-3}


def _close_rel(a, b, tol):
    a, b = a.double().cpu(), b.double().cpu()
    assert a.shape == b.shape
    err, top = (a - b).abs().max().item(), a.abs().max().item()
    assert err <= tol * top, (err, top)


@pytest.mark.parametrize("arch", [
    "rwkv6-3b", "deepseek-67b", "h2o-danube-3-4b", "command-r-plus-104b",
    "qwen2-7b", "hubert-xlarge", "jamba-v0.1-52b", "deepseek-v2-236b",
    "deepseek-v3-671b", "llama-3.2-vision-90b"])
def test_smoke_models_on_the_card_match_the_cpu(cuda, arch):
    """One ``tree_init`` on the CPU, copied to the card: logits within the
    tolerance, the greedy driver's tokens equal, and prefill(x[:-1]) +
    decode_step(x[-1]) against forward(x) on the card."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.launch import driver
    from repro_torch.models.model import Model
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = smoke_config(arch)
    tol = SERVE_TOL.get(arch, 1e-4)
    cpu = Model(cfg, device="cpu", seed=0)
    card = Model(cfg, cpu.params, device=cuda)
    with torch.inference_mode():
        if cfg.encoder_only:
            emb = torch.randn(2, 24, cfg.d_model,
                              generator=torch.Generator().manual_seed(1))
            _close_rel(cpu.forward(None, embeds=emb),
                       card.forward(None, embeds=emb.to(cuda)), tol)
            return
        toks, vis = driver.build_inputs(cfg, 2, 24, seed=1, device="cpu")
        vis_c = None if vis is None else vis.to(cuda)
        full = card.forward(None, tokens=toks.to(cuda), vision_states=vis_c)
        _close_rel(cpu.forward(None, tokens=toks, vision_states=vis), full,
                   tol)
        _, cache = card.prefill(None, tokens=toks[:, :-1].to(cuda),
                                vision_states=vis_c, max_len=28)
        out, _ = card.decode_step(None, cache, 23, toks[:, -1:].to(cuda),
                                  vision_states=vis_c)
        _close_rel(full[:, -1], out[:, 0], tol)
    a = driver.greedy_decode(cpu, None, toks[:, :8], 6, vis)
    b = driver.greedy_decode(card, card.compute_params(),
                             toks[:, :8].to(cuda), 6, vis_c)
    assert torch.equal(a.tokens, b.tokens.cpu())
    _close_rel(a.logits, b.logits, tol)


# ------------------------------------------------------------------ training --

def _ef_launches():
    return {k: bp.launches()[k] for k in ("ef_amax", "ef_apply",
                                          "rb_encode", "rb_decode")}


@pytest.mark.parametrize("n", [1, 4095, 4097, 100_003])
@pytest.mark.parametrize("planes", [1, 8, 23])
def test_ef_quantize_on_the_card_equals_the_plain_path(cuda, n, planes):
    """``ef_quantize`` on the card through ``ef_amax`` and ``ef_apply`` (one
    launch of each a call, none of ``rb_encode``/``rb_decode``) against its
    plain path on the card (the planes encoded and decoded by the plain
    versions), bit for bit, and against the CPU."""
    from repro_torch.distributed.grad_compress import ef_quantize
    g = torch.Generator(device=cuda).manual_seed(n + planes)
    x = torch.randn(n, generator=g, device=cuda)
    r = torch.randn(n, generator=g, device=cuda) * 1e-3
    before = _ef_launches()
    q, nr = ef_quantize(x, r, planes)
    after = _ef_launches()
    assert after == dict(before, ef_amax=before["ef_amax"] + 1,
                         ef_apply=before["ef_apply"] + 1)
    qp, nrp = ef_quantize(x, r, planes, backend="torch")
    assert _ef_launches() == after
    assert torch.equal(q.view(torch.int32), qp.view(torch.int32))
    assert torch.equal(nr.view(torch.int32), nrp.view(torch.int32))
    qc, nrc = ef_quantize(x.cpu(), r.cpu(), planes)
    assert torch.equal(q.cpu().view(torch.int32), qc.view(torch.int32))
    assert torch.equal(nr.cpu().view(torch.int32), nrc.view(torch.int32))


# +-0, subnormals, +-inf and NaN, sprinkled at a stride through a leaf
OPT_SPECIALS = [0.0, -0.0, 1e-39, -1e-39, 1e-45, -3e-40, math.inf,
                -math.inf, math.nan, 3.0]


def _sprinkle(x, vals):
    for i, v in enumerate(vals):
        x[i::len(vals) * 7] = v
    return x


def _ef_leaf(kind, n, seed=0):
    """A gradient leaf and a residual (numpy float32): normal values, or
    the special cases the kernels must keep bit-identical."""
    rng = np.random.default_rng(seed + n)
    x = rng.normal(size=n).astype(np.float32)
    r = (rng.normal(size=n) * 1e-3).astype(np.float32)
    if kind == "specials":
        x = _sprinkle(x, OPT_SPECIALS)
        r = _sprinkle(r, OPT_SPECIALS[::-1])
    elif kind == "zeros":
        x, r = np.zeros(n, np.float32), np.zeros(n, np.float32)
        x[::3] = -0.0
    elif kind == "inf_scale":       # max|total| below 2**-105: scale inf
        x = (x * 2.0 ** -112).astype(np.float32)
        r = (r * 2.0 ** -112).astype(np.float32)
        x[0] = 2.0 ** -106
    elif kind == "saturate":        # the largest value rounds to 2**23
        x = rng.uniform(-1, 1, size=n).astype(np.float32)
        r = np.zeros(n, np.float32)
        x[0] = np.nextafter(np.float32(2), np.float32(0))
        x[-1] = -x[0]
    elif kind == "saturate_u32":    # inf totals saturate the magnitude
        x[::5] = np.inf
    return x, r


def _bits_equal(a, b, nan_as_nan=False):
    a, b = a.cpu(), b.cpu()
    if nan_as_nan:
        na, nb = torch.isnan(a), torch.isnan(b)
        assert torch.equal(na, nb)
        a, b = a[~na], b[~nb]
    iv = {2: torch.int16, 4: torch.int32}[a.element_size()]
    assert torch.equal(a.view(iv), b.view(iv))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("planes", [1, 8, 23])
@pytest.mark.parametrize("n", [1, 31, 4097, 100_003])
@pytest.mark.parametrize("kind", ["specials", "zeros", "inf_scale",
                                  "saturate", "saturate_u32"])
def test_ef_kernels_on_special_leaves(cuda, kind, n, planes, offset):
    """``ef_amax``/``ef_apply`` against the plain path on the card, bit for
    bit (NaN included: both form it by arithmetic), at 16-byte-aligned
    pointers (the vector loop) and one float past them (the scalar loop);
    ``ef_amax``'s blocks' largest against torch's maximum; two calls give
    the same bits; and the CPU's plain path agrees (a NaN as a NaN: the
    CPU keeps an input NaN's payload)."""
    from repro_torch.distributed.grad_compress import ef_quantize
    from repro_torch.kernels import optim as ko
    xs, rs = _ef_leaf(kind, n + offset)
    x = torch.from_numpy(xs).to(cuda)[offset:]
    r = torch.from_numpy(rs).to(cuda)[offset:]
    q, nr = ef_quantize(x, r, planes)
    q2, nr2 = ef_quantize(x, r, planes)
    qp, nrp = ef_quantize(x, r, planes, backend="torch")
    for a, b in ((q, qp), (nr, nrp), (q2, q), (nr2, nr)):
        _bits_equal(a, b)
    amax = ko.ef_amax(x, r).view(torch.int32).max().view(torch.float32)
    _bits_equal(amax, ko.ef_amax_ref(x, r), nan_as_nan=True)
    qc, nrc = ef_quantize(x.cpu(), r.cpu(), planes)
    _bits_equal(q, qc)
    _bits_equal(nr, nrc, nan_as_nan=True)


def test_ef_kernels_at_the_embedding_s_size(cuda):
    """h2o-danube-3-4b's embedding gradient (122,880,000 values), the
    largest leaf of the trainer's path, against the plain path on the
    card."""
    from repro_torch.distributed.grad_compress import ef_quantize
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(32000, 3840, generator=g, device=cuda) * 1e-4
    r = torch.randn(32000, 3840, generator=g, device=cuda) * 1e-8
    for planes in (8, 23):
        got = ef_quantize(x, r, planes)
        want = ef_quantize(x, r, planes, backend="torch")
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


ADAMW_DTYPES = [(torch.float32, torch.float32, "float32"),
                (torch.float32, torch.float32, "bfloat16"),
                (torch.bfloat16, torch.bfloat16, "float32"),
                (torch.bfloat16, torch.bfloat16, "bfloat16"),
                (torch.bfloat16, torch.float32, "float32"),
                (torch.bfloat16, torch.float32, "bfloat16")]
ADAMW_IDS = [f"p{str(p)[6:]}-g{str(g)[6:]}-s{s}" for p, g, s in ADAMW_DTYPES]
# the defaults, and other values of every Python scalar the update
# multiplies by or adds, which pin each one's float32 value
ADAMW_HYPER = [dict(), dict(b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.05)]


def _adamw_leaf(n, pdt, gdt, sdt, seed, special=False):
    rng = np.random.default_rng(seed + n)
    p = rng.normal(size=n).astype(np.float32)
    g = (rng.normal(size=n) * 1e-2).astype(np.float32)
    m = (rng.normal(size=n) * 1e-3).astype(np.float32)
    v = np.abs(rng.normal(size=n) * 1e-5).astype(np.float32)
    if special:
        g = _sprinkle(g, OPT_SPECIALS)
        p = _sprinkle(p, [0.0, -0.0, 1e-39, -1e-39, 5.0])
        m = _sprinkle(m, [1e-40, -0.0, 0.0])
        v = _sprinkle(v, [1e-41, 0.0])
    return tuple(torch.from_numpy(a).to(dt) for a, dt in
                 ((p, pdt), (g, gdt), (m, sdt), (v, sdt)))


def _adamw_scalars(cfg, g, step, device):
    from repro_torch.optim import adamw
    return adamw.step_scalars(
        cfg, torch.tensor(step, dtype=torch.int32, device=device),
        adamw.global_norm({"g": g}))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("hyper", [0, 1])
@pytest.mark.parametrize("n", [1, 31, 4097, 100_003])
@pytest.mark.parametrize("dtypes", ADAMW_DTYPES, ids=ADAMW_IDS)
def test_adamw_update_kernel_equals_upd_on_the_card(cuda, dtypes, n, hyper,
                                                    offset):
    """``adamw_update`` against ``adamw._upd`` on the card, bit for bit:
    warmup and cosine steps, with and without clipping, a leaf of special
    values, vector and scalar loops (``offset``), one launch a call, and
    two calls the same bits."""
    from repro_torch.kernels import optim as ko
    from repro_torch.optim import adamw
    pdt, gdt, sname = dtypes
    sdt = adamw.DTYPES[sname]
    for step, special in ((1, False), (3, False), (9, False), (3, True)):
        leaf = _adamw_leaf(n + offset, pdt, gdt, sdt, step, special)
        p, g, m, v = (t.to(cuda)[offset:] for t in leaf)
        finite = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        for clip in (1e9, 0.3 * adamw.global_norm({"g": finite}).item()):
            cfg = adamw.AdamWConfig(warmup_steps=2, total_steps=9,
                                    clip_norm=clip, state_dtype=sname,
                                    **ADAMW_HYPER[hyper])
            sc = _adamw_scalars(cfg, g, step, cuda)
            before = ko.adamw_update.launches
            got = ko.adamw_update(p, g, m, v, *sc, cfg.b1, cfg.b2, cfg.eps,
                                  cfg.weight_decay)
            assert ko.adamw_update.launches == before + 1
            again = ko.adamw_update(p, g, m, v, *sc, cfg.b1, cfg.b2,
                                    cfg.eps, cfg.weight_decay)
            want = adamw._upd(p, g, m, v, *sc, cfg, sdt)
            for a, b, c in zip(got, want, again):
                assert a.dtype == b.dtype
                _bits_equal(a, b)
                _bits_equal(a, c)


def test_adamw_update_kernel_at_the_embedding_s_size(cuda):
    """h2o-danube-3-4b's embedding (122,880,000 values), float32 and
    bfloat16 state, against ``_upd`` on the card."""
    from repro_torch.kernels import optim as ko
    from repro_torch.optim import adamw
    gen = torch.Generator(device=cuda).manual_seed(4)
    shape = (32000, 3840)
    p = torch.randn(shape, generator=gen, device=cuda) * 2e-2
    g = torch.randn(shape, generator=gen, device=cuda) * 1e-5
    for sname in ("float32", "bfloat16"):
        sdt = adamw.DTYPES[sname]
        m = (torch.randn(shape, generator=gen, device=cuda) * 1e-6).to(sdt)
        v = (torch.rand(shape, generator=gen, device=cuda) * 1e-10).to(sdt)
        cfg = adamw.AdamWConfig(state_dtype=sname)
        sc = _adamw_scalars(cfg, g, 150, cuda)
        got = ko.adamw_update(p, g, m, v, *sc, cfg.b1, cfg.b2, cfg.eps,
                              cfg.weight_decay)
        want = adamw._upd(p, g, m, v, *sc, cfg, sdt)
        for a, b in zip(got, want):
            _bits_equal(a, b)
        del m, v, got, want


def _sumsq_check(leaves, what):
    """``global_sumsq`` on the card against the plain chain: each leaf's sum
    within 1e-12 relative (zeros exact), the same bits on two calls, the
    norm within one float32 ulp of the chain's; returns the launches of
    one call."""
    from repro_torch.kernels import optim as ko
    from repro_torch.optim import adamw
    before = ko.global_sumsq.launches
    got = ko.global_sumsq(leaves)
    launched = ko.global_sumsq.launches - before
    again = ko.global_sumsq(leaves)
    assert torch.equal(got.view(torch.int64), again.view(torch.int64)), what
    want = ko.global_sumsq_ref(leaves)
    assert got.dtype == torch.float64 and got.shape == want.shape
    zero = want == 0
    assert torch.equal(got[zero], want[zero]), what
    if bool((~zero).any()):
        rel = ((got - want).abs()[~zero] / want[~zero]).max().item()
        assert rel <= 1e-12, (what, rel)
    tree = {str(i): g for i, g in enumerate(leaves)}
    norm = adamw.global_norm(tree)
    chain = adamw.global_norm(tree, backend="torch")
    diff = abs(int(norm.view(torch.int32)) - int(chain.view(torch.int32)))
    print(f"global_sumsq {what}: norm {norm.item()!r} against the chain's "
          f"{chain.item()!r}, {diff} ulp")
    assert diff <= 1, what
    return launched


def test_global_sumsq_on_danube_s_leaves(cuda):
    """h2o-danube-3-4b/2's 12 gradient leaves (555,436,800 float32 values,
    the embedding's 122,880,000 among them): one launch of the pass a call
    (all 12 in one argument block), at most three device activities (the
    chunks' pass and the leaves' sums), within the tolerances above."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import optim as ko
    from repro_torch.models.model import model_abstract
    from repro_torch.models.params import tree_leaves
    cfg = dataclasses.replace(get_config("h2o-danube-3-4b"), n_layers=2)
    gen = torch.Generator(device=cuda).manual_seed(8)
    leaves = [torch.randn(ps.shape, generator=gen, device=cuda) * 1e-3
              for ps in tree_leaves(model_abstract(cfg))]
    assert len(leaves) == 12
    assert _sumsq_check(leaves, "danube/2") == 1
    acts = bp.device_activities(lambda: ko.global_sumsq(leaves))
    assert sum(acts.values()) <= 3, acts
    assert any("sumsq_chunks_kernel" in k for k in acts), acts


def test_global_sumsq_on_special_leaves(cuda):
    """Zeros, subnormals, squares that overflow float32 but not float64,
    bfloat16 leaves, empty leaves, one value, leaves either side of a
    chunk, a leaf that starts off a 16-byte boundary, and more leaves than
    one argument block (one launch of the pass for each block that holds
    a value)."""
    from repro_torch.kernels import optim as ko
    gen = torch.Generator(device=cuda).manual_seed(9)
    c = ko.SUM_CHUNK
    special = [torch.zeros(1000, device=cuda),
               torch.full((70_000,), 1e-40, device=cuda),
               torch.full((c + 3,), 3e35, device=cuda),
               torch.tensor([1e19, -1e-45, 0.0, -0.0], device=cuda),
               (torch.randn(200_003, generator=gen, device=cuda)
                ).to(torch.bfloat16),
               torch.full((9,), 1e-40, device=cuda).to(torch.bfloat16),
               torch.empty(0, device=cuda),
               torch.randn(1, generator=gen, device=cuda),
               torch.randn(c - 1, generator=gen, device=cuda),
               torch.randn(c + 1, generator=gen, device=cuda),
               torch.randn(c + 2, generator=gen, device=cuda)[1:]]
    assert _sumsq_check(special, "special leaves") == 1
    rng = np.random.default_rng(10)
    many = [torch.randn(int(n), generator=gen, device=cuda).to(
        (torch.float32, torch.bfloat16)[i % 2])
        for i, n in enumerate(rng.integers(1, 100_000, 2 * ko.SUM_LEAVES + 7))]
    assert _sumsq_check(many, "many leaves") == 3
    empty_block = [torch.empty(0, device=cuda)] * ko.SUM_LEAVES + many[:5]
    assert _sumsq_check(empty_block, "an argument block of empty leaves") == 1


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_on_the_card_equals_the_plain_update(cuda, state_dtype,
                                                          monkeypatch):
    """``adamw.update`` through the kernels (one ``adamw_update`` a leaf and
    one ``global_sumsq`` a step) against ``backend="torch"`` on the card
    over 4 steps with clipping: the global norms within one float32 ulp
    (the kernel sums in its own fixed order, the plain chain in torch's),
    and, given the kernel's sums on both sides, every leaf of the
    parameters and the state bit for bit."""
    from repro_torch.kernels import optim as ko
    from repro_torch.optim import adamw
    from repro_torch.models.params import tree_leaves
    cfg = adamw.AdamWConfig(warmup_steps=2, total_steps=6, clip_norm=0.5,
                            state_dtype=state_dtype)
    gen = torch.Generator(device=cuda).manual_seed(5)
    params = {"a": torch.randn(4097, generator=gen, device=cuda),
              "b": {"c": torch.randn(33, 129, generator=gen, device=cuda)}}
    plain = kern = (params, adamw.init(params, cfg))
    for _ in range(4):
        grads = {"a": torch.randn(4097, generator=gen, device=cuda),
                 "b": {"c": torch.randn(33, 129, generator=gen,
                                        device=cuda)}}
        before = bp.launches()
        kp, ks, km = adamw.update(grads, kern[1], kern[0], cfg)
        after = bp.launches()
        assert after["adamw_update"] == before["adamw_update"] + 2
        assert after["global_sumsq"] == before["global_sumsq"] + 1
        chain = adamw.global_norm(grads, backend="torch")
        assert abs(int(km["grad_norm"].view(torch.int32))
                   - int(chain.view(torch.int32))) <= 1
        with monkeypatch.context() as mp:
            mp.setattr(adamw, "_sumsq_plain", lambda leaves: list(
                ko.global_sumsq(leaves).unbind(0)))
            pp, ps, pm = adamw.update(grads, plain[1], plain[0], cfg,
                                      backend="torch")
        assert bp.launches()["adamw_update"] == before["adamw_update"] + 2
        _bits_equal(km["grad_norm"], pm["grad_norm"])
        for a, b in zip(tree_leaves(kp) + tree_leaves(ks.m)
                        + tree_leaves(ks.v), tree_leaves(pp)
                        + tree_leaves(ps.m) + tree_leaves(ps.v)):
            _bits_equal(a, b)
        kern, plain = (kp, ks), (pp, ps)


def _smoke_trainer(arch, model, ckpt_dir, device, steps=2):
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    return loop.Trainer(
        model, adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps),
        loop.TrainerConfig(total_steps=steps, ckpt_every=1,
                           ckpt_dir=str(ckpt_dir), log_every=1,
                           grad_compress_planes=8),
        loop.synthetic_data(model.cfg, 2, 24, seed=1, device=device))


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-v2-236b",
                                  "jamba-v0.1-52b"])
def test_one_trainer_step_on_the_card_matches_the_cpu(cuda, tmp_path, arch):
    """One step from one CPU ``tree_init``: the loss within phase 13's
    logit tolerance, each parameter within 2 x lr of the CPU's (Adam's
    first step is about lr * sign(g) a parameter)."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_leaves
    cpu = Model(smoke_config(arch), device="cpu", seed=0)
    card = Model(smoke_config(arch), cpu.params, device=cuda)
    want = _smoke_trainer(arch, cpu, tmp_path / "cpu", "cpu", 1).run()
    got = _smoke_trainer(arch, card, tmp_path / "card", cuda, 1).run()
    tol = SERVE_TOL.get(arch, 1e-4)
    assert got["metrics"][0]["loss"] == pytest.approx(
        want["metrics"][0]["loss"], rel=tol)
    for a, b in zip(tree_leaves(want["params"]), tree_leaves(got["params"])):
        assert b.device.type == "cuda"
        assert float((a - b.cpu()).abs().max()) <= 2e-3


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-v2-236b"])
def test_crash_and_resume_on_the_card_is_bit_exact(cuda, tmp_path, arch):
    """A card run crashed after step 1 and resumed ends bit-identical to an
    uncrashed card run: params, AdamW state and EF residual (the MoE
    combine adds in a fixed order; the gathers' gradients are ordered
    reductions)."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_leaves
    card = Model(smoke_config(arch), device=cuda, seed=0)
    full = _smoke_trainer(arch, card, tmp_path / "a", cuda, 3).run()
    with pytest.raises(RuntimeError, match="injected crash"):
        _smoke_trainer(arch, card, tmp_path / "b", cuda, 3).run(crash_at=1)
    resumed = _smoke_trainer(arch, card, tmp_path / "b", cuda, 3).run()
    assert [m["step"] for m in resumed["metrics"]] == [2, 3]

    def leaves(res):
        opt = res["opt_state"]
        return (tree_leaves(res["params"]) + [opt.step] + tree_leaves(opt.m)
                + tree_leaves(opt.v) + tree_leaves(res["ef"]))
    for a, b in zip(leaves(full), leaves(resumed)):
        assert torch.equal(a, b)


# ------------------------------------------- the mesh-bound paths, NCCL --
# One NCCL rank per card (tests/_torch_dist_worker.py), worlds of 2 and,
# with four cards, 4; each check is held against the same call on one
# card.  Tolerances as in tests/test_torch_distributed*.py.

def _worlds():
    n = torch.cuda.device_count()
    return [w for w in (2, 4) if w <= n]


def _cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return _worlds()


def test_compressed_psum_across_cards(cuda, tmp_path):
    """compressed_psum over 'data' on 2 (and 4) cards: the same output on
    every rank; at 2 ranks, bit for bit the same call's arithmetic on one
    card (each shard's sum of two terms is exact: encode and decode it
    there); at 4, the reference's bound 2**-6 x max|mean|; wire bytes below
    0.62 x a plain all-reduce at 6 planes."""
    from _torch_dist_worker import run_world
    from repro_torch.distributed import grad_compress as gc
    n_el = 1 << 20
    for n in _cards(cuda):
        x = torch.from_numpy(np.random.default_rng(n).normal(
            size=(n, n_el)).astype(np.float32))
        res = run_world(n, [("compressed", (n, 1), {"x": x, "planes": p})
                            for p in (6, 8)], tmp_path, device="cuda")
        mean = x.double().mean(0)
        for i, planes in enumerate((6, 8)):
            outs = [r[i]["out"][0] for r in res]
            assert all(torch.equal(o, outs[0]) for o in outs)
            err = (outs[0].double() - mean).abs().max() / mean.abs().max()
            assert err < 2 ** -6
            comp, plain = (int(v) for v in res[0][i]["wire"])
            if planes == 6:
                assert comp < 0.62 * plain
            if n == 2:
                shards = x.to(cuda).reshape(n, n, -1).sum(0) / n
                want = []
                for r in range(n):
                    packed, e = gc._encode_planes(shards[r], planes)
                    want.append(gc._decode_planes(packed, e, n_el // n,
                                                  planes))
                    assert torch.equal(res[r][i]["packed"], packed.cpu())
                assert torch.equal(outs[0].view(torch.int32),
                                   torch.cat(want).cpu().view(torch.int32))


def test_seqshard_decode_across_cards(cuda, tmp_path):
    """seqshard_decode_gqa (bfloat16 cache) and _int8 with the L axis over
    2 (and 4) cards against decode_attention over the whole cache on one
    card: the bfloat16 output within 2**-8 x max|v| (each side rounds its
    probabilities to bfloat16, against its own running maximum, before the
    PV product: each rounding moves an output by at most 2**-9 of the
    probability-weighted mean of |v|), the int8 cache's (float32 queries)
    within 1e-5 of the largest output."""
    from _torch_dist_worker import run_world
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731,E501
    b, L, hkv, dh = 2, 4096, 2, 64
    q, k, v = f(b, 1, 4, dh), f(b, L, hkv, dh), f(b, L, hkv, dh)
    kn, vn = f(b, 1, hkv, dh), f(b, 1, hkv, dh)
    i8 = lambda *s: torch.from_numpy(rng.integers(-127, 128, s).astype(np.int8))  # noqa: E731,E501
    sc = lambda *s: (f(*s).abs() + 0.5).to(torch.bfloat16)  # noqa: E731
    for n in _cards(cuda):
        jobs = []
        for idx in (5, L // 2 + 7, L - 1):
            bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
            jobs.append(("seqshard", (1, n), dict(
                q=bf(q), k_cache=bf(k), v_cache=bf(v), k_new=bf(kn),
                v_new=bf(vn), index=idx, batch_axes=())))
            jobs.append(("seqshard", (1, n), dict(
                q=q, k_cache=i8(b, L, hkv, dh), v_cache=i8(b, L, hkv, dh),
                k_new=i8(b, 1, hkv, dh), v_new=i8(b, 1, hkv, dh), index=idx,
                batch_axes=(), ks_cache=sc(b, L, hkv), vs_cache=sc(b, L, hkv),
                ks_new=sc(b, 1, hkv), vs_new=sc(b, 1, hkv))))
        res = run_world(n, jobs, tmp_path, device="cuda")
        for r in res:
            for j, got in enumerate(r):
                a, o = got["one_device"].double(), got["out"].double()
                if got["out"].dtype == torch.bfloat16:
                    bound = 2.0 ** -8 * v.abs().max()
                else:
                    bound = 1e-5 * a.abs().max()
                assert (a - o).abs().max() <= bound, j


def test_moe_shard_map_dispatch_across_cards(cuda, tmp_path):
    """The MoE shard_map dispatch with experts over 2 (and 4) cards, and
    on (2, 2): outputs against the capacity dispatch of the same tokens on
    one card; with one data shard, the gradients (w1, w2, w3, router)
    against the whole batch's on one card, within 1e-5 of each largest."""
    from _torch_dist_worker import run_world
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.models.moe import moe_abstract
    from repro_torch.models.params import tree_init
    moe = dict(n_experts=8, top_k=2, d_expert=32, n_shared=1,
               dispatch="shard_map", capacity_factor=4.0)
    cfg_kw = dict(name="moe", family="moe", n_layers=1, d_model=64,
                  n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=64,
                  compute_dtype="float32", moe=moe)
    params = tree_init(moe_abstract(ModelConfig(**dict(
        cfg_kw, moe=MoEConfig(**moe)))), torch.Generator().manual_seed(2),
        "float32", "cpu")
    rng = np.random.default_rng(3)
    x, cot = (torch.from_numpy(rng.normal(size=(4, 16, 64)).astype(
        np.float32)) for _ in range(2))
    for n in _cards(cuda):
        shapes = [(1, n)] + ([(2, 2)] if n == 4 else [])
        res = run_world(n, [("moe", s, dict(params=params, x=x, cot=cot,
                                            cfg_kw=cfg_kw)) for s in shapes],
                        tmp_path, device="cuda")
        for r in res:
            for got in r:
                a, o = got["one_device"].double(), got["out"].double()
                assert (a - o).abs().max() <= 1e-5 * a.abs().max()
                for k in [k for k in got if k.startswith("grad_one.")]:
                    a, o = got[k].double(), got["grad." + k[9:]].double()
                    assert (a - o).abs().max() <= 1e-5 * a.abs().max(), k


def test_data_parallel_step_across_cards(cuda, tmp_path):
    """make_train_step under a ('data', 'model') mesh of 2 (and 4) cards,
    for a dense, an MoE (shard_map dispatch) and an SSM smoke arch, the
    batch cut over both axes, against the step on one card.

    Against the one-card step over n microbatches (each rank's rows, the
    same shapes and kernels): the dense and SSM archs bit-identical at 2
    ranks (a sum of two terms is exact in any order), within 1e-6 of each
    gradient leaf's largest at 4.  Against the one-card step over the
    whole batch, every arch (the MoE's routing and aux loss see the whole
    batch in both): the loss within 1e-6 relative, each gradient leaf
    within 2e-3 of its largest, the bound of
    ``tests/test_torch_train_grads.py`` for float32 sums in another order
    (cuBLAS sums a weight's gradient over 128 tokens otherwise than over
    64).  Every rank ends with the same parameters."""
    from _torch_dist_worker import run_world
    from repro_torch.configs.base import smoke_config
    from repro_torch.models.model import Model
    cases = [("deepseek-67b", None), ("deepseek-v2-236b", "shard_map"),
             ("rwkv6-3b", None)]
    rng = np.random.default_rng(4)

    def rel(a, b):
        return ((a.double() - b.double()).abs().max()
                / b.double().abs().max().clamp_min(1e-30)).item()
    for n in _cards(cuda):
        shape = (n // 2, 2)
        jobs = []
        for arch, dispatch in cases:
            cfg = smoke_config(arch)
            batch = {k: torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (8, 16)).astype(np.int32))
                for k in ("tokens", "labels")}
            params = Model(cfg, device="cpu", seed=0).params
            for mesh, n_micro in ((shape, 1), (None, 1), (None, n)):
                jobs.append(("train_step", mesh, dict(
                    arch=arch, params=params, batch=batch,
                    batch_axes=("data", "model"), n_micro=n_micro,
                    dispatch=dispatch)))
        res = run_world(n, jobs, tmp_path, device="cuda")
        for c, (arch, dispatch) in enumerate(cases):
            for r in res:
                got, whole, micro = r[3 * c:3 * c + 3]
                grads = [k for k in whole if k.startswith("grad.")]
                e_whole = max(rel(got[k], whole[k]) for k in grads)
                e_micro = max(rel(got[k], micro[k]) for k in grads)
                print(f"{n} cards, {arch}: loss {rel(got['loss'], whole['loss']):.2e}"
                      f" of the whole-batch step's; gradients within "
                      f"{e_whole:.2e} of it, {e_micro:.2e} of the "
                      f"{n}-microbatch step's")
                assert rel(got["loss"], whole["loss"]) <= 1e-6
                assert e_whole <= 2e-3, (arch, e_whole)
                if dispatch is None:
                    assert e_micro <= (0.0 if n == 2 else 1e-6), \
                        (arch, e_micro)
                for k in [k for k in got if k.startswith("param.")]:
                    assert torch.equal(got[k], res[0][3 * c][k]), k


# ------------------------------- sharded parameter storage, NCCL, cards --

def _wire_of(res, step=-1):
    """``WIRE``'s counts of one step of an ``fsdp_danube`` result."""
    return dict(zip(res["wire_keys"], res["wire"][step].tolist()))


def _fsdp_report(n, r, res):
    wall = res["wall"].tolist()
    wire = {k: int(v) for k, v in _wire_of(res).items() if v}
    print(f"{n} cards, rank {r}: losses {res['loss'].tolist()}, step walls "
          f"{[round(w, 4) for w in wall]} s; peak device memory "
          f"{int(res['peak'][0]) / 2 ** 30:.3f} GiB over the steps "
          f"({int(res['peak'][1]) / 2 ** 30:.3f} GiB set-up); stored "
          f"{int(res['stored']) / 1e9:.3f} GB of a whole state of "
          f"{int(res['whole_state'][0]) / 1e9:.3f} GB "
          f"({int(res['whole_state'][1])} params); WIRE of the last step "
          f"{wire}; the last step's peak from its allocation history "
          f"{int(res['snapshot_peak']) / 2 ** 30:.3f} GiB, live there (bytes, "
          f"count, where): {res['snapshot_rows']}")


def test_fsdp_danube_full_depth_on_four_cards(cuda, tmp_path):
    """h2o-danube-3-4b at its full 24 layers and published widths, each
    rank holding a quarter of the parameters and AdamW state, on a (4, 1)
    ('data', 'model') mesh: 3 steps of a global batch of 4 x 4096 (one
    sequence a rank, the same batch each step).  Step 1's loss within 1e-5
    relative of the mean of one-card forward losses over the same four
    sequences, and falling over the steps; each rank stores a quarter of
    the whole state."""
    from _torch_dist_worker import run_world
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    res = run_world(4, [("fsdp_danube", (4, 1), dict(
        layers=24, steps=3, global_batch=4, seq=4096, one_card=False))],
        tmp_path, device="cuda", timeout=1200)
    for r, (got,) in enumerate(res):
        _fsdp_report(4, r, got)
        loss, fwd = got["loss"].tolist(), float(got["forward_loss"])
        print(f"4 cards, rank {r}: step 1's loss {loss[0]!r}, the one-card "
              f"forward's {fwd!r} ({abs(loss[0] - fwd) / abs(fwd):.2e} apart)")
        assert abs(loss[0] - fwd) <= 1e-5 * abs(fwd), (loss[0], fwd)
        assert loss[0] > loss[1] > loss[2], loss
        # parameters, m and v: a quarter of each, the norms whole
        assert int(got["stored"]) <= 1.001 * 12 * int(got["whole_state"][1]) / 4
        assert got["loss"].tolist() == res[0][0]["loss"].tolist()


def test_fsdp_danube_two_layers_across_cards(cuda, tmp_path):
    """h2o-danube-3-4b cut to 2 layers at its published widths on 2 (and 4)
    cards, blocks on an (n, 1) mesh, global batch 4 x 4096, against the
    one-card whole-tree step over n microbatches (the ranks' shapes): at 2
    cards loss, gradient blocks, new parameter blocks, m and v
    bit-identical; at 4, each gradient block within 1e-5 x its largest
    value and the loss within 1e-6 relative."""
    from _torch_dist_worker import run_world
    for n in _cards(cuda):
        res = run_world(n, [("fsdp_danube", (n, 1), dict(
            layers=2, steps=1, global_batch=4, seq=4096, one_card=True))],
            tmp_path, device="cuda", timeout=900)
        for r, (got,) in enumerate(res):
            _fsdp_report(n, r, got)
            loss, one = float(got["loss"][0]), float(got["one_card_loss"])
            rows = got["compare"]
            grads = rows[rows[:, 0] == 0]
            worst = (grads[:, 1] / grads[:, 2].clamp_min(1e-30)).max()
            print(f"{n} cards, rank {r}: loss {loss!r} against one card's "
                  f"{one!r}; gradient blocks within {float(worst):.3e} of "
                  f"their largest; bit-identical leaves "
                  f"{int(rows[:, 3].sum())} of {rows.shape[0]}")
            if n == 2:
                assert loss == one
                assert bool((rows[:, 3] == 1).all())
            else:
                assert abs(loss - one) <= 1e-6 * abs(one)
                assert float(worst) <= 1e-5


# ------------------------- tensor-parallel compute over 'model', NCCL, cards --

def test_tp_danube_full_depth_on_four_cards(cuda, tmp_path):
    """h2o-danube-3-4b at its full 24 layers and published widths on a
    (1, 4) ('data', 'model') mesh, computed over 'model' on the blocks
    (``distributed/tp.py``): 3 steps of a global batch of 4 x 4096 (the
    whole batch on every rank, the same batch each step), phase 14's
    settings, and one step more in float32 compute.  Step 1's loss
    against the mean of one-card forward losses over the same four
    sequences: in float32 within 1e-5 relative; in bfloat16 within 1e-5
    or twice as far as one bfloat16 ulp of noise on the embedding moves
    that one-card loss (the row-parallel sums add bfloat16 partial sums,
    so the step is the one-card forward to within the model's rounding);
    the loss falling; no parameter gathered; the ``tp_all_reduce`` calls
    of a step the layer plan's (``chip_smoke.tp_plan``); the last step's
    peak with the allocations live there, from its allocation history
    (with ``REPRO_MEMORY_SNAPSHOT_DIR`` set, rank 0 writes the bfloat16
    run's snapshot there).  Every rank reports before any check."""
    import os
    from _torch_dist_worker import run_world
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    out = os.environ.get("REPRO_MEMORY_SNAPSHOT_DIR")
    snap = os.path.join(out, "tp_danube_rank0.pickle") if out else None
    kw = dict(layers=24, global_batch=4, seq=4096, one_card=False)
    res = run_world(4, [("fsdp_danube", (1, 4), dict(kw, steps=3,
                                                    snapshot=snap)),
                        ("fsdp_danube", (1, 4), dict(
                            kw, steps=1, compute_dtype="float32"))],
                    tmp_path, device="cuda", timeout=1200)
    rows = []
    for r, runs in enumerate(res):
        for what, got in zip(("bf16", "float32"), runs):
            _fsdp_report(4, r, got)
            loss, fwd = got["loss"].tolist(), float(got["forward_loss"])
            ulp = float(got["forward_loss_ulp"])
            dev = abs(loss[0] - fwd) / abs(fwd)
            dev_ulp = abs(ulp - fwd) / abs(fwd)
            t_act, t_kv = got["all_reduce_ms"].tolist()
            wire_ms = (5 * 24 + 2) * t_act + 2 * 24 * t_kv
            print(f"4 cards (1, 4), rank {r}, {what}: step 1's loss "
                  f"{loss[0]!r}, the one-card forward's {fwd!r} ({dev:.2e} "
                  f"apart; one bfloat16 ulp of noise on the embedding moves "
                  f"it {dev_ulp:.2e}); an all-reduce over 'model' of an "
                  f"activation {t_act:.3f} ms, of a K {t_kv:.3f} ms alone; "
                  f"a step's 173 at those times {wire_ms:.1f} ms, "
                  f"{wire_ms / 1e3 / got['wall'][-1]:.3f} of the last "
                  f"step's wall")
            rows.append((what, loss, dev, dev_ulp, got))
    for what, loss, dev, dev_ulp, got in rows:
        if what == "float32":
            assert dev <= 1e-5, dev
        else:
            assert dev <= max(1e-5, 2 * dev_ulp), (dev, dev_ulp)
            assert loss[0] > loss[1] > loss[2], loss
        for step in range(len(loss)):
            wire = _wire_of(got, step)
            assert wire["param_gather_bytes"] == 0, wire
            assert wire["tp_all_reduce"] == 7 * 24 + 5, wire
        assert loss == [x[1] for x in rows if x[0] == what][0]


def test_tp_danube_serving_on_four_cards(cuda, tmp_path):
    """h2o-danube-3-4b served on a (1, 4) mesh from
    ``param_shardings(drop_fsdp=True)`` blocks (batch 4, prompt 256, 16 new
    tokens), teacher-forced with one card's greedy tokens, against one
    card's decode of the whole tree: at 24 layers and at 2 layers in
    float32, each step's logits within 2**-8 x max|logit| (the
    tensor-parallel path at full width without bfloat16's rounding:
    float32's reordered sums, where a missing rank's share would move the
    logits as far as one bfloat16 ulp of noise on the embedding does,
    printed beside); at 24 layers in bfloat16 the same numbers printed and
    not held (the row-parallel sums add bfloat16 partial sums, and this
    random-weight model carries their rounding as far as that of one ulp
    of noise).  The greedy agreement printed; no parameter gathered, 49
    ``tp_all_reduce`` and 1 ``tp_all_gather`` a step at 24 layers.  Every
    rank reports before any check."""
    from _torch_dist_worker import run_world
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    new = 16
    kw = dict(batch=4, prompt=256, n_new=new)
    jobs = (("24 layers float32", 24, "float32"),
            ("24 layers bf16", 24, None), ("2 layers float32", 2, "float32"))
    res = run_world(4, [("danube_serve", (1, 4), dict(
        kw, layers=n, compute_dtype=dt)) for _, n, dt in jobs],
                    tmp_path, device="cuda", timeout=900)
    rows = []
    for r, runs in enumerate(res):
        for (what, layers, dt), got in zip(jobs, runs):
            one = got["one_logits"].double()
            top = one.abs().max()
            err = float((got["logits"].double() - one).abs().max() / top)
            ulp = float((got["ulp_logits"].double() - one).abs().max() / top)
            agree = float((got["tokens"] == got["one_tokens"]).double()
                          .mean())
            t = got["times"].tolist()
            wire = {k: int(v) for k, v in zip(got["wire_keys"],
                                              got["wire"].tolist()) if v}
            print(f"4 cards (1, 4), rank {r}: danube {what} served "
                  f"tensor-parallel: logits within {err:.3e} of max|logit| "
                  f"of one card's (one ulp of noise on the embedding: "
                  f"{ulp:.3e}), greedy agreement {agree:.4f}; prefill "
                  f"{t[0]:.3f} s, decode {t[1]:.2f} ms/token (one card "
                  f"{t[2]:.3f} s, {t[3]:.2f} ms/token); peak "
                  f"{int(got['peak']) / 2 ** 30:.3f} GiB; stored "
                  f"{int(got['stored']) / 1e9:.3f} GB; WIRE {wire}")
            rows.append((layers, dt, err, wire))
    for layers, dt, err, wire in rows:
        if dt == "float32":
            assert err <= 2 ** -8, (layers, err)
        if layers == 24:
            assert wire["tp_all_reduce"] == new * (2 * 24 + 1)
        assert wire.get("param_gather", 0) == 0
        assert wire["tp_all_gather"] == new


# ---------------- Mamba on its 'model' blocks, jamba's period, NCCL, cards --

JAMBA = "jamba-v0.1-52b"
JAMBA_PERIOD = 8     # one attention layer, seven Mamba layers


def _jamba_train_plan(n, b, s, d=4096, din=8192, dtr=256, ds=16, kv=1024):
    """(``tp_all_reduce``, ``tp_all_to_all``) (calls, bytes) of one remat
    train step of jamba's period without its MoE, float32, ``b`` x ``s``
    tokens a rank, ``n`` ranks of 'model', by its layer plan (the one of
    ``tests/test_torch_tp.py``'s ``_tp_plan``): a Mamba layer all-reduces
    its output and its three sums forward, again in the recompute, and its
    x and the three sums backward; attention its output forward and in the
    recompute, its x, K and V backward; each MLP its output forward and in
    the recompute (but the repeat's last) and its x backward; outside the
    stack the embedding's sum, the head's entry and the loss's three
    reductions.  ``in_proj`` is re-cut forward, in the recompute and
    backward, (d, 2 din / n) each time."""
    ring = lambda numel: 2 * 4 * numel * (n - 1) // n  # noqa: E731
    act = ring(b * s * d)
    sums = [ring(b * s * dtr), ring(b * s * ds), ring(b * s * ds)]
    each = []
    for i in range(JAMBA_PERIOD):
        if i == 4:                                     # attn_offset
            exits, entries = [act], [act, ring(b * s * kv), ring(b * s * kv)]
        else:
            exits, entries = [act] + sums, [act] + sums
        exits, entries = exits + [act], entries + [act]     # the MLP
        recompute = exits[:-1] if i == JAMBA_PERIOD - 1 else exits
        each += exits + recompute + entries
    each += [act, act, ring(b * s), ring(b * s), ring(b * s)]
    recuts = 3 * (JAMBA_PERIOD - 1)
    recut = 4 * d * 2 * (din // n) * (n - 1) // n
    return (len(each), sum(each)), (recuts, recuts * recut)


def test_tp_jamba_serving_on_four_cards(cuda, tmp_path):
    """jamba-v0.1-52b at its published widths, one period (8 of 32 layers,
    16 experts), float32, its stacked weights drawn with the fan-in of the
    layer's own leaves (``_torch_dist_worker.unstack_fan_in``: by the
    stacked rule, std 1 at one repeat, its norms overflow and every logit
    is 0 or NaN), served on a (1, 4) mesh from
    ``param_shardings(drop_fsdp=True)`` blocks (Mamba on its blocks of
    ``d_inner``), batch 4, prompt 256, 16 new tokens, teacher-forced with
    one card's greedy tokens, against one card's decode of the whole tree:
    each step's logits within 2**-8 x max|logit|, greedy agreement at least
    0.9 (as for danube); no parameter gathered; per step 38
    ``tp_all_reduce`` (7 Mamba layers' output and three sums, the
    attention's output, 8 MLP or MoE combines, the embedding), 15
    ``tp_all_gather`` (the logits, 7 conv and 7 SSM states) and 7
    ``tp_all_to_all`` (the ``in_proj`` re-cuts).  Every rank reports
    before any check."""
    from _torch_dist_worker import run_world
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    new = 16
    res = run_world(4, [("danube_serve", (1, 4), dict(
        batch=4, prompt=256, n_new=new, layers=JAMBA_PERIOD,
        compute_dtype="float32", arch=JAMBA,
        overrides={"param_dtype": "float32"}, unstacked=True))], tmp_path,
        device="cuda", timeout=1200)
    rows = []
    for r, (got,) in enumerate(res):
        one = got["one_logits"].double()
        top = one.abs().max()
        err = float((got["logits"].double() - one).abs().max() / top)
        ulp = float((got["ulp_logits"].double() - one).abs().max() / top)
        agree = float((got["tokens"] == got["one_tokens"]).double().mean())
        t = got["times"].tolist()
        wire = {k: int(v) for k, v in zip(got["wire_keys"],
                                          got["wire"].tolist()) if v}
        print(f"4 cards (1, 4), rank {r}: jamba period float32 served "
              f"tensor-parallel: logits within {err:.3e} of max|logit| of "
              f"one card's (one bf16 ulp of noise on the embedding: "
              f"{ulp:.3e}), greedy agreement {agree:.4f}; prefill "
              f"{t[0]:.3f} s, decode {t[1]:.2f} ms/token (one card "
              f"{t[2]:.3f} s, {t[3]:.2f} ms/token); peak "
              f"{int(got['peak']) / 2 ** 30:.3f} GiB; stored "
              f"{int(got['stored']) / 1e9:.3f} GB; WIRE {wire}")
        rows.append((err, agree, wire))
    for err, agree, wire in rows:
        assert math.isfinite(err) and err <= 2 ** -8, err
        assert agree >= 0.9, agree
        assert wire.get("param_gather", 0) == 0
        assert wire["tp_all_reduce"] == new * (7 * 4 + 1 + 8 + 1)
        assert wire["tp_all_gather"] == new * (1 + 2 * 7)
        assert wire["tp_all_to_all"] == new * 7


def test_tp_jamba_training_on_four_cards(cuda, tmp_path):
    """jamba-v0.1-52b at its published widths, one period without its MoE
    (``moe=None``: the MLP in every layer, ~2.7 B parameters; the
    experts' path is danube's and PR 21's), float32 parameters and
    compute, the stacked weights rescaled as for serving, on a (1, 4)
    mesh: 3 steps of 1 x 4096 (the same batch).
    Step 1's loss within 1e-6 relative of the one-card forward's, and
    falling; no parameter gathered (0 B over 'model'); ``tp_all_reduce``
    and ``tp_all_to_all`` calls and bytes the layer plan's
    (``_jamba_train_plan``); and the dry run's prediction of the same cell
    (``repro_torch.launch.dryrun`` on a fake world of four ranks on the
    CPU) equal to the measured ``WIRE``, kind by kind.  Every rank reports
    before any check."""
    from _torch_dist_worker import run_world
    from repro_torch.launch import dryrun
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    from concurrent.futures import ThreadPoolExecutor
    over = {"moe": None, "param_dtype": "float32"}
    seq = 4096
    with ThreadPoolExecutor(2) as ex:        # the dry run on the host's CPU
        pred = ex.submit(dryrun.run_spec, dryrun.cell_spec(
            JAMBA, "train", "custom", overrides=dict(
                over, n_layers=JAMBA_PERIOD, compute_dtype="float32"),
            shape_dims=("train", seq, 1),
            mesh_dims=((1, 4), ("data", "model"))), 1500)
        res = run_world(4, [("fsdp_danube", (1, 4), dict(
            layers=JAMBA_PERIOD, steps=3, global_batch=1, seq=seq,
            one_card=False, compute_dtype="float32", arch=JAMBA,
            overrides=over, unstacked=True))], tmp_path, device="cuda",
            timeout=1500)
        pred = pred.result()
    print(f"the dry run's cell: {pred['status']}, "
          f"{pred.get('wall_s', 0):.1f} s, args/rank "
          f"{pred.get('memory', {}).get('argument_bytes')}, flops/rank "
          f"{pred.get('flops_per_device')}, by kind "
          f"{pred.get('collectives', {}).get('by_kind')}")
    reduce_plan, recut_plan = _jamba_train_plan(4, 1, seq)
    rows = []
    for r, (got,) in enumerate(res):
        _fsdp_report(4, r, got)
        loss, fwd = got["loss"].tolist(), float(got["forward_loss"])
        dev = abs(loss[0] - fwd) / abs(fwd)
        print(f"4 cards (1, 4), rank {r}, jamba period (moe=None) float32: "
              f"step 1's loss {loss[0]!r}, the one-card forward's {fwd!r} "
              f"({dev:.2e} apart); the plan: tp_all_reduce {reduce_plan}, "
              f"tp_all_to_all {recut_plan} (calls, bytes) a step; stored "
              f"{int(got['stored']) / 1e9:.3f} GB a rank")
        rows.append((loss, dev, got))
    assert pred["status"] == "ok", pred.get("traceback", pred)
    for loss, dev, got in rows:
        assert dev <= 1e-6, dev
        assert loss[0] > loss[1] > loss[2], loss
        for step in range(len(loss)):
            wire = _wire_of(got, step)
            assert wire["param_gather_bytes"] == 0, wire
            assert (wire["tp_all_reduce"], wire["tp_all_reduce_bytes"]) \
                == reduce_plan, wire
            assert (wire["tp_all_to_all"], wire["tp_all_to_all_bytes"]) \
                == recut_plan, wire
            measured = {k: {"count": int(wire[k]),
                            "wire_bytes": int(wire[f"{k}_bytes"])}
                        for k in wire if not k.endswith("_bytes") and wire[k]}
            assert measured == pred["collectives"]["by_kind"], (measured,
                                                                pred)


# ------------------------------------------------------------- SSM scans --

SCAN_WIDTH = {"wkv6": 40, "mamba": 8192}   # rwkv6-3b's heads, jamba's d_inner


def _scan_args(kind, b, s, seed=0, d=None, n=16):
    """A scan's float32 inputs on the card in their models' ranges (Mamba's
    at ``d`` channels, jamba's by default, and ``n`` states)."""
    from repro_torch.kernels import scan as sc   # noqa: F401 (registers)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n_(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    w = d or SCAN_WIDTH[kind]
    if kind == "wkv6":
        return (n_(b, s, w, 64), n_(b, s, w, 64), n_(b, s, w, 64),
                torch.exp(-torch.exp(12 * torch.rand(
                    (b, s, w, 64), generator=g, device="cuda") - 8)),
                n_(w, 64), n_(b, w, 64, 64))
    return (n_(b, s, w), torch.nn.functional.softplus(n_(b, s, w) - 3),
            n_(b, s, n), n_(b, s, n),
            -torch.exp(torch.rand((w, n), generator=g, device="cuda")
                       * math.log(16)), n_(b, w, n))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("b,s", [(1, 4096), (2, 1), (2, 63), (2, 64),
                                 (2, 200)])
@pytest.mark.parametrize("kind", ["wkv6", "mamba"])
def test_scan_kernels_match_plain(cuda, kind, b, s):
    """Each scan kernel at rwkv6-3b's and jamba's widths against its plain
    version on the card: the final and kept states bit for bit, the
    outputs within 1e-5 of max|out|, every gradient within 1e-4 of its
    largest |value|; one launch a call."""
    from repro_torch.kernels import scan as sc
    args = _scan_args(kind, b, s)
    names = (("wkv6_fwd", "wkv6_bwd") if kind == "wkv6"
             else ("mamba_scan_fwd", "mamba_scan_bwd"))
    fwd, bwd = (getattr(sc, n) for n in names)
    before = bp.launches()
    got = fwd(*args, 64, True)
    want = sc.PLAIN[names[0]](*args, 64, True)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert _rel(got[0], want[0]) <= 1e-5
    g = torch.Generator(device="cuda").manual_seed(1)
    cot = [torch.randn(t.shape, generator=g, device="cuda")
           for t in got[:2]]
    gk = bwd(*args[:5], want[2], *cot, 64)
    gp = sc.PLAIN[names[1]](*args[:5], want[2], *cot, 64)
    for x, y in zip(gk, gp):
        assert x.shape == y.shape and _rel(x, y) <= 1e-4
    after = bp.launches()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k in names) for k in after}
    torch.cuda.synchronize()


def _mamba_case(args, keep):
    """``mamba_scan_fwd`` (keeping the chunk states or not) and
    ``mamba_scan_bwd`` on ``args`` against their plain versions: states
    and final state bit for bit, ``y`` within 1e-5 of max|y|, every
    gradient within 1e-4 of its largest |value|, one launch a call.
    Returns the backward's inputs."""
    from repro_torch.kernels import scan as sc
    before = bp.launches()
    got = sc.mamba_scan_fwd(*args, 64, keep)
    want = sc.mamba_scan_fwd_ref(*args, 64, keep)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert got[2].shape == want[2].shape
    assert _rel(got[0], want[0]) <= 1e-5
    states = want[2] if keep else sc.mamba_scan_fwd_ref(*args, 64, True)[2]
    g = torch.Generator(device="cuda").manual_seed(1)
    cot = [torch.randn(t.shape, generator=g, device="cuda")
           for t in got[:2]]
    bwd_args = (*args[:5], states, *cot, 64)
    gk = sc.mamba_scan_bwd(*bwd_args)
    gp = sc.mamba_scan_bwd_ref(*bwd_args)
    for x, y in zip(gk, gp):
        assert x.shape == y.shape and _rel(x, y) <= 1e-4
    after = bp.launches()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k in ("mamba_scan_fwd", "mamba_scan_bwd")) for k in after}
    torch.cuda.synchronize()
    return bwd_args


@pytest.mark.parametrize("d,n,b,s,keep", [
    (2048, 16, 1, 4096, True),     # jamba's 'model' block on (1, 4)
    (2048, 16, 2, 200, False),
    (8192, 16, 2, 63, False),
    (2048, 8, 1, 4096, True),
    (2048, 8, 2, 200, True),
    (2048, 8, 2, 64, False),
    (2048, 32, 1, 4096, True),
    (2048, 32, 2, 200, True),
    (2048, 32, 2, 1, False),
    (8192, 32, 2, 64, True),
    (100, 16, 2, 200, True),       # a ragged block of channels
    (6, 5, 2, 200, True),          # rows too narrow for 16-byte copies
])
def test_mamba_scan_kernels_at_other_widths(cuda, d, n, b, s, keep):
    """The selective scan's kernels at jamba's (1, 4) block of channels,
    at 8 and 32 states (the other lane groups), without kept states, and at
    ragged and unaligned widths, against the plain versions."""
    _mamba_case(_scan_args("mamba", b, s, seed=5, d=d, n=n), keep)


@pytest.mark.parametrize("d", [8192, 512])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_mamba_scan_fwd_both_splits(cuda, d, n):
    """The forward at two states a thread (8192 channels at B = 2, every
    lane group) and at one (512 channels), against the plain loop."""
    _mamba_case(_scan_args("mamba", 2, 200, seed=6, d=d, n=n), True)


GUARD = 4096   # floats of a known value either side of every buffer


def _guarded(shape, like=None, shift=0):
    """A (buffer, view) pair: a contiguous ``shape`` view at ``shift``
    floats past a guard of ``GUARD`` NaNs (inputs, holding ``like``) or of
    -7.25 (outputs and scratch, the view filled too), with a guard after
    it."""
    numel = math.prod(shape)
    fill = float("nan") if like is not None else -7.25
    buf = torch.full((numel + 2 * GUARD + shift,), fill, device="cuda")
    view = buf[GUARD + shift:GUARD + shift + numel].view(shape)
    if like is not None:
        view.copy_(like)
    return buf, view


def _guards_hold(buf, numel, shift):
    for g in (buf[:GUARD + shift], buf[GUARD + shift + numel:]):
        if not torch.equal(g, torch.full_like(g, -7.25)):
            return False
    return True


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("b,s,d,n", [
    (1, 4096, 8192, 16),    # jamba's widths, split 2
    (4, 4096, 8192, 16),    # batch 4 (phase 18 (a) serves it), split 2
    (2, 200, 2048, 16),     # split 1, a ragged last chunk
    (2, 64, 8192, 8),
    (2, 63, 100, 32),       # a ragged block of channels
    (2, 200, 6, 5),         # rows too narrow for 16-byte copies
])
def test_mamba_scan_kernels_stay_in_bounds(cuda, b, s, d, n, shift):
    """Each buffer of both Mamba kernels inside guards: NaNs around the
    inputs (a read past one reaches the outputs), a known value around the
    outputs and scratch (a write past one changes it), every pointer
    16-byte aligned (shift 0) or not (shift 1, the per-float copies).  The
    guards hold, and three launches give the wrappers' bits."""
    from repro_torch.kernels import scan as sc
    args = _scan_args("mamba", b, s, seed=8, d=d, n=n)
    y_w, hf_w, st_w = sc.mamba_scan_fwd(*args, 64, True)
    g = torch.Generator(device="cuda").manual_seed(9)
    dy, dhf = (torch.randn(t.shape, generator=g, device="cuda")
               for t in (y_w, hf_w))
    want = sc.mamba_scan_bwd(*args[:5], st_w, dy, dhf, 64)
    ins = [_guarded(t.shape, t, shift) for t in (*args, st_w, dy, dhf)]
    x, dt, bm, cm, a, h0, st_in, dy_in, dhf_in = (v for _, v in ins)
    tiles = sc._lib().mamba_scan_tiles(d, n)
    fwd_outs = [_guarded(t.shape, shift=shift) for t in (y_w, hf_w, st_w)]
    bwd_outs = [_guarded(shape, shift=shift) for shape in (
        (b, s, d), (b, s, d), (b, s, n), (b, s, n), (d, n), (b, d, n),
        (b, tiles, s, n), (b, tiles, s, n), (b, d, n))]
    dx, ddt, db, dc, da, dh0, part_db, part_dc, part_da = (
        v for _, v in bwd_outs)
    for _ in range(3):
        sc._run("mamba_scan_fwd", x, x, dt, bm, cm, a, h0,
                *(v for _, v in fwd_outs), b, s, d, n, 64, 1)
        sc._run("mamba_scan_bwd", x, x, dt, bm, cm, a, st_in, dy_in, dhf_in,
                dx, ddt, part_db, part_dc, part_da, db, dc, da, dh0, b, s, d,
                n, 64)
        torch.cuda.synchronize()
        for (_, v), w in zip(fwd_outs, (y_w, hf_w, st_w)):
            assert torch.equal(v, w)
        for v, w in zip((dx, ddt, db, dc, da, dh0), want):
            assert torch.equal(v, w)
    for buf, v in fwd_outs + bwd_outs:
        assert _guards_hold(buf, v.numel(), shift)
    for buf, v in ins:
        assert buf[:GUARD + shift].isnan().all()
        assert buf[GUARD + shift + v.numel():].isnan().all()


@pytest.mark.parametrize("d", [8192, 2048])
def test_mamba_scan_bwd_is_deterministic(cuda, d):
    """Two calls of ``mamba_scan_bwd`` on the same inputs give the same
    bits: every sum over channels, blocks and clusters has a fixed
    order."""
    from repro_torch.kernels import scan as sc
    bwd_args = _mamba_case(_scan_args("mamba", 1, 4096, seed=7, d=d), True)
    first = sc.mamba_scan_bwd(*bwd_args)
    second = sc.mamba_scan_bwd(*bwd_args)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("b", [2, 4])
def test_mamba_scan_fwd_at_either_split_gives_the_same_states(cuda, b):
    """``mamba_scan_fwd_at_split`` at one and at two states a thread, at
    jamba's widths and B x 200: the kept and final states the plain loop's
    bits at both, y within 1e-5 of max|y|; the wrappers' own pick is one
    of them and gives the same states."""
    from repro_torch.kernels import scan as sc
    args = _scan_args("mamba", b, 200, seed=10)
    want = sc.mamba_scan_fwd_ref(*args, 64, True)
    for split in (1, 2):
        got = sc.mamba_scan_fwd_at_split(split, *args, 64, True)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        assert _rel(got[0], want[0]) <= 1e-5
    assert sc._lib().mamba_scan_fwd_pick(b, 8192, 16) in (1, 2)
    with pytest.raises(ValueError, match="split"):
        sc.mamba_scan_fwd_at_split(3, *args, 64, True)


def _wkv6_case(args, chunk, keep=True):
    """``wkv6_fwd`` and ``wkv6_bwd`` on ``args`` against their plain
    versions: the kept and final states bit for bit, out within 1e-5 of
    max|out|, every gradient within 1e-4 of its largest |value|, one launch
    a call.  Returns the backward's inputs."""
    from repro_torch.kernels import scan as sc
    before = bp.launches()
    got = sc.wkv6_fwd(*args, chunk, keep)
    want = sc.wkv6_fwd_ref(*args, chunk, keep)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert got[2].shape == want[2].shape
    assert _rel(got[0], want[0]) <= 1e-5
    states = want[2] if keep else sc.wkv6_fwd_ref(*args, chunk, True)[2]
    g = torch.Generator(device="cuda").manual_seed(1)
    cot = [torch.randn(t.shape, generator=g, device="cuda")
           for t in got[:2]]
    bwd_args = (*args[:5], states, *cot, chunk)
    gk = sc.wkv6_bwd(*bwd_args)
    gp = sc.wkv6_bwd_ref(*bwd_args)
    for x, y in zip(gk, gp):
        assert x.shape == y.shape and _rel(x, y) <= 1e-4
    after = bp.launches()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k in ("wkv6_fwd", "wkv6_bwd")) for k in after}
    torch.cuda.synchronize()
    return bwd_args


@pytest.mark.parametrize("chunk", [1, 17, 64])
@pytest.mark.parametrize("h", [40, 3])
@pytest.mark.parametrize("b", [1, 2, 4])
def test_wkv6_kernels_at_other_batches_heads_and_chunks(cuda, b, h, chunk):
    """The wkv6 kernels at B = 1, 2, 4, at rwkv6-3b's 40 heads and at 3,
    with the kept states every 1, 17 (ragged windows and pieces) and 64
    steps, 200 steps, against the plain versions."""
    _wkv6_case(_scan_args("wkv6", b, 200, seed=11, d=h), chunk)


@pytest.mark.parametrize("s,chunk,keep", [(1, 64, True), (31, 17, False),
                                          (4096, 64, True)])
def test_wkv6_kernels_at_the_sequence_s_edges(cuda, s, chunk, keep):
    """One step (decode), a sequence shorter than a piece without kept
    states, and 1 x 4096 at rwkv6-3b's widths."""
    _wkv6_case(_scan_args("wkv6", 1, s, seed=12), chunk, keep)


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("b,s,h,chunk", [
    (1, 4096, 40, 64),      # rwkv6-3b's widths, 1 x 4096
    (2, 200, 3, 17),        # ragged chunks, windows and pieces
    (4, 63, 40, 64),        # batch 4, one ragged chunk
    (2, 5, 2, 1),           # a state kept every step
])
def test_wkv6_kernels_stay_in_bounds(cuda, b, s, h, chunk, shift):
    """Each buffer of both wkv6 kernels inside guards: NaNs around the
    inputs (a read past one reaches the outputs), a known value around the
    outputs and the workspace (a write past one changes it), every pointer
    16-byte aligned (shift 0) or not (shift 1, the per-float copies).  The
    guards hold, and three launches give the wrappers' bits."""
    from repro_torch.kernels import scan as sc
    args = _scan_args("wkv6", b, s, seed=13, d=h)
    out_w, sf_w, st_w = sc.wkv6_fwd(*args, chunk, True)
    g = torch.Generator(device="cuda").manual_seed(14)
    dout, dsf = (torch.randn(t.shape, generator=g, device="cuda")
                 for t in (out_w, sf_w))
    want = sc.wkv6_bwd(*args[:5], st_w, dout, dsf, chunk)
    ws = sc.wkv6_bwd_workspace(*args[:5], st_w, dout, dsf, chunk)
    assert ws == {"du_part": (b, h, 64)}
    ins = [_guarded(t.shape, t, shift) for t in (*args, st_w, dout, dsf)]
    r, k, v, w, u, s0, st_in, dout_in, dsf_in = (x for _, x in ins)
    fwd_outs = [_guarded(t.shape, shift=shift) for t in (out_w, sf_w, st_w)]
    bwd_outs = [_guarded(shape, shift=shift) for shape in (
        (b, s, h, 64), (b, s, h, 64), (b, s, h, 64), (b, s, h, 64),
        (h, 64), (b, h, 64, 64), ws["du_part"])]
    dr, dk, dv, dw, du, ds0, du_part = (x for _, x in bwd_outs)
    for _ in range(3):
        sc._run("wkv6_fwd", r, r, k, v, w, u, s0,
                *(x for _, x in fwd_outs), b, s, h, chunk, 1)
        sc._run("wkv6_bwd", r, r, k, v, w, u, st_in, dout_in, dsf_in, dr,
                dk, dv, dw, du_part, du, ds0, b, s, h, chunk)
        torch.cuda.synchronize()
        for (_, x), y in zip(fwd_outs, (out_w, sf_w, st_w)):
            assert torch.equal(x, y)
        for x, y in zip((dr, dk, dv, dw, du, ds0), want):
            assert torch.equal(x, y)
    for buf, x in fwd_outs + bwd_outs:
        assert _guards_hold(buf, x.numel(), shift)
    for buf, x in ins:
        assert buf[:GUARD + shift].isnan().all()
        assert buf[GUARD + shift + x.numel():].isnan().all()


def test_wkv6_bwd_is_deterministic(cuda):
    """Two calls of ``wkv6_bwd`` at rwkv6-3b's widths and 1 x 4096 give the
    same bits: every sum (over lanes and steps, g . v over the warps, du
    over the row's lanes and the batch) has a fixed order."""
    from repro_torch.kernels import scan as sc
    bwd_args = _wkv6_case(_scan_args("wkv6", 1, 4096, seed=15), 64)
    first = sc.wkv6_bwd(*bwd_args)
    second = sc.wkv6_bwd(*bwd_args)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_the_declared_workspace_is_the_kernels_own(cuda):
    """The Mamba backward's partials' clusters, as ``kernels/scan.py``
    declares them (``_mamba_tiles``, which ``OpAnalysis`` reads on
    ``meta``), are the kernel's grid's, at every lane group and ragged
    widths."""
    from repro_torch.kernels import scan as sc
    for d in (1, 6, 100, 127, 128, 129, 2048, 8192):
        for n in (1, 5, 8, 9, 16, 17, 32):
            assert sc._mamba_tiles(d, n) == sc._lib().mamba_scan_tiles(d, n)


@pytest.mark.parametrize("kind", ["wkv6", "mamba"])
def test_scan_autograd_on_the_card_matches_the_plain_loop(cuda, kind):
    """The differentiable scan (the kernels under autograd, keeping the
    chunk states) against autograd through the loop on the card, 2 x 200
    steps: outputs within 1e-5, every input's gradient within 1e-4."""
    import functools
    from repro_torch.kernels import scan as sc
    from repro_torch.models import ssm
    args = _scan_args(kind, 2, 200, seed=3)
    a = [t.clone().requires_grad_() for t in args]
    b_ = [t.clone().requires_grad_() for t in args]
    if kind == "wkv6":
        out, fin = sc.wkv6(*a, 64)
        fin_l, out_l = ssm._steps(functools.partial(
            ssm._rwkv_step, b_[4][None, :, :, None]), b_[5], *b_[:4])
    else:
        out, fin = sc.mamba_scan(*a, 64)
        fin_l, out_l = ssm._steps(functools.partial(ssm._mamba_step, b_[4]),
                                  b_[5], *b_[:4])
    assert torch.equal(fin, fin_l) and _rel(out, out_l) <= 1e-5
    g = torch.Generator(device="cuda").manual_seed(4)
    cot = [torch.randn(t.shape, generator=g, device="cuda")
           for t in (out, fin)]
    ga = torch.autograd.grad((out * cot[0]).sum() + (fin * cot[1]).sum(), a)
    gb = torch.autograd.grad((out_l * cot[0]).sum()
                             + (fin_l * cot[1]).sum(), b_)
    for x, y in zip(ga, gb):
        assert _rel(x, y) <= 1e-4


def test_scan_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels import scan as sc
    args = _scan_args("wkv6", 1, 8)
    with pytest.raises(TypeError):
        sc.wkv6_fwd(*[t.double() for t in args], 64, False)
    with pytest.raises(ValueError, match="chunk"):
        sc.wkv6_fwd(*args, 65, False)
    with pytest.raises(ValueError, match="contiguous"):
        sc.wkv6_fwd(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                    *args[1:], 64, False)


# ------------------------------------------------ the lossless codec's kernels

LOSSLESS_SIZES = (1, 2, 31, 4095, 4096, 4097, 32767, 32768, 32769, 65537)
# (B, S) buckets of short rows (phase 9's kind) and either side of the
# stats' tile rule: 263 x 16,384 takes 8,192-symbol tiles, 264 x 16,384
# 16,384-symbol ones (kStatsBlocks); 64 x 65,537: 16,384, one cluster of 8
# blocks a row; 1 x 32,769 (in LOSSLESS_SIZES): 9 tiles, two clusters; the
# pack's tickets of two chunks (199 x 16,385, a row's last of one) and of
# four (400 x 16,384)
LOSSLESS_BUCKETS = ((64, 4096), (64, 65537), (263, 16384), (264, 16384),
                    (199, 16385), (400, 16384))


def _lossless_rows(kind, b, s, rng):
    """(B, S) uint8 rows of one content: skewed, all-zero, uniform, runs,
    or one symbol."""
    if kind == "skewed":
        return (rng.geometric(0.3, (b, s)) % 256).astype(np.uint8)
    if kind == "zeros":
        return np.zeros((b, s), np.uint8)
    if kind == "uniform":
        return rng.integers(0, 256, (b, s)).astype(np.uint8)
    if kind == "runs":
        reps = rng.integers(1, 300, (b, s // 20 + 2))
        vals = rng.integers(0, 4, (b, s // 20 + 2))
        return np.stack([np.repeat(v, r)[:s] for v, r in zip(vals, reps)]
                        ).astype(np.uint8)
    return np.full((b, s), (7 + b) % 256, np.uint8)


def _lossless_inputs(x):
    """Each row's codebook (from its histogram), the plain pack of ``x``
    with them, the decode tables, and the plain RLE scan's runs: the
    kernels' inputs, all on ``x``'s device."""
    from repro_torch.core import lossless as ll
    hist = lb._group_stats_plain(x.cpu())[0].numpy()
    books = [ll.build_codebook(h) for h in hist]
    lt, ct = (torch.from_numpy(np.stack([bk[i] for bk in books]
                                        ).astype(np.int64)).to(x.device)
              for i in (0, 1))
    words, total, offs = ll._huffman_pack_plain(x, lt, ct)
    luts = [ll._build_decode_lut(*bk) for bk in books]
    ls, ln = (torch.from_numpy(np.stack([lu[i] for lu in luts])
                               ).to(x.device) for i in (0, 1))
    pv, pl, pn = ll._rle_scan_plain(x)
    rr = int(pn.max())
    return dict(lt=lt, ct=ct, words=words, total=total,
                offs=offs.contiguous(), ls=ls, ln=ln, pv=pv, pl=pl, pn=pn,
                rv=pv[:, :rr].contiguous(),
                rl=pl[:, :rr].to(torch.int32).contiguous())


def _lossless_match(x):
    """Every lossless kernel against its plain version on ``x``, byte for
    byte (rle_scan: nruns and each row's first nruns slots)."""
    from repro_torch.core import lossless as ll
    from repro_torch.kernels import lossless as kl
    b, s = x.shape
    a = _lossless_inputs(x)
    for got, want in zip(kl.lossless_stats(x), lb._group_stats_plain(x)):
        assert torch.equal(got, want)
    for got, want in zip(kl.huffman_pack(x, a["lt"], a["ct"]),
                         (a["words"], a["total"], a["offs"])):
        assert got.dtype == want.dtype and torch.equal(got, want)
    dec_args = (a["words"], a["offs"], a["ls"], a["ln"], s)
    assert torch.equal(kl.huffman_decode(*dec_args), x)
    vals, lens, nruns = kl.rle_scan(x)
    assert torch.equal(nruns, a["pn"])
    for r in range(b):
        k = int(a["pn"][r])
        assert torch.equal(vals[r, :k], a["pv"][r, :k])
        assert torch.equal(lens[r, :k].to(torch.int64) & 0xFFFF,
                           a["pl"][r, :k])
    out = kl.rle_expand(a["rv"], a["rl"], s)
    assert torch.equal(out, ll._rle_expand_plain(a["rv"], a["rl"], s))
    assert torch.equal(out, x)
    # the read side at every lane count and at more slices than its own
    stored = int(((a["total"] + 31) // 32 + 1).max())
    for words in (a["words"], a["words"][:, :stored].contiguous()):
        for lanes in kl.LANES:
            assert torch.equal(kl._launch_decode(
                words, a["offs"], a["ls"], a["ln"], s, lanes=lanes), x)
    for slices in (1, 3):
        assert torch.equal(kl._launch_rle_expand(a["rv"], a["rl"], s,
                                                 slices=slices), x)


def _on(cuda, args):
    return [t.to(cuda) if isinstance(t, torch.Tensor) else t for t in args]


def _lossless_edges_match(cuda):
    """The read side's hand-made edges (``tests/_lossless_cases.py``): the
    decode at every lane count and at its own, the expand at 1 and 3
    slices and at its own, each the plain pass's bytes; the decode walks
    serially the chunks that must be so walked and no other."""
    from repro_torch.core import lossless as ll
    from repro_torch.kernels import lossless as kl
    for name, args in cases.decode_cases().items():
        args = _on(cuda, args)
        want = ll._huffman_unpack_plain(*args)
        for lanes in (0,) + kl.LANES:
            kl.reset_decode_walks()
            got = kl._launch_decode(*args, lanes=lanes)
            walks = kl.decode_walks()
            assert torch.equal(got, want), (name, lanes)
            assert (walks["serial"] > 0) == (name in cases.SERIAL), (
                name, lanes, walks)
            if name == cases.ROUNDS:
                assert walks["max_rounds"] >= 2, (lanes, walks)
    for name, args in cases.expand_cases().items():
        values, lengths, n = _on(cuda, args)
        want = ll._rle_expand_plain(values, lengths, n)
        for slices in (0, 1, 3):
            assert torch.equal(kl._launch_rle_expand(values, lengths, n,
                                                     slices=slices),
                               want), (name, slices)


@pytest.mark.parametrize("s,b", [(s, b) for s in LOSSLESS_SIZES
                                 for b in (1, 3)]
                         + [(s, b) for b, s in LOSSLESS_BUCKETS])
def test_lossless_kernels_match_plain(cuda, s, b):
    """Each of the five lossless kernels byte-identical to its plain
    version at either side of a chunk (4096) and an RLE tile (32768), rows
    of any length (unaligned rows past the first), five contents, and on
    buckets of many short rows and either side of the stats' tile rule;
    the decode at every lane count, words at the pack's width and cut to
    the stored one, the expand at 1 and 3 slices; and (B = 1) the read
    side's hand-made edges."""
    rng = np.random.default_rng(s * 7 + b)
    for kind in ("skewed", "zeros", "uniform", "runs", "one"):
        _lossless_match(torch.from_numpy(_lossless_rows(kind, b, s, rng)
                                         ).to(cuda))
    if b == 1:
        _lossless_edges_match(cuda)


@pytest.mark.parametrize("s", [20, 4097])
def test_lossless_kernels_split_rows_past_max_batch(cuda, s):
    """A bucket of more rows than a grid's y extent (65,535) is split into
    launches (the pack's tickets span every row), and gives the plain
    versions' bytes (one codebook for every row; the decode and the expand
    give the rows back), at one chunk a row and at two."""
    from repro_torch.core import lossless as ll
    from repro_torch.kernels import lossless as kl
    b = bp.MAX_BATCH + 3
    rows = _lossless_rows("skewed", b, s, np.random.default_rng(5))
    x = torch.from_numpy(rows).to(cuda)
    for got, want in zip(kl.lossless_stats(x), lb._group_stats_plain(x)):
        assert torch.equal(got, want)
    book = ll.build_codebook(np.bincount(rows.reshape(-1), minlength=256))
    lt, ct = (torch.from_numpy(t.astype(np.int64)).to(cuda).expand(b, 256)
              .contiguous() for t in book)
    want = ll._huffman_pack_plain(x, lt, ct)
    for got, w in zip(kl.huffman_pack(x, lt, ct), want):
        assert torch.equal(got, w)
    ls, ln = (torch.from_numpy(t).to(cuda).expand(b, 1 << 16).contiguous()
              for t in ll._build_decode_lut(*book))
    assert torch.equal(kl.huffman_decode(want[0], want[2].contiguous(), ls,
                                         ln, s), x)
    vals, lens, nruns = kl.rle_scan(x)
    pv, pl, pn = ll._rle_scan_plain(x)
    assert torch.equal(nruns, pn)
    live = torch.arange(s, device=cuda)[None, :] < pn[:, None]
    assert torch.equal(vals[live], pv[live])
    assert torch.equal(lens.to(torch.int64)[live] & 0xFFFF, pl[live])
    rr = int(pn.max())
    assert torch.equal(kl.rle_expand(pv[:, :rr].contiguous(),
                                     pl[:, :rr].to(torch.int32).contiguous(),
                                     s), x)


def test_lossless_kernels_are_deterministic(cuda):
    """Two calls give the same bits (the stats' atomics add integers, its
    clusters arrive in any order, the pack's chunks and the expand's tiles
    take tickets in any order), on buckets of short rows and either side
    of the stats' tile rule too, and the read side's hand-made edges."""
    from repro_torch.kernels import lossless as kl
    rng = np.random.default_rng(6)
    x = torch.from_numpy(_lossless_rows("skewed", 3, 300_001, rng)).to(cuda)
    a = _lossless_inputs(x)
    calls = [lambda: kl.lossless_stats(x),
             lambda: kl.huffman_pack(x, a["lt"], a["ct"]),
             lambda: (kl.huffman_decode(a["words"], a["offs"], a["ls"],
                                        a["ln"], x.shape[1]),),
             lambda: kl.rle_scan(x)[2:],
             lambda: (kl.rle_expand(a["rv"], a["rl"], x.shape[1]),)]
    for b, s in LOSSLESS_BUCKETS:
        xb = torch.from_numpy(_lossless_rows("skewed", b, s, rng)).to(cuda)
        ab = _lossless_inputs(xb)
        calls += [lambda xb=xb: kl.lossless_stats(xb),
                  lambda xb=xb, ab=ab: kl.huffman_pack(xb, ab["lt"],
                                                       ab["ct"])]
    # the read side's hand-made edges, at 32 and 128 lanes and 3 slices
    for args in cases.decode_cases().values():
        for lanes in (32, 128):
            calls.append(lambda args=_on(cuda, args), lanes=lanes: (
                kl._launch_decode(*args, lanes=lanes),))
    for args in cases.expand_cases().values():
        calls.append(lambda args=_on(cuda, args): (
            kl._launch_rle_expand(*args, slices=3),))
    for call in calls:
        first, second = call(), call()
        assert all(torch.equal(p, q) for p, q in zip(first, second))


BYTE_GUARD = 4096   # bytes of a known value either side of every buffer


def _byte_guarded(numel, dtype, shift, like=None):
    """(buffer, view): a contiguous ``dtype`` view of ``numel`` elements
    ``shift`` elements past a guard of ``BYTE_GUARD`` bytes of 0xA5, with
    a guard after it; the view holds ``like`` (an input) or 0xA5 bytes."""
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = numel * size
    buf = torch.full((nbytes + 2 * BYTE_GUARD + shift * size + 16,), 0xA5,
                     dtype=torch.uint8, device="cuda")
    lo = BYTE_GUARD + shift * size
    view = buf[lo:lo + nbytes].view(dtype)
    if like is not None:
        view.copy_(like.reshape(-1))
    return buf, view, lo


def _byte_guards_hold(buf, lo, nbytes):
    return bool((buf[:lo] == 0xA5).all()) and bool(
        (buf[lo + nbytes:] == 0xA5).all())


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("b,s", [(1, 4097), (3, 65537), (2, 31)]
                         + list(LOSSLESS_BUCKETS[:2]))
def test_lossless_kernels_stay_in_bounds(cuda, b, s, shift):
    """Every output and scratch buffer of the five kernels inside guards of
    a known byte, every pointer 16-byte aligned (shift 0) or not (shift 1
    element), on rows of one and of several stats clusters and on buckets
    of short rows: the outputs are the plain versions' and no guard byte
    changes, over three launches (the decode at 32, 128 and its own
    lanes, the expand at 1, 3 and its own slices), the stats', the pack's
    and the RLE scan's outputs refilled with the guard byte before each,
    so that every element must be written (the scan's: nruns and each
    row's first nruns slots); then the read side's and the scan's
    hand-made edges, guarded alike."""
    from repro_torch.kernels import lossless as kl
    rng = np.random.default_rng(b * s + shift)
    x0 = torch.from_numpy(_lossless_rows("skewed", b, s, rng)).to(cuda)
    a = _lossless_inputs(x0)
    outs = []

    def inp(t):
        return _byte_guarded(t.numel(), t.dtype, shift, t)[1].view(t.shape)

    def out(shape, dtype):
        buf, view, lo = _byte_guarded(int(np.prod(shape)), dtype, shift)
        outs.append((buf, lo, view.numel() * view.element_size()))
        return view.view(shape)

    x = inp(x0)
    chunks, tiles = -(-s // kl.CHUNK), -(-s // kl.RLE_BREAK)
    cap = a["words"].shape[1]
    r = a["rv"].shape[1]
    rt = -(-r // kl.EXPAND_TILE)
    lt, ct, words, offs, ls, ln, rv, rl = (inp(a[k]) for k in (
        "lt", "ct", "words", "offs", "ls", "ln", "rv", "rl"))
    hist, nruns = out((b, 256), torch.int64), out((b,), torch.int64)
    ws = {k: out(*v) for k, v in kl.lossless_stats_workspace(x).items()}
    sums = ws.get("sums")
    pw, pt, po = (out((b, cap), torch.int32), out((b,), torch.int64),
                  out((b, chunks), torch.int64))
    written = [hist, nruns, pw, pt, po]
    (pstat,) = (out(*v) for v in kl.huffman_pack_workspace(
        x, lt, ct).values())
    dec = out((b, s), torch.uint8)
    vals, lens, rn = (out((b, s), torch.uint8), out((b, s), torch.int16),
                      out((b,), torch.int64))
    (rstat,) = (out(*v) for v in kl.rle_scan_workspace(x).values())
    prim = out((b, 1 << kl.PRIMARY_BITS), torch.int16)
    walks = out((len(kl.WALKS),), torch.int64)
    exp, status = out((b, s), torch.uint8), out((b * rt + 1,), torch.int64)
    written += [vals, lens, rn]
    walks.zero_()
    for lanes, slices in ((32, 1), (128, 3), (0, 0)):
        for t in written:
            t.view(torch.uint8).fill_(0xA5)
        kl._run("lossless_stats", x, x, b, s, hist, nruns, sums)
        kl._run("huffman_pack", x, x, b, s, lt, ct, pstat, po, pt, pw, cap)
        kl._run("huffman_decode", x, words, b, cap, offs, chunks, ls, ln,
                prim, walks, lanes, dec, s)
        kl._run("rle_scan", x, x, b, s, rstat, vals, lens, rn)
        kl._run("rle_expand", x, rv, rl, b, r, status, slices, exp, s)
        torch.cuda.synchronize()
        for got, want in zip((hist, nruns), lb._group_stats_plain(x0)):
            assert torch.equal(got, want)
        assert torch.equal(pw, a["words"]) and torch.equal(pt, a["total"])
        assert torch.equal(po, a["offs"])
        assert torch.equal(dec, x0) and torch.equal(exp, x0)
        assert torch.equal(rn, a["pn"])
        for row in range(b):
            k = int(a["pn"][row])
            assert torch.equal(vals[row, :k], a["pv"][row, :k])
            assert torch.equal(lens[row, :k].to(torch.int64) & 0xFFFF,
                               a["pl"][row, :k])
    assert int(walks[1]) == 0 and int(walks[0]) == 3 * b * chunks
    from repro_torch.core import lossless as ll
    for args in cases.decode_cases().values():
        words, offs, ls, ln = (inp(t.to(cuda)) for t in args[:4])
        n = args[4]
        dec = out((words.shape[0], n), torch.uint8)
        prim = out((words.shape[0], 1 << kl.PRIMARY_BITS), torch.int16)
        for lanes in (32, 128):
            kl._run("huffman_decode", words, words, words.shape[0],
                    words.shape[1], offs, offs.shape[1], ls, ln, prim, walks,
                    lanes, dec, n)
            assert torch.equal(dec, ll._huffman_unpack_plain(
                words, offs, ls, ln, n))
    for values, lengths, n in cases.expand_cases().values():
        values, lengths = inp(values.to(cuda)), inp(lengths.to(cuda))
        rows, r = values.shape
        exp = out((rows, n), torch.uint8)
        status = out((rows * -(-r // kl.EXPAND_TILE) + 1,), torch.int64)
        for slices in (1, 3):
            kl._run("rle_expand", values, values, lengths, rows, r, status,
                    slices, exp, n)
            assert torch.equal(exp, ll._rle_expand_plain(values, lengths, n))
    for rows_ in cases.scan_cases().values():
        xs = inp(rows_.to(cuda))
        rows, n = xs.shape
        sv, sl, sn = (out((rows, n), torch.uint8), out((rows, n), torch.int16),
                      out((rows,), torch.int64))
        (st,) = (out(*v) for v in kl.rle_scan_workspace(xs).values())
        pv, pl, pn = ll._rle_scan_plain(xs)
        for _ in range(2):
            for t in (sv, sl, sn):
                t.view(torch.uint8).fill_(0xA5)
            kl._run("rle_scan", xs, xs, rows, n, st, sv, sl, sn)
            assert torch.equal(sn, pn)
            for row in range(rows):
                k = int(pn[row])
                assert torch.equal(sv[row, :k], pv[row, :k])
                assert torch.equal(sl[row, :k].to(torch.int64) & 0xFFFF,
                                   pl[row, :k])
    for buf, lo, nbytes in outs:
        assert _byte_guards_hold(buf, lo, nbytes)


def test_engine_groups_walk_no_chunk_serially(cuda):
    """The plane groups of a write on the card, encoded with Huffman forced
    and decoded by ``decode_segments``: every chunk on the decode's lanes,
    none walked serially, the blobs back."""
    from repro_torch.core import lossless as ll
    from repro_torch.kernels import lossless as kl
    seen = []
    was = lb._encode_buckets

    def rec(stacked, *args, **kw):
        seen.extend(stacked.values())
        return was(stacked, *args, **kw)
    lb._encode_buckets = rec
    try:
        rf.refactor_array(gaussian_field((50, 100, 100), slope=-2.0, seed=7),
                          "g", device=cuda)
    finally:
        lb._encode_buckets = was
    segs = lb.encode_groups_stacked(seen, ll.HybridConfig(force="huffman"))
    chunks = sum(-(-st.shape[1] // kl.CHUNK) * st.shape[0] for st in seen)
    kl.reset_decode_walks()
    got = lb.decode_segments(segs, device=cuda)
    walks = kl.decode_walks()
    rows = [r for st in seen for r in st.cpu().numpy()]
    assert all(np.array_equal(d, r) for d, r in zip(got, rows))
    assert walks["chunks"] == chunks and walks["serial"] == 0, walks


def test_rle_expand_launches_at_most_two_a_call(cuda):
    """One ``rle_expand`` call is at most two device activities, the status
    words' zeroing and the one pass (the nodes of a CUDA graph of the
    call), and gives the plain pass's bytes."""
    from repro_torch.core import lossless as ll
    from repro_torch.kernels import bitplane as bp
    from repro_torch.kernels import lossless as kl
    for values, lengths, n in cases.expand_cases().values():
        values, lengths = values.to(cuda), lengths.to(cuda)
        acts = bp.device_activities(lambda: kl.rle_expand(values, lengths, n))
        assert any("rle_expand_kernel" in k for k in acts), acts
        assert sum(acts.values()) <= 2, acts
        got = kl.rle_expand(values, lengths, n)
        assert torch.equal(got, ll._rle_expand_plain(values, lengths, n))


def test_rle_scan_at_the_edges(cuda):
    """``rle_scan`` on the scan's hand-made edges (``tests/_lossless_cases.py``:
    rows of RLE_BREAK and either side, one run over three tiles, every
    neighbour distinct, S = 1, unaligned rows, runs either side of a
    segment, a step and a piece, a tile's last symbol alone): the plain
    pass's nruns and runs, two calls the same, at most two device
    activities a call (the status words' zeroing and the one pass, no
    count kernel and no row scan)."""
    from repro_torch.core import lossless as ll
    from repro_torch.kernels import lossless as kl
    for name, rows in cases.scan_cases().items():
        x = rows.to(cuda)
        pv, pl, pn = ll._rle_scan_plain(x)
        first, again = kl.rle_scan(x), kl.rle_scan(x)
        for vals, lens, nruns in (first, again):
            assert torch.equal(nruns, pn), name
            for r in range(x.shape[0]):
                k = int(pn[r])
                assert torch.equal(vals[r, :k], pv[r, :k]), name
                assert torch.equal(lens[r, :k].to(torch.int64) & 0xFFFF,
                                   pl[r, :k]), name
        acts = bp.device_activities(lambda: kl.rle_scan(x))
        assert sum("rle_scan_kernel" in k for k in acts) == 1, (name, acts)
        assert sum(acts.values()) <= 2, (name, acts)
        assert not any("rle_count" in k or "row_scan" in k
                       or "rle_emit" in k for k in acts), (name, acts)


@pytest.mark.parametrize("b,s", [(1, 4097), (1, 32769), (3, 300_001)]
                         + list(LOSSLESS_BUCKETS))
def test_write_side_launches_at_most_two_a_call(cuda, b, s):
    """One ``lossless_stats``, ``huffman_pack`` and ``rle_scan`` call are
    at most two device activities each (the nodes of a CUDA graph of the
    call): the stats' one pass and, where a row has more than one cluster,
    the zeroing of its row sums; the pack's and the scan's status words'
    zeroing and their one pass, with no bit-count pass, no count kernel and
    no row scan.  Each gives the plain pass's bytes (the scan's: nruns and
    each row's first nruns runs)."""
    from repro_torch.kernels import bitplane as bp
    from repro_torch.kernels import lossless as kl
    x = torch.from_numpy(_lossless_rows("skewed", b, s,
                                        np.random.default_rng(b + s))
                         ).to(cuda)
    a = _lossless_inputs(x)
    calls = {"stats_kernel": (lambda: kl.lossless_stats(x),
                              lb._group_stats_plain(x)),
             "huff_pack_kernel": (lambda: kl.huffman_pack(x, a["lt"],
                                                          a["ct"]),
                                  (a["words"], a["total"], a["offs"])),
             "rle_scan_kernel": (lambda: kl.rle_scan(x)[2:], (a["pn"],))}
    for kernel, (call, want) in calls.items():
        acts = bp.device_activities(call)
        assert sum(kernel in k for k in acts) == 1, acts
        assert sum(acts.values()) <= 2, acts
        assert not any("huff_bits" in k or "row_scan" in k
                       or "rle_count" in k for k in acts), acts
        got = call()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    vals, lens, nruns = kl.rle_scan(x)
    for r in range(b):
        k = int(a["pn"][r])
        assert torch.equal(vals[r, :k], a["pv"][r, :k])
        assert torch.equal(lens[r, :k].to(torch.int64) & 0xFFFF,
                           a["pl"][r, :k])


@pytest.mark.parametrize("force", [None, "huffman", "rle", "dc"])
def test_lossless_engine_on_the_card_equals_the_cpu(cuda, force):
    """``encode_groups_stacked`` and ``decode_segments`` on the card (the
    kernels) against the CPU (the plain passes) for every ``force`` mode:
    the same segment bytes, the same decoded blobs, and the kernels
    launched (none with ``backend="torch"``)."""
    from repro_torch.core import lossless as ll
    rng = np.random.default_rng(9)
    cfg = ll.HybridConfig(force=force)
    stacks = [np.stack([_lossless_rows(k, 1, 70_001, rng)[0] for k in
                        ("skewed", "zeros", "uniform", "runs", "one")]),
              _lossless_rows("skewed", 2, 4097, rng)]
    want = lb.encode_groups_stacked([torch.from_numpy(st) for st in stacks],
                                    cfg)
    before = bp.launches()
    got = lb.encode_groups_stacked(
        [torch.from_numpy(st).to(cuda) for st in stacks], cfg)
    assert [sg.to_bytes() for sg in got] == [sg.to_bytes() for sg in want]
    mid = bp.launches()
    assert mid["lossless_stats"] == before["lossless_stats"] + 2
    dec = lb.decode_segments(got, device=cuda)
    for d, row in zip(dec, [r for st in stacks for r in st]):
        assert np.array_equal(d, row)
    if force != "dc":
        assert bp.launches() != mid
    plain = bp.launches()
    again = lb.encode_groups_stacked(
        [torch.from_numpy(st).to(cuda) for st in stacks], cfg,
        backend="torch")
    assert [sg.to_bytes() for sg in again] == [sg.to_bytes() for sg in want]
    lb.decode_segments(got, device=cuda, backend="torch")
    assert bp.launches() == plain


def test_corrupt_chunk_offset_raises_before_the_card(cuda):
    """A Huffman segment whose chunk offset lies past its words raises
    ``ValueError`` on the host, before anything is uploaded, and the card
    goes on decoding."""
    from repro_torch.core import lossless as ll
    data = (np.random.default_rng(3).geometric(0.3, 9000) % 256
            ).astype(np.uint8)
    seg = ll.huffman_encode(data, device=cuda)
    bad = ll.Segment.from_bytes(seg.to_bytes())
    bad.payload["chunk_offs"][1] = 32 * bad.payload["words"].shape[0]
    with pytest.raises(ValueError, match="chunk offset"):
        lb.decode_segments([bad], device=cuda)
    with pytest.raises(ValueError, match="chunk offset"):
        ll.huffman_decode(bad, device=cuda)
    torch.cuda.synchronize()
    assert np.array_equal(lb.decode_segments([seg], device=cuda)[0], data)
