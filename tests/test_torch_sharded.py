"""The port's sharded engines and sharded kernel ops vs the JAX reference, on
the CPU (ports of tests/test_sharded.py).

Meshes are CPU shards of the host device (``make_chunk_mesh(n, "cpu")``), as
the reference's host-device meshes are.  Inputs are made with numpy from a
seed; the port runs with ``device="cpu"``.  Tolerance: none.  Chunk blobs
equal the reference's single-device blobs byte for byte on 1, 2 and 3
shards, with 3 host syncs per window; reads through ``engine_for`` are
bit-identical to the reference's reconstructions; the sharded kernel ops
equal the reference's unsharded batch ops (``backend="jnp"``) bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import pipeline as jpl  # noqa: E402
from repro.core import refactor as jrf  # noqa: E402
from repro.core import refactor_fused as jrff  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import lossless_batch as lb  # noqa: E402
from repro_torch.core import refactor as rf  # noqa: E402
from repro_torch.core import retrieve as rt  # noqa: E402
from repro_torch.core import sharded as shd  # noqa: E402
from repro_torch.data.fields import gaussian_field  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
DESIGNS = ["register_block", "locality", "shuffle"]
SIZES = (0, 1, 7, 1000, 4097)   # the reference's property-test sizes


def _field(n, seed):
    if n == 0:
        return np.zeros(0, np.float32)
    if n <= 4:
        return np.random.default_rng(seed).normal(size=n).astype(np.float32)
    return gaussian_field((n,), slope=-2.0, seed=seed % 89)


def _chunks():
    return [_field(n, 23 + i) for i, n in enumerate(SIZES + (2048,))]


# ------------------------------------------------------------- mesh plumbing

def test_make_chunk_mesh_on_the_cpu():
    assert shd.make_chunk_mesh(3, device="cpu") == [CPU] * 3
    assert shd.make_chunk_mesh(device="cpu") == [CPU]
    assert shd.resolve_mesh(2, "cpu") == shd.make_chunk_mesh(2, "cpu")
    with pytest.raises(ValueError, match=">= 1"):
        shd.make_chunk_mesh(0, device="cpu")
    with pytest.raises(TypeError, match="mesh must be"):
        shd.resolve_mesh("chunk", "cpu")


def test_make_chunk_mesh_counts_cards(monkeypatch):
    """With two cards visible, None takes both, and more than two raise
    with the reference's message (no card is touched: a mesh is a list)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert shd.make_chunk_mesh() == cards
    assert shd.make_chunk_mesh(1) == cards[:1]
    assert shd.resolve_mesh(2) == cards
    with pytest.raises(ValueError, match="requested 4 devices, only 2"):
        shd.make_chunk_mesh(4)


# ---------------------------------------------------------------- write side

@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_refactor_chunks_match_reference(n_shards, levels):
    """Blobs on 1, 2 and 3 shards equal the reference's single-device fused
    blobs (empty and tiny chunks included), 3 host syncs per window (a
    window of only the empty chunk has no rows to encode: 1, as in the
    reference)."""
    chunks = _chunks()
    plan = shd.ShardedRefactorPlan(shd.make_chunk_mesh(n_shards, "cpu"),
                                   levels=levels, device="cpu")
    shd.STATS.reset()
    with lb.stats_scope() as st:
        outs = plan.refactor_chunks(chunks, name="v")
    windows = -(-len(chunks) // n_shards)
    empty = sum(all(c.size == 0 for c in chunks[w:w + n_shards])
                for w in range(0, len(chunks), n_shards))
    assert st.host_syncs == 3 * windows - 2 * empty
    snap = shd.STATS.snapshot()
    assert snap["rounds"] == windows
    assert snap["chunks_finished"] == len(chunks)
    assert snap["dispatches_by_device"] == {
        k: len(range(k, len(chunks), n_shards)) for k in range(n_shards)}
    for i, (x, got) in enumerate(zip(chunks, outs)):
        want = jrff.refactor_fused(x, name=f"v.{i}", levels=levels)
        assert rf.refactored_to_bytes(got) == jrf.refactored_to_bytes(want)


def test_batched_finish_costs_three_syncs_total():
    """``finish_many`` (and its alias ``finish_round``) resolves a round of
    dispatched chunks in 3 host syncs flat; dispatching makes none."""
    chunks = [_field(2048, 1), _field(2048, 2)]
    plan = shd.ShardedRefactorPlan(shd.make_chunk_mesh(2, "cpu"), levels=2,
                                   device="cpu")
    with lb.stats_scope() as st:
        pend = plan.dispatch_round(list(enumerate(chunks)), name="v")
        assert st.host_syncs == 0
        outs = plan.finish_round(pend)
        assert st.host_syncs == 3
    for i, (x, got) in enumerate(zip(chunks, outs)):
        want = jrff.refactor_fused(x, name=f"v.{i}", levels=2)
        assert rf.refactored_to_bytes(got) == jrf.refactored_to_bytes(want)


# ----------------------------------------------------------------- read side

@pytest.mark.parametrize("n_shards", [1, 3])
def test_engine_for_reads_match_reference(n_shards):
    """Chunk readers whose engines come from ``engine_for`` (each on its
    chunk's shard), drained together, give the reference's values."""
    x = np.random.default_rng(5).standard_normal(20000).astype(np.float32)
    blobs = jpl.ChunkedRefactorPipeline(chunk_elems=4096, levels=2,
                                        use_tune_cache=False).refactor(x)
    eng = shd.ShardedReconstructEngine(n_shards, device="cpu")
    readers = []
    for ci, blob in enumerate(blobs):
        ref = rf.refactored_from_bytes(blob)
        reader = rt.ProgressiveReader(ref, device=eng.device_for(ci))
        reader.engine = eng.engine_for(ci, ref)
        assert reader.engine.device == eng.device_for(ci)
        readers.append(reader)
    for tol in (1e-2, 1e-4):
        for reader in readers:
            reader.stage_retrieve(tol)
        eng.drain([r.engine for r in readers])
        got = np.concatenate([r.reconstruct()[0].reshape(-1)
                              for r in readers])
        want = jpl.ChunkedReconstructPipeline().reconstruct(blobs, tol)
        assert got.tobytes() == want.tobytes()
        assert np.abs(got - x).max() <= tol


# ------------------------------------------------------- sharded kernel ops

def _mags(b, n, seed=0):
    return np.random.default_rng(seed).integers(0, 2 ** 23, (b, n)
                                                ).astype(np.uint32)


@pytest.mark.parametrize("mesh", [1, 2, 4, ["cpu"] * 4],
                         ids=["1", "2", "4", "list4"])
@pytest.mark.parametrize("design", DESIGNS)
def test_sharded_ops_match_reference_batch_ops(design, mesh):
    mags = _mags(8, 4096 + 77)
    want = np.asarray(jops.encode_bitplanes_batch(jnp.asarray(mags), 23,
                                                  design, backend="jnp"))
    blocks = ops.encode_bitplanes_sharded(mags, 23, design, mesh=mesh,
                                          device="cpu")
    size = len(shd.resolve_mesh(mesh, "cpu"))
    assert len(blocks) == size
    assert all(tuple(b.shape) == (8 // size,) + want.shape[1:]
               for b in blocks)
    got = torch.cat(blocks)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    prefix = want[:, :8]
    dwant = np.asarray(jops.decode_bitplanes_batch(
        jnp.asarray(prefix), 23, mags.shape[1], design, backend="jnp"))
    dgot = torch.cat(ops.decode_bitplanes_sharded(
        prefix, 23, mags.shape[1], design, mesh=mesh, device="cpu"))
    assert np.array_equal(dgot.numpy().view(np.uint32), dwant)


def test_sharded_ops_reject_what_the_reference_rejects():
    mags = _mags(6, 4096)
    with pytest.raises(ValueError, match="not divisible by mesh axis"):
        ops.encode_bitplanes_sharded(mags, 23, mesh=4, device="cpu")
    planes = np.zeros((6, 8, 128), np.uint32)
    with pytest.raises(ValueError, match="not divisible by mesh axis"):
        ops.decode_bitplanes_sharded(planes, 23, 4096, mesh=["cpu"] * 4,
                                     device="cpu")
    with pytest.raises(ValueError, match="one axis"):
        ops.encode_bitplanes_sharded(mags, 23, mesh=2, axis="data",
                                     device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shd.make_chunk_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.encode_bitplanes_sharded(_mags(2, 64), 23, mesh=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.decode_bitplanes_sharded(np.zeros((2, 8, 128), np.uint32), 23,
                                     64, mesh=1)
