"""The lossless codec's kernels (``kernels/lossless.py``) on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 21).  Here, with numpy inputs from a seed:

* each kernel's tiled reference, which follows its decomposition (the
  stats' tiles and clusters, the pack's look-back chunks, thread words,
  rebuilt head words and zero pieces, the RLE scan's look-back tiles,
  pieces and slots), is
  bit-identical to the plain pass it replaces, at either side of a chunk
  (4096) and of an RLE tile (32768), on five contents, on buckets of many
  short rows and either side of the stats' tile rule, on real plane
  groups that the port's CPU write stacks, and over random sizes
  (hypothesis);
* the read side's references (the decode's self-synchronising lanes at 32
  and 128 a chunk, the expand's look-back tiles and slices) give the plain
  passes' and the reference's bytes on hand-made edges
  (``tests/_lossless_cases.py``: a one-symbol codebook, 16-bit codes,
  chunks that need two or more synchronisation rounds, a chunk that misses
  its end and one whose codes run past the words, which must be walked
  serially, padded rows; run lengths short of n and past it, zero-length
  runs, long runs), and real plane groups walk no chunk serially;
* the scan's reference (``rle_scan_tiled``, each slot written once, its
  look-back's inclusive words 0, 2 and 5 tiles late) gives the plain
  pass's runs and the reference's, row by row and batched, on hand-made
  edges (rows of RLE_BREAK and either side, one run over three tiles,
  every neighbour distinct, S = 1, unaligned rows, runs either side of a
  segment, a step and a piece, a tile's last symbol alone);
* each plain pass equals the reference's jitted one on the same rows;
* the operators' fakes on ``meta`` give the CPU outputs' shapes and
  dtypes, and ``OpAnalysis`` sees one operator a call with its declared
  workspace;
* ``backend="torch"`` and ``"auto"`` give the same segment bytes on the
  CPU, ``backend="cuda"`` on a CPU tensor raises, and a corrupt chunk
  offset raises before any upload.

Tolerance: none (integer outputs, byte for byte).
"""
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import _lossless_cases as cases  # noqa: E402
from repro.core import lossless as jll  # noqa: E402
from repro.core import lossless_batch as jlb  # noqa: E402
from repro_torch.core import lossless as ll  # noqa: E402
from repro_torch.core import lossless_batch as lb  # noqa: E402
from repro_torch.core import refactor as rf  # noqa: E402
from repro_torch.data.fields import gaussian_field  # noqa: E402
from repro_torch.kernels import bitplane as bp  # noqa: E402
from repro_torch.kernels import lossless as kl  # noqa: E402
from repro_torch.launch.op_analysis import OpAnalysis  # noqa: E402

torch.set_num_threads(1)

SIZES = (1, 2, 31, 4095, 4096, 4097, 32767, 32768, 32769, 65537)
CONTENTS = ("skewed", "zeros", "uniform", "runs", "one")


def _rows(kind, b, s, rng):
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


def _books(rows):
    books = [ll.build_codebook(np.bincount(r, minlength=256)) for r in rows]
    lt, ct = (torch.from_numpy(np.stack([bk[i] for bk in books]
                                        ).astype(np.int64)) for i in (0, 1))
    luts = [ll._build_decode_lut(*bk) for bk in books]
    ls, ln = (torch.from_numpy(np.stack([lu[i] for lu in luts]))
              for i in (0, 1))
    return lt, ct, ls, ln


def _tiled_match(rows):
    """Each tiled reference against the plain pass it follows, on the
    (B, S) rows."""
    b, s = rows.shape
    x = torch.from_numpy(rows)
    for got, w in zip(kl.lossless_stats_tiled(x), lb._group_stats_plain(x)):
        assert got.dtype == w.dtype and torch.equal(got, w)
    lt, ct, ls, ln = _books(rows)
    want = ll._huffman_pack_plain(x, lt, ct)
    for got, w in zip(kl.huffman_pack_tiled(x, lt, ct), want):
        assert got.dtype == w.dtype and torch.equal(got, w)
    words, offs = want[0], want[2]
    dec = ll._huffman_unpack_plain(words, offs, ls, ln, s)
    assert torch.equal(dec, x)
    assert torch.equal(kl.huffman_decode_stepwise(words, offs, ls, ln, s),
                       dec)
    pv, pl, pn = ll._rle_scan_plain(x)
    tv, tl, tn = kl.rle_scan_tiled(x)
    assert torch.equal(tn, pn)
    for r in range(b):
        k = int(pn[r])
        assert torch.equal(tv[r, :k], pv[r, :k])
        assert torch.equal(tl[r, :k].to(torch.int64) & 0xFFFF, pl[r, :k])
    rr = int(pn.max())
    rv, rl = pv[:, :rr].contiguous(), pl[:, :rr].to(torch.int32)
    out = ll._rle_expand_plain(rv, rl, s)
    assert torch.equal(out, x)
    assert torch.equal(kl.rle_expand_tiled(rv, rl, s), out)


@pytest.mark.parametrize("kind", CONTENTS)
@pytest.mark.parametrize("s", SIZES)
def test_tiled_references_equal_the_plain_passes(s, kind):
    """At either side of a chunk and of an RLE tile, B = 1 or 3 rows."""
    b = 3 if SIZES.index(s) % 2 else 1
    _tiled_match(_rows(kind, b, s, np.random.default_rng(s)))


def test_tiled_references_on_real_plane_groups():
    """The buckets a CPU write of a small field stacks (every piece's sign
    plane and plane groups), as the batched encoder gets them."""
    seen = []
    was = lb._encode_buckets

    def rec(stacked, *args, **kw):
        seen.extend(stacked.values())
        return was(stacked, *args, **kw)
    lb._encode_buckets = rec
    try:
        rf.refactor_array(gaussian_field((24, 40, 40), slope=-2.0, seed=3),
                          "g", device="cpu")
    finally:
        lb._encode_buckets = was
    assert len(seen) >= 4 and max(st_.shape[1] for st_ in seen) > 4096
    for rows in seen:
        _tiled_match(rows.numpy())


# (B, S) buckets of short rows (phase 9's kind) and either side of the
# stats' tile rule (``kl.stats_tiling``); the pack's groups of chunks:
# ``test_tiled_pack_over_groups_of_chunks``
BUCKETS = ((64, 4096), (64, 65537), (263, 16384), (264, 16384))


@pytest.mark.parametrize("b,s", BUCKETS)
def test_tiled_references_on_buckets_of_short_rows(b, s):
    """The stats' and the pack's references on many rows of one bucket
    (the stats over its whole tile rule's boundary, the pack over its
    first 64 rows, each row's ticket chunks at the row's own word
    alignment), five contents."""
    rng = np.random.default_rng(b * s)
    for kind in CONTENTS:
        rows = _rows(kind, b, s, rng)
        x = torch.from_numpy(rows)
        for got, w in zip(kl.lossless_stats_tiled(x),
                          lb._group_stats_plain(x)):
            assert torch.equal(got, w)
        lt, ct, _, _ = _books(rows[:64])
        for got, w in zip(kl.huffman_pack_tiled(x[:64], lt, ct),
                          ll._huffman_pack_plain(x[:64], lt, ct)):
            assert got.dtype == w.dtype and torch.equal(got, w)


@pytest.mark.parametrize("b,s,group", [
    (1, 65537, 1), (198, 16384, 1), (199, 16385, 2), (400, 16384, 4),
    (1, 3_244_033, 2), (1, 10_938_368, 4), (2, 10_938_368, 4)])
def test_tiled_pack_over_groups_of_chunks(b, s, group):
    """The pack's tickets take ``pack_group`` chunks (1, 2 or 4: as few
    tickets as fill the card at once, at most ``PACK_BLOCKS``), a row's
    last ticket fewer; the tiled reference over such tickets equals the
    plain pass, one codebook for the bucket, and the status words follow
    the tickets (the two field-size rows: the rule only)."""
    assert kl.pack_group(b, s) == group
    if b * s > 12_000_000:     # rule only: the field-size rows
        return
    rows = _rows("skewed", b, s, np.random.default_rng(b + s))
    x = torch.from_numpy(rows)
    book = ll.build_codebook(np.bincount(rows.reshape(-1), minlength=256))
    lt, ct = (torch.from_numpy(t.astype(np.int64)).expand(b, 256)
              .contiguous() for t in book)
    for got, w in zip(kl.huffman_pack_tiled(x, lt, ct),
                      ll._huffman_pack_plain(x, lt, ct)):
        assert got.dtype == w.dtype and torch.equal(got, w)
    assert kl.huffman_pack_workspace(x, lt, ct) == {
        "status": ((b * -(-kl._chunks(s) // group) + 1,), torch.int64)}


@pytest.mark.parametrize("b,s,want", [
    (1, 1, (4096, 1, 1)), (1, 32768, (4096, 8, 1)),
    (1, 32769, (4096, 8, 2)), (1, 10_938_368, (16384, 8, 84)),
    (64, 4096, (4096, 1, 1)), (64, 65537, (16384, 8, 1)),
    (263, 16384, (8192, 2, 1)), (264, 16384, (16384, 1, 1)),
    (132, 16385, (16384, 2, 1)), (66, 16384, (4096, 4, 1))])
def test_stats_tiling_rule(b, s, want):
    """The stats' (tile, cluster, clusters a row): 16,384 symbols a
    block, halved while a launch has fewer than 264 blocks, 4,096 at
    least; clusters of the row's tiles rounded up to a power of two, at
    most 8; and the scratch declared only for rows of many clusters."""
    assert kl.stats_tiling(b, s) == want
    x = torch.empty((b, s), dtype=torch.uint8, device="meta")
    ws = kl.lossless_stats_workspace(x)
    if want[2] == 1:
        assert ws == {}
    else:
        assert ws == {"sums": ((b, 258), torch.int64)}


@settings(max_examples=12, deadline=None)
@given(s=st.integers(1, 70_000), b=st.integers(1, 3),
       kind=st.sampled_from(CONTENTS), seed=st.integers(0, 2 ** 16))
def test_tiled_references_over_random_sizes(s, b, kind, seed):
    _tiled_match(_rows(kind, b, s, np.random.default_rng(seed)))


@pytest.mark.parametrize("s", [1, 4097, 65537])
def test_plain_passes_equal_the_jitted_reference(s):
    """``_huffman_pack``, ``_huffman_unpack``, ``_rle_scan``,
    ``_rle_expand`` (a row each) and ``_group_stats_batch`` (the bucket):
    the port's plain passes against ``repro``'s jitted ones."""
    rng = np.random.default_rng(s + 1)
    rows = np.concatenate([_rows(k, 1, s, rng) for k in ("skewed", "runs")])
    x = torch.from_numpy(rows)
    lt, ct, ls, ln = _books(rows)
    words, total, offs = ll._huffman_pack_plain(x, lt, ct)
    pv, pl, pn = ll._rle_scan_plain(x)
    for r in range(2):
        j = jll._huffman_pack(jnp.asarray(rows[r]), jnp.asarray(lt[r]),
                              jnp.asarray(ct[r]))
        assert np.array_equal(words[r].numpy().view(np.uint32),
                              np.asarray(j[0]))
        assert int(total[r]) == int(j[1])
        assert np.array_equal(offs[r].numpy(), np.asarray(j[2]))
        dec = jll._huffman_unpack(jnp.asarray(np.asarray(j[0])),
                                  jnp.asarray(np.asarray(j[2])),
                                  jnp.asarray(ls[r]), jnp.asarray(ln[r]), s)
        assert np.array_equal(ll._huffman_unpack_plain(
            words[r:r + 1], offs[r:r + 1], ls[r:r + 1], ln[r:r + 1], s
        )[0].numpy(), np.asarray(dec))
        jv, jl, jn = jll._rle_scan(jnp.asarray(rows[r]))
        assert int(pn[r]) == int(jn)
        assert np.array_equal(pv[r].numpy(), np.asarray(jv))
        assert np.array_equal(pl[r].numpy(), np.asarray(jl))
        k = int(jn)
        je = jll._rle_expand(jv[:k], jl[:k], s)
        assert np.array_equal(ll._rle_expand_plain(
            pv[r:r + 1, :k], pl[r:r + 1, :k], s)[0].numpy(),
            np.asarray(je))
    jh, jn = jlb._group_stats_batch(jnp.asarray(rows))
    h, n = lb._group_stats_plain(x)
    assert np.array_equal(h.numpy(), np.asarray(jh))
    assert np.array_equal(n.numpy(), np.asarray(jn))


def _op_args(device):
    rng = np.random.default_rng(7)
    rows = _rows("skewed", 3, 9000, rng)
    lt, ct, ls, ln = _books(rows)
    x = torch.from_numpy(rows)
    words, _, offs = ll._huffman_pack_plain(x, lt, ct)
    pv, pl, pn = ll._rle_scan_plain(x)
    rr = int(pn.max())
    args = {"lossless_stats": (x,), "huffman_pack": (x, lt, ct),
            "huffman_decode": (words, offs.contiguous(), ls, ln, 9000),
            "rle_scan": (x,),
            "rle_expand": (pv[:, :rr].contiguous(),
                           pl[:, :rr].to(torch.int32).contiguous(), 9000)}
    return {k: tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                     for a in v) for k, v in args.items()}


def _outs(res):
    return res if isinstance(res, tuple) else (res,)


@pytest.mark.parametrize("name", kl.SYMBOLS)
def test_operators_on_the_cpu_and_on_meta(name):
    """Each wrapper on CPU tensors runs its operator's CPU kernel (the
    plain version, at the operator's types: ``rle_scan``'s lengths as
    int16) and launches nothing; on ``meta`` its fake gives the same
    shapes and dtypes, and ``OpAnalysis`` counts one operator whose temp
    is its outputs and its declared workspace."""
    fn = getattr(kl, name)
    before = bp.launches()
    cpu = _outs(fn(*_op_args("cpu")[name]))
    assert bp.launches() == before
    plain = {"lossless_stats": lb._group_stats_plain,
             "huffman_pack": ll._huffman_pack_plain,
             "huffman_decode": ll._huffman_unpack_plain,
             "rle_scan": ll._rle_scan_plain,
             "rle_expand": ll._rle_expand_plain}[name]
    for got, want in zip(cpu, _outs(plain(*_op_args("cpu")[name]))):
        assert torch.equal(got.to(torch.int64) & 0xFFFF
                           if got.dtype == torch.int16 else got, want)
    args = _op_args("meta")[name]
    with OpAnalysis() as ana:
        meta = _outs(fn(*args))
    assert [(t.shape, t.dtype) for t in meta] == \
        [(t.shape, t.dtype) for t in cpu]
    assert all(t.device.type == "meta" for t in meta)
    rec = ana.summary()
    assert rec["ops_by_name"][f"repro_torch.{name}.default"]["count"] == 1
    op = getattr(torch.ops.repro_torch, name).default
    ws = sum(int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
             for shape, dt in bp.WORKSPACE[op](*args).values()) \
        if op in bp.WORKSPACE else 0
    assert rec["temp_bytes"] == sum(t.numel() * t.element_size()
                                    for t in meta) + ws
    assert bp.launches() == before


def test_declared_workspaces():
    x = torch.empty((3, 70_000), dtype=torch.uint8, device="meta")
    t = torch.empty((3, 256), dtype=torch.int64, device="meta")
    # each chunk's status word (18 chunks a row) and the ticket counter
    assert kl.huffman_pack_workspace(x, t, t) == {
        "status": ((3 * 18 + 1,), torch.int64)}
    # 3 x 70,000: 4,096-symbol tiles, 18 a row, three clusters of 8
    # blocks: each row's 257 sums and its count of arrived clusters
    assert kl.lossless_stats_workspace(x) == {
        "sums": ((3, 258), torch.int64)}
    # each tile's status word (three tiles a row) and the ticket counter
    assert kl.rle_scan_workspace(x) == {
        "status": ((3 * 3 + 1,), torch.int64)}
    w = torch.empty((3, 900), dtype=torch.int32, device="meta")
    assert kl.huffman_decode_workspace(w, t, x, x, 9000) == {
        "primary": ((3, 1 << kl.PRIMARY_BITS), torch.int16)}
    v = torch.empty((2, 5000), dtype=torch.uint8, device="meta")
    # each tile's status word (two tiles a row) and the ticket counter
    assert kl.rle_expand_workspace(v, v, 9) == {
        "status": ((2 * 2 + 1,), torch.int64)}
    assert (kl.CHUNK, kl.RLE_BREAK) == (ll.CHUNK, ll.RLE_BREAK) == \
        (jll.CHUNK, jll.RLE_BREAK)


@pytest.mark.parametrize("force", [None, "huffman", "rle", "dc"])
def test_backends_give_the_same_bytes_on_the_cpu(force):
    """``backend="torch"`` and ``"auto"`` (the plain passes on the CPU)
    give the same segments, per group and batched, and the same decoded
    blobs; the reference's bytes too."""
    rng = np.random.default_rng(11)
    blobs = [_rows(k, 1, 6000, rng)[0] for k in CONTENTS]
    cfg = ll.HybridConfig(force=force)
    want = [s.to_bytes() for s in jlb.encode_groups(
        [jnp.asarray(b) for b in blobs], jll.HybridConfig(force=force))]
    for backend in ("auto", "torch"):
        segs = lb.encode_groups(blobs, cfg, device="cpu", backend=backend)
        assert [s.to_bytes() for s in segs] == want
        assert [ll.compress_group(b, cfg, device="cpu",
                                  backend=backend).to_bytes()
                for b in blobs] == want
        for d, b in zip(lb.decode_segments(segs, device="cpu",
                                           backend=backend), blobs):
            assert np.array_equal(d, b)
        for s_, b in zip(segs, blobs):
            assert np.array_equal(ll.decompress_group(
                s_, device="cpu", backend=backend), b)


def test_backend_cuda_on_the_cpu_raises():
    blob = _rows("skewed", 1, 6000, np.random.default_rng(1))[0]
    seg = ll.huffman_encode(blob, device="cpu")
    x = torch.from_numpy(blob)[None]
    calls = (
        lambda: lb.encode_groups([blob], device="cpu", backend="cuda"),
        lambda: lb.encode_groups_stacked([x], backend="cuda"),
        lambda: lb.decode_segments([seg], device="cpu", backend="cuda"),
        lambda: ll.compress_group(blob, device="cpu", backend="cuda"),
        lambda: ll.decompress_group(seg, device="cpu", backend="cuda"),
        lambda: ll._rle_scan(x, "cuda"),
        lambda: lb._group_stats_batch(x, "cuda"))
    for call in calls:
        with pytest.raises(ValueError, match="cuda"):
            call()
    with pytest.raises(ValueError, match="unknown backend"):
        lb.decode_segments([seg], device="cpu", backend="pallas")


@pytest.mark.parametrize("where", ["past the words", "one too few"])
def test_a_corrupt_chunk_offset_raises_on_the_host(where):
    """A Huffman segment whose chunk offset lies at or past its words' end
    (or that lacks one) raises ``ValueError`` before any upload, per group
    and batched; an offset inside the words still decodes as before."""
    blob = _rows("skewed", 1, 9000, np.random.default_rng(2))[0]
    seg = ll.huffman_encode(blob, device="cpu")
    bad = ll.Segment.from_bytes(seg.to_bytes())
    if where == "past the words":
        bad.payload["chunk_offs"][2] = 32 * bad.payload["words"].shape[0]
    else:
        bad.payload["chunk_offs"] = bad.payload["chunk_offs"][:2]
    for call in (lambda: lb.decode_segments([bad], device="cpu"),
                 lambda: ll.decompress_group(bad, device="cpu")):
        with pytest.raises(ValueError, match="chunk offset"):
            call()
    inside = ll.Segment.from_bytes(seg.to_bytes())
    inside.payload["chunk_offs"][2] = 32 * inside.payload["words"].shape[0] - 1
    got = lb.decode_segments([inside], device="cpu")[0]
    assert np.array_equal(got[:2 * ll.CHUNK], blob[:2 * ll.CHUNK])


# ------------------------------------- the read side's kernels, redesigned

def _jax_decode(words, offs, ls, ln, n):
    return np.stack([np.asarray(jll._huffman_unpack(
        jnp.asarray(words[r].numpy().view(np.uint32)),
        jnp.asarray(offs[r].numpy()), jnp.asarray(ls[r].numpy()),
        jnp.asarray(ln[r].numpy()), n)) for r in range(words.shape[0])])


DECODE_CASES = cases.decode_cases()
EXPAND_CASES = cases.expand_cases()
SCAN_CASES = cases.scan_cases()


@pytest.mark.parametrize("lanes", [32, 128])
@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_reference_at_the_edges(name, lanes):
    """The decode's lanes (``huffman_decode_stepwise``) give the plain
    pass's bytes and the reference's; a chunk that misses its end or runs
    past the words is walked serially, and no other; the near-fixed-length
    codebook needs two or more synchronisation rounds."""
    args = DECODE_CASES[name]
    want = ll._huffman_unpack_plain(*args)
    got, walks = kl.huffman_decode_stepwise(*args, lanes=lanes, stats=True)
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(), _jax_decode(*args))
    assert bool(walks["serial"].any()) == (name in cases.SERIAL)
    if name == cases.ROUNDS:
        assert int(walks["rounds"].max()) >= 2


@pytest.mark.parametrize("tiling", [(kl.EXPAND_TILE, 1), (64, 3), (7, 2)])
@pytest.mark.parametrize("name", list(EXPAND_CASES))
def test_expand_reference_at_the_edges(name, tiling):
    """The expand's look-back tiles and slices (``rle_expand_tiled``) give
    the plain pass's bytes and the reference's: lengths that sum short of
    n (the tail takes the last value) and past it (cut at n), zero-length
    runs at tile edges, long runs shared among slices."""
    values, lengths, n = EXPAND_CASES[name]
    tile, slices = tiling
    got = kl.rle_expand_tiled(values, lengths, n, tile=tile, slices=slices)
    assert torch.equal(got, ll._rle_expand_plain(values, lengths, n))
    for r in range(values.shape[0]):
        assert np.array_equal(got[r].numpy(), np.asarray(jll._rle_expand(
            jnp.asarray(values[r].numpy()), jnp.asarray(lengths[r].numpy()),
            n)))


@pytest.mark.parametrize("lag", [0, 2, 5])
@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_scan_reference_at_the_edges(name, lag):
    """The scan's look-back pass (``rle_scan_tiled``: each slot written
    once, a tile's inclusive word ``lag`` tiles late) gives the plain
    pass's runs and the reference's, row by row (``_rle_scan``) and
    batched (``_rle_scan_batch``): rows of exactly RLE_BREAK and either
    side of it, one run over three tiles, every neighbour distinct, S = 1,
    unaligned rows, runs either side of a segment, a step and a piece, a
    tile's last symbol alone."""
    x = SCAN_CASES[name]
    pv, pl, pn = ll._rle_scan_plain(x)
    tv, tl, tn = kl.rle_scan_tiled(x, lag=lag)
    jv, jl, jn = (np.asarray(a) for a in jlb._rle_scan_batch(
        jnp.asarray(x.numpy())))
    assert torch.equal(tn, pn) and np.array_equal(tn.numpy(), jn)
    for r in range(x.shape[0]):
        k = int(pn[r])
        assert torch.equal(tv[r, :k], pv[r, :k])
        assert torch.equal(tl[r, :k].to(torch.int64) & 0xFFFF, pl[r, :k])
        assert np.array_equal(tv[r, :k].numpy(), jv[r, :k])
        assert np.array_equal((tl[r, :k].to(torch.int64) & 0xFFFF).numpy(),
                              jl[r, :k])
    rv, rl, rn = jll._rle_scan(jnp.asarray(x[0].numpy()))
    k = int(rn)
    assert k == int(pn[0])
    assert np.array_equal(tv[0, :k].numpy(), np.asarray(rv)[:k])
    assert np.array_equal((tl[0, :k].to(torch.int64) & 0xFFFF).numpy(),
                          np.asarray(rl)[:k])


@pytest.mark.parametrize("lanes", [32, 128])
def test_real_plane_groups_walk_no_chunk_serially(lanes):
    """The buckets a CPU write stacks, packed and cut to their stored
    width as ``decode_segments`` uploads them: every chunk decodes on the
    lanes, none serially, with the plain pass's bytes."""
    seen = []
    was = lb._encode_buckets

    def rec(stacked, *args, **kw):
        seen.extend(stacked.values())
        return was(stacked, *args, **kw)
    lb._encode_buckets = rec
    try:
        rf.refactor_array(gaussian_field((24, 40, 40), slope=-2.0, seed=3),
                          "g", device="cpu")
    finally:
        lb._encode_buckets = was
    for rows in seen:
        x = rows.contiguous()
        lt, ct, ls, ln = _books(x.numpy())
        words, total, offs = ll._huffman_pack_plain(x, lt, ct)
        words = words[:, :int(((total + 31) // 32 + 1).max())].contiguous()
        got, walks = kl.huffman_decode_stepwise(words, offs, ls, ln,
                                                x.shape[1], lanes=lanes,
                                                stats=True)
        assert torch.equal(got, x)
        assert not bool(walks["serial"].any())


def test_decode_primary_table():
    """Entry q of the primary table is the peek table's entry at q << 5
    where its 32 peeks agree and the code is at most ``PRIMARY_BITS``
    long; ``LONG`` elsewhere (a random table: nearly everywhere)."""
    rows = _rows("skewed", 2, 20_000, np.random.default_rng(4))
    _, _, ls, ln = _books(rows)
    prim = kl.decode_primary(ls, ln)
    sub = 1 << (16 - kl.PRIMARY_BITS)
    at = torch.arange(1 << kl.PRIMARY_BITS) * sub
    short = ln[:, at].to(torch.int64) <= kl.PRIMARY_BITS
    assert torch.equal(prim[short], (ls[:, at].to(torch.int64)
                                     | ln[:, at].to(torch.int64) << 8)[short])
    assert bool((prim[~short] == kl.LONG).all()) and bool(short.any())
    rng = np.random.default_rng(5)
    noise = [torch.from_numpy(rng.integers(0, 256, (1, 1 << 16)
                                           ).astype(np.uint8))
             for _ in range(2)]
    assert float((kl.decode_primary(*noise) == kl.LONG).float().mean()) \
        > 0.99
