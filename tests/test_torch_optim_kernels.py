"""The optimizer path's operators (``repro_torch.kernels.optim``:
``ef_quantize``, whose CUDA side is the ``ef_amax`` and ``ef_apply``
kernels, ``adamw_update`` and ``global_sumsq``) on the CPU, where each
runs its plain version; the CUDA kernels themselves are held against the plain paths on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 14).

What is held, bit for bit unless said otherwise:
* ``ef_quantize_ref`` (the kernels' formula in torch: no planes formed)
  against ``grad_compress``'s plane path (encode the sign plane and the
  top planes, decode them), at 1, 31, 4,097 and 100,003 values and 1, 8
  and 23 planes, on normal leaves and on leaves holding +-0, subnormals,
  +-inf and NaN, an all-zero leaf, a leaf whose maximum lies where the
  reference's scale is inf (below 2**-104), and a leaf whose largest value
  rounds up to 2**23 (a magnitude bit above the planes, which the planes
  drop); and, where every value is finite, against the reference's jitted
  ``ef_quantize``;
* ``ef_amax``'s reduction: the largest bit pattern of |total| read back
  as a float is torch's maximum, NaN and inf included;
* a numpy transcription of ``adamw_update``'s CUDA arithmetic (float32
  operations rounded one by one, float64 products and adds rounded once,
  the float64 square root, explicit flushes) against ``adamw._upd``, for
  float32 and bfloat16 parameters, gradients and state, with and without
  clipping, in the warmup and on the cosine, and on leaves holding +-0,
  subnormals, inf and NaN (NaNs compared as NaNs: numpy and torch may
  carry different payloads);
* ``global_sumsq_tiled`` (the kernels' fixed order: chunks of
  ``SUM_CHUNK`` values, each thread's 16-byte vectors in order, the warp
  and block trees, each leaf's partials the same way, all in float64)
  within 1e-12 relative of the plain float64 chain on float32 and
  bfloat16 leaves, empty leaves, one value, leaves either side of a chunk,
  more leaves than one launch's argument block and special values; the
  norm from its sums within 4 float32 ulps of the reference's
  ``global_norm`` (the bound ``tests/test_torch_train.py`` holds the
  port's norm to);
* ``adamw.update``, ``adamw.global_norm`` and ``ef_quantize`` routed
  through the operators on the CPU equal their plain paths, as does the
  ``Trainer`` with gradient compression;
* on ``meta`` they reach their operators with their outputs' shapes and
  dtypes, and ``OpAnalysis`` counts the operands, the results and the
  declared workspaces (``ef_quantize``'s maxima, ``global_sumsq``'s
  partials);
* the wrappers refuse what the kernels do not take.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.distributed import grad_compress as jgc  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.distributed import grad_compress as gc  # noqa: E402
from repro_torch.kernels import bitplane as bp  # noqa: E402
from repro_torch.kernels import optim as ko  # noqa: E402
from repro_torch.launch.op_analysis import OpAnalysis  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

torch.set_num_threads(1)

SIZES = [1, 31, 4097, 100_003]
PLANES = [1, 8, 23]
F32 = np.float32


def bits(x):
    t = torch.as_tensor(x).detach().cpu().contiguous()
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()]).numpy()


def same_bits(a, b, nan_as_nan=False):
    """Equal bit patterns; with ``nan_as_nan`` a NaN matches any NaN."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if nan_as_nan:
        na, nb = torch.isnan(a), torch.isnan(b)
        assert torch.equal(na, nb)
        a, b = a[~na], b[~nb]
    np.testing.assert_array_equal(bits(a), bits(b))


# ------------------------------------------------------------------- EF --

def _sprinkle(x, vals):
    """Every ``len(vals)``-th value from each offset replaced by ``vals``."""
    for i, v in enumerate(vals):
        x[i::len(vals) * 7] = v
    return x


SPECIALS = [0.0, -0.0, 1e-39, -1e-39, 1e-45, -3e-40, np.inf, -np.inf,
            np.nan, 3.0]


def ef_leaf(kind, n, seed=0):
    rng = np.random.default_rng(seed + n)
    x = rng.normal(size=n).astype(F32)
    r = (rng.normal(size=n) * 1e-3).astype(F32)
    if kind == "specials":
        x = _sprinkle(x, [F32(v) for v in SPECIALS])
        r = _sprinkle(r, [F32(v) for v in SPECIALS[::-1]])
    elif kind == "zeros":
        x, r = np.zeros(n, F32), np.zeros(n, F32)
        x[::3] = -0.0
    elif kind == "inf_scale":       # max|total| in [2**-126, 2**-105)
        x = (x * 2.0 ** -112).astype(F32)
        r = (r * 2.0 ** -112).astype(F32)
        x[0] = F32(2.0 ** -106)
    elif kind == "saturate":        # the largest value rounds to 2**23
        x = rng.uniform(-1, 1, size=n).astype(F32)
        r = np.zeros(n, F32)
        x[0] = np.nextafter(F32(2), F32(0))
        x[-1] = -np.nextafter(F32(2), F32(0))
    return x, r


EF_KINDS = ["normal", "specials", "zeros", "inf_scale", "saturate"]
FINITE_KINDS = ["normal", "zeros", "inf_scale", "saturate"]


@pytest.mark.parametrize("planes", PLANES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", EF_KINDS)
def test_ef_operator_equals_the_plane_path(kind, n, planes):
    x, r = (torch.from_numpy(a) for a in ef_leaf(kind, n))
    before = bp.launches()
    q, nr = ko.ef_quantize(x, r, planes)
    assert bp.launches() == before       # the CPU runs the plain version
    qp, nrp = gc.ef_quantize(x, r, planes, backend="torch")
    same_bits(q, qp)
    same_bits(nr, nrp)


@pytest.mark.parametrize("planes", PLANES)
@pytest.mark.parametrize("n", [31, 4097])
@pytest.mark.parametrize("kind", FINITE_KINDS)
def test_ef_operator_equals_the_reference(kind, n, planes):
    x, r = ef_leaf(kind, n)
    jq, jr = jax.jit(jgc.ef_quantize, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(r), planes)
    q, nr = ko.ef_quantize(torch.from_numpy(x), torch.from_numpy(r), planes)
    np.testing.assert_array_equal(np.asarray(jq).view(np.int32), bits(q))
    np.testing.assert_array_equal(np.asarray(jr).view(np.int32), bits(nr))


@pytest.mark.parametrize("kind", EF_KINDS)
def test_ef_amax_on_bit_patterns_is_torch_s_maximum(kind):
    """The kernels' reduction: |total|'s pattern as an unsigned integer,
    each block's largest, then the largest of those."""
    x, r = (torch.from_numpy(a) for a in ef_leaf(kind, 100_003))
    total = gc.flush_subnormal(gc.flush_subnormal(x) + gc.flush_subnormal(r))
    pat = total.view(torch.int32).numpy().view(np.uint32) & 0x7FFFFFFF
    nb = ko.blocks(pat.size)
    idx = np.arange(pat.size) // 4 % (nb * ko.THREADS) // ko.THREADS
    part = np.zeros(nb, np.uint32)
    np.maximum.at(part, idx, pat)
    got = torch.from_numpy(part.max(keepdims=True).view(np.float32))[0]
    same_bits(got, ko.ef_amax_ref(x, r), nan_as_nan=True)


def test_blocks_and_the_ef_workspace():
    assert ko.blocks(1) == 1
    assert ko.blocks(4 * ko.THREADS) == 1
    assert ko.blocks(4 * ko.THREADS + 1) == 2
    assert ko.blocks(122_880_000) == ko.MAX_BLOCKS
    x = torch.empty(100_003, device="meta")
    assert ko.ef_workspace(x, x, 8) == {"amax_part": (98,)}


def test_ef_quantize_on_meta_reaches_the_operator():
    n = 100_003
    x = torch.empty((7, n // 7 + 1), device="meta")
    r = torch.empty_like(x)
    with OpAnalysis() as ana:
        q, nr = gc.ef_quantize(x, r, 8)
    assert q.shape == nr.shape == x.shape and q.device.type == "meta"
    assert q.dtype == nr.dtype == torch.float32
    s = ana.summary()
    ops = s["ops_by_name"]
    assert list(ops) == ["repro_torch.ef_quantize.default"]
    nbytes = 4 * x.numel()
    assert ops["repro_torch.ef_quantize.default"] == {
        "count": 1, "bytes": 4 * nbytes, "flops": 0}
    # the outputs stay; the workspace is live while the call runs
    assert s["temp_bytes"] == 2 * nbytes + 4 * ko.blocks(x.numel())


def test_ef_quantize_through_the_operator_on_the_cpu(monkeypatch):
    x, r = (torch.from_numpy(a) for a in ef_leaf("normal", 4097))
    want = gc.ef_quantize(x, r, 8)
    monkeypatch.setattr(ko, "_on_operators", lambda t: True)
    got = gc.ef_quantize(x.reshape(17, 241), r.reshape(17, 241), 8)
    for a, b in zip(want, got):
        same_bits(a, b.reshape(-1))


# ---------------------------------------------------------------- AdamW --

def _np32(t):
    return t.detach().float().numpy()


def _flush(x):
    return x * (np.abs(x) >= F32(2.0 ** -126)).astype(F32)


def _fma64(a, b, c):
    return (a.astype(np.float64) * np.float64(b)
            + c.astype(np.float64)).astype(F32)


def _moment(old, b, omb, x, old_product):
    if old_product:
        return _flush(_fma64(old, b, x * omb))
    return _flush(_fma64(x, omb, old * b))


def adamw_np(p, g, m, v, scale, lr, c1, c2, cfg):
    """``csrc/optim.cu``'s ``adamw_value`` transcribed into numpy."""
    f32_state = m.dtype == torch.float32
    b1, omb1 = F32(cfg.b1), F32(1 - cfg.b1)
    b2, omb2 = F32(cfg.b2), F32(1 - cfg.b2)
    scale, lr, c1, c2 = (F32(t.item()) for t in (scale, lr, c1, c2))
    with np.errstate(all="ignore"):
        gs = _flush(_np32(g) * scale)
        g2 = _flush(gs * gs)
        nm = _moment(_np32(m), b1, omb1, gs, f32_state)
        nv = _moment(_np32(v), b2, omb2, g2, f32_state)
        v_step = nv if f32_state else _moment(_np32(v), b2, omb2, g2, True)
        sq = np.sqrt(_flush(v_step / c2).astype(np.float64)).astype(F32)
        denom = _flush(c1 * (sq + F32(cfg.eps)))
        p32 = _np32(p)
        delta = _flush(_fma64(p32, F32(cfg.weight_decay),
                              _flush(nm / denom)))
        newp = _flush(_fma64(delta, -lr, p32))
    out = lambda a, like: torch.from_numpy(a).to(like.dtype)
    return out(newp, p), out(nm, m), out(nv, v)


def adamw_leaf(n, pdt, gdt, sdt, seed, special=False):
    rng = np.random.default_rng(seed + n)
    p = rng.normal(size=n).astype(F32)
    g = (rng.normal(size=n) * 1e-2).astype(F32)
    m = (rng.normal(size=n) * 1e-3).astype(F32)
    v = np.abs(rng.normal(size=n) * 1e-5).astype(F32)
    if special:
        g = _sprinkle(g, [F32(s) for s in SPECIALS])
        p = _sprinkle(p, [F32(s) for s in (0.0, -0.0, 1e-39, -1e-39, 5.0)])
        m = _sprinkle(m, [F32(s) for s in (1e-40, -0.0, 0.0)])
        v = _sprinkle(v, [F32(s) for s in (1e-41, 0.0)])
    t = lambda a, dt: torch.from_numpy(a).to(dt)
    return t(p, pdt), t(g, gdt), t(m, sdt), t(v, sdt)


def scalars(cfg, grads, step):
    """``update``'s device scalars at int ``step`` (1-based)."""
    return adamw.step_scalars(cfg, torch.tensor(step, dtype=torch.int32),
                              adamw.global_norm(grads))


DTYPE_CASES = [(torch.float32, torch.float32, "float32"),
               (torch.float32, torch.float32, "bfloat16"),
               (torch.bfloat16, torch.bfloat16, "float32"),
               (torch.bfloat16, torch.bfloat16, "bfloat16"),
               (torch.bfloat16, torch.float32, "float32"),
               (torch.bfloat16, torch.float32, "bfloat16")]
IDS = [f"p{str(p)[6:]}-g{str(g)[6:]}-s{s}" for p, g, s in DTYPE_CASES]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtypes", DTYPE_CASES, ids=IDS)
def test_adamw_kernel_arithmetic_equals_upd(dtypes, n):
    """Warmup (step 1), the top of the cosine (step 3) and its end, each
    with and without clipping."""
    pdt, gdt, sname = dtypes
    sdt = adamw.DTYPES[sname]
    cfg_kw = dict(warmup_steps=2, total_steps=9, state_dtype=sname)
    for step in (1, 3, 9):
        p, g, m, v = adamw_leaf(n, pdt, gdt, sdt, step)
        for clip in (1e9, 0.3 * adamw.global_norm({"g": g}).item()):
            cfg = adamw.AdamWConfig(clip_norm=clip, **cfg_kw)
            sc = scalars(cfg, {"g": g}, step)
            assert (sc[0].item() < 1) == (clip < 1e9)
            want = adamw._upd(p, g, m, v, *sc, cfg, sdt)
            got = adamw_np(p, g, m, v, *sc, cfg)
            for a, b in zip(want, got):
                assert a.dtype == b.dtype
                same_bits(a, b, nan_as_nan=True)


@pytest.mark.parametrize("dtypes", DTYPE_CASES, ids=IDS)
def test_adamw_kernel_arithmetic_on_special_values(dtypes):
    pdt, gdt, sname = dtypes
    sdt = adamw.DTYPES[sname]
    cfg = adamw.AdamWConfig(warmup_steps=2, total_steps=9, state_dtype=sname)
    p, g, m, v = adamw_leaf(4097, pdt, gdt, sdt, 0, special=True)
    finite = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
    for sc in (scalars(cfg, {"g": finite}, 3), scalars(cfg, {"g": g}, 3)):
        want = adamw._upd(p, g, m, v, *sc, cfg, sdt)
        got = adamw_np(p, g, m, v, *sc, cfg)
        for a, b in zip(want, got):
            same_bits(a, b, nan_as_nan=True)


def _tree(pdt, gdt, sdt, seed):
    leaves = [adamw_leaf(n, pdt, gdt, sdt, seed) for n in (31, 4097, 1)]
    pick = lambda i: {"a": leaves[0][i], "b": {"c": leaves[1][i].reshape(
        17, 241), "d": leaves[2][i]}}
    return pick(0), pick(1), pick(2), pick(3)


def _leaves(res):
    return (tree_leaves(res[0]) + tree_leaves(res[1].m)
            + tree_leaves(res[1].v))


@pytest.mark.parametrize("clip", [1e9, 1e-2])
@pytest.mark.parametrize("dtypes", DTYPE_CASES, ids=IDS)
def test_update_through_the_operators_equals_the_plain_update(
        monkeypatch, dtypes, clip):
    pdt, gdt, sname = dtypes
    cfg = adamw.AdamWConfig(warmup_steps=2, total_steps=6, clip_norm=clip,
                            state_dtype=sname)
    params, grads, m, v = _tree(pdt, gdt, adamw.DTYPES[sname], 0)
    state = adamw.AdamWState(step=torch.tensor(0, dtype=torch.int32), m=m,
                             v=v)
    plain = (params, state)
    routed = (params, state)
    for _ in range(4):
        want = adamw.update(grads, plain[1], plain[0], cfg, backend="torch")
        with monkeypatch.context() as mp:
            mp.setattr(ko, "_on_operators", lambda t: True)
            got = adamw.update(grads, routed[1], routed[0], cfg)
        for a, b in zip(_leaves(want), _leaves(got)):
            same_bits(a, b)
        same_bits(want[2]["lr"], got[2]["lr"])
        plain, routed = want[:2], got[:2]


def test_adamw_update_on_meta_reaches_the_operator():
    cfg = adamw.AdamWConfig(state_dtype="bfloat16")
    params = {"a": torch.empty(4097, device="meta"),
              "b": torch.empty((3, 5), device="meta", dtype=torch.bfloat16)}
    state = adamw.init(params, cfg)
    grads = {k: torch.empty_like(t) for k, t in params.items()}
    with OpAnalysis() as ana:
        newp, news, _ = adamw.update(grads, state, params, cfg)
    for k, t in params.items():
        assert newp[k].shape == t.shape and newp[k].dtype == t.dtype
        assert news.m[k].dtype == news.v[k].dtype == torch.bfloat16
        assert newp[k].device.type == "meta"
    op = ana.summary()["ops_by_name"]["repro_torch.adamw_update.default"]
    assert op["count"] == 2
    # p, g, m, v and four float32 scalars in; p, m, v out
    want = sum(2 * t.numel() * t.element_size() + t.numel() * t.element_size()
               + 2 * 2 * 2 * t.numel() + 16 for t in params.values())
    assert op["bytes"] == want


def test_the_trainer_through_the_operators_equals_the_plain_trainer(
        tmp_path, monkeypatch):
    from repro_torch.configs.base import smoke_config
    from repro_torch.models.model import Model
    from repro_torch.train import loop

    def run(name):
        m = Model(smoke_config("qwen2-7b"), device="cpu", seed=0)
        return loop.Trainer(
            m, adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3),
            loop.TrainerConfig(total_steps=3, ckpt_every=3, log_every=1,
                               ckpt_dir=str(tmp_path / name),
                               grad_compress_planes=8),
            loop.synthetic_data(m.cfg, 2, 16, seed=1, device="cpu")).run()
    want = run("plain")
    monkeypatch.setattr(ko, "_on_operators", lambda t: True)
    got = run("routed")
    assert [m["loss"] for m in want["metrics"]] == \
        [m["loss"] for m in got["metrics"]]
    for key in ("params", "ef"):
        for a, b in zip(tree_leaves(want[key]), tree_leaves(got[key])):
            same_bits(a, b)


# ----------------------------------------------------------- global_sumsq --

CHUNK = ko.SUM_CHUNK
T32, TB16 = torch.float32, torch.bfloat16
# (values, dtype) a leaf
SUMSQ_CASES = {
    "float32": [(31, T32), (CHUNK - 1, T32), (CHUNK, T32), (CHUNK + 1, T32),
                (3 * CHUNK + 17, T32)],
    "bfloat16": [(31, TB16), (CHUNK - 1, TB16), (CHUNK + 1, TB16),
                 (2 * CHUNK, TB16)],
    "empty leaves": [(0, T32), (4097, T32), (0, TB16)],
    "one value": [(1, T32)],
    "more leaves than a launch": [
        (int(n), (T32, TB16)[i % 2]) for i, n in enumerate(
            np.random.default_rng(4).integers(0, 3000, ko.SUM_LEAVES + 5))],
}


def sumsq_leaves(case, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                             * 1e-2).to(dt) for n, dt in SUMSQ_CASES[case]]


def special_leaves():
    """Zeros, subnormals, values near float32's largest square root and
    past it (their squares overflow float32, not float64), signs mixed."""
    rng = np.random.default_rng(9)
    big = np.full(CHUNK + 3, 3e35, np.float32) * rng.choice([-1, 1],
                                                            CHUNK + 3)
    return [torch.zeros(1000), torch.full((70_000,), 1e-40),
            torch.from_numpy(big.astype(np.float32)),
            torch.from_numpy(np.float32([1e19, -1e-45, 0.0, -0.0])),
            torch.full((9,), 1e-40).to(TB16)]


def _rel_to_plain(got, want):
    zero = want == 0
    assert torch.equal(got[zero], want[zero])
    return ((got - want).abs()[~zero] / want[~zero]).max().item() \
        if bool((~zero).any()) else 0.0


@pytest.mark.parametrize("case", list(SUMSQ_CASES) + ["specials"])
def test_tiled_sumsq_equals_the_plain_sums(case):
    leaves = special_leaves() if case == "specials" else sumsq_leaves(case)
    got = ko.global_sumsq_tiled(leaves)
    want = ko.global_sumsq_ref(leaves)
    assert got.dtype == want.dtype == torch.float64
    assert got.shape == want.shape == (len(leaves),)
    assert _rel_to_plain(got, want) <= 1e-12


@pytest.mark.parametrize("case", SUMSQ_CASES)
def test_tiled_norm_within_4_ulps_of_the_reference(case):
    """``global_norm``'s arithmetic on the tiled sums (leaf order, the
    float64 square root rounded once) against the reference's float32
    ``global_norm``."""
    leaves = sumsq_leaves(case, seed=1)
    total = sum(ko.global_sumsq_tiled(leaves).unbind(0))
    got = torch.sqrt(torch.as_tensor(total, dtype=torch.float64)).float()
    want = jadamw.global_norm([jnp.asarray(g.float().numpy()).astype(
        jnp.bfloat16 if g.dtype == TB16 else jnp.float32) for g in leaves])
    want = np.array(want)
    assert want.dtype == np.float32
    assert abs(int(bits(got.numpy())) - int(bits(want))) <= 4


def test_global_norm_through_the_operator_on_the_cpu(monkeypatch):
    """Routed through ``global_sumsq`` (whose CPU kernel is the plain
    chain), the norm is the chain's, bit for bit; nothing launches."""
    tree = {"a": sumsq_leaves("float32")[2],
            "b": {"c": sumsq_leaves("bfloat16")[1].reshape(-1, 5)}}
    want = adamw.global_norm(tree, backend="torch")
    before = bp.launches()
    monkeypatch.setattr(ko, "_on_operators", lambda t: True)
    with OpAnalysis() as ana:
        got = adamw.global_norm(tree)
    same_bits(got, want)
    assert ana.summary()["ops_by_name"][
        "repro_torch.global_sumsq.default"]["count"] == 1
    assert bp.launches() == before


def test_global_sumsq_on_meta_and_its_workspace():
    leaves = [torch.empty(n, dtype=dt, device="meta")
              for n, dt in ((CHUNK + 1, T32), (0, TB16), (31, TB16))]
    with OpAnalysis() as ana:
        out = ko.global_sumsq(leaves)
    assert out.shape == (3,) and out.dtype == torch.float64
    assert out.device.type == "meta"
    op = torch.ops.repro_torch.global_sumsq.default
    # two chunks of the first leaf, one of the third, none of the empty one
    assert bp.WORKSPACE[op](leaves) == {"partials": ((3,), torch.float64)}
    rec = ana.summary()
    got = rec["ops_by_name"]["repro_torch.global_sumsq.default"]
    assert got["count"] == 1
    assert got["bytes"] == 4 * (CHUNK + 1) + 2 * 31 + 8 * 3
    assert rec["temp_bytes"] == 8 * 3 + 8 * 3


def test_adamw_update_on_meta_takes_one_global_sumsq():
    params = {"a": torch.empty(4097, device="meta"),
              "b": torch.empty((3, 5), device="meta")}
    state = adamw.init(params, adamw.AdamWConfig())
    grads = {k: torch.empty_like(t) for k, t in params.items()}
    with OpAnalysis() as ana:
        adamw.update(grads, state, params, adamw.AdamWConfig())
    ops = ana.summary()["ops_by_name"]
    assert ops["repro_torch.global_sumsq.default"]["count"] == 1


# -------------------------------------------------------------- refusals --

def test_the_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="backend"):
        ko.use_operators(x, "xla")
    with pytest.raises(ValueError, match="CUDA"):
        gc.ef_quantize(x, x, 8, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        adamw.update({"a": x}, adamw.init({"a": x}, adamw.AdamWConfig()),
                     {"a": x}, adamw.AdamWConfig(), backend="cuda")
    with pytest.raises(TypeError):
        ko.ef_quantize(x.double(), x.double(), 8)
    with pytest.raises(ValueError, match="shapes"):
        ko.ef_quantize(x, torch.zeros(9), 8)
    with pytest.raises(ValueError, match="empty"):
        ko.ef_quantize(torch.zeros(0), torch.zeros(0), 8)
    with pytest.raises(ValueError, match="planes"):
        ko.ef_quantize(x, x, 24)
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.zeros(4, 4).t()
        ko.ef_quantize(y, y, 8)
    one = torch.tensor(1.0)
    with pytest.raises(TypeError):
        ko.adamw_update(x, x, x, x.bfloat16(), one, one, one, one, 0.9,
                        0.95, 1e-8, 0.1)
    with pytest.raises(ValueError, match="0-d"):
        ko.adamw_update(x, x, x, x, one[None], one, one, one, 0.9, 0.95,
                        1e-8, 0.1)
    for fn, args in ((ko.ef_amax, (x, x)),
                     (ko.ef_apply, (x, x, torch.zeros(1), 8))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    with pytest.raises(ValueError, match="no leaves"):
        ko.global_sumsq([])
    with pytest.raises(TypeError):
        ko.global_sumsq([x, x.double()])
    with pytest.raises(ValueError, match="contiguous"):
        ko.global_sumsq([torch.zeros(4, 4).t()])
    with pytest.raises(ValueError, match="tensors on"):
        ko.global_sumsq([x, torch.zeros(3, device="meta")])
