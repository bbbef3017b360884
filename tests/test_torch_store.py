"""The port's store (writer, layout, backends, service) vs the JAX reference,
on the CPU.

Inputs are made with numpy from a seed; the port runs with ``device="cpu"``.
Tolerance: none.  A store written by either package has the same segment
bytes per variable and the same manifest once the segment keys (which carry
a random generation token) are dropped: the same offsets, sizes, CRCs,
``shards`` and ``plan``, the plan in the reference's backend spelling.
Each package's service serves the other's store with bit-identical arrays,
equal bounds and equal bytes per step.  The port's versions of
tests/test_store.py's contracts follow, and the import-isolation check: no
``repro_torch`` module loads ``jax`` or ``repro``.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import store as jst  # noqa: E402
from repro.core import qoi as jqq  # noqa: E402
from repro_torch import store as tst  # noqa: E402
from repro_torch import tune as tn  # noqa: E402
from repro_torch.core import qoi as qq  # noqa: E402
from repro_torch.data.fields import gaussian_field, velocity_field  # noqa: E402,E501
from repro_torch.store import layout as lo  # noqa: E402
from repro_torch.store import reliability as rl  # noqa: E402
from repro_torch.store import writer as wr  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LADDER = (1e-1, 1e-2, 1e-3, 1e-4, 1e-5)
METHODS = {"cp": {}, "ma": {}, "mape": {"c": 10.0}}


@pytest.fixture(scope="module")
def field():
    return gaussian_field((36, 36, 36), slope=-2.2, seed=11)


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory, field):
    root = str(tmp_path_factory.mktemp("tstore"))
    with tst.DatasetWriter(root, chunk_elems=16000, use_tune_cache=False,
                           device="cpu") as w:
        w.write("v", field)
    return root


def _open(root, **kw):
    return tst.DatasetStore.open(root, device="cpu", **kw)


def _bits(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def _write(pkg, root, arrays, **kw):
    """Write ``arrays`` (name -> array) into ``root`` with ``pkg``'s
    writer; the port on the CPU, neither consulting a tune cache."""
    extra = {"device": "cpu"} if pkg is tst else {}
    with pkg.DatasetWriter(root, use_tune_cache=False, **extra, **kw) as w:
        for name, x in arrays.items():
            w.write(name, x)


def _manifest(root):
    """(format, variables body without segment keys, segment bytes by
    variable) of a committed store."""
    with open(os.path.join(root, lo.MANIFEST_NAME)) as f:
        j = json.load(f)
    body = json.loads(json.dumps(j["variables"]))
    segs = {}
    for name, v in body.items():
        with open(lo.segment_path(root, v.pop("segment_file")), "rb") as f:
            segs[name] = f.read()
    return j["format"], body, segs


def _same_store(a, b):
    fa, ba, sa = _manifest(a)
    fb, bb, sb = _manifest(b)
    assert fa == fb == lo.FORMAT
    assert ba == bb
    assert sa.keys() == sb.keys()
    for name in sa:
        assert sa[name] == sb[name], name
    return ba


# ------------------------------------------------ import isolation (satellite)

def test_port_imports_no_jax_or_repro():
    """Every ``repro_torch`` module imports with ``jax`` and ``repro``
    blocked by a meta-path finder that raises; neither gets loaded."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        import repro_torch
        names = ["repro_torch"]
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
            names.append(m.name)
        assert "repro_torch.store.service" in names
        assert "repro_torch.store.serving" in names
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip()) >= 30


def test_entry_points_default_to_the_card(tmp_path, field):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError):
        tst.DatasetWriter(str(tmp_path / "w"))
    root = str(tmp_path / "s")
    _write(tst, root, {"v": field[:4]})
    with pytest.raises(RuntimeError):
        tst.DatasetStore.open(root)
    with pytest.raises(RuntimeError):
        tst.RetrievalService(_open(root), device="cuda")


# ------------------------------------------------------------ writer identity

@pytest.mark.parametrize("checksums", [True, False])
def test_writer_identity_with_reference(tmp_path, checksums):
    """Same fields, same knobs: the same segment bytes and the same manifest
    (keys dropped) from both writers, over several variables and chunk-edge
    lengths (a remainder chunk, one small chunk, 0-d, empty)."""
    arrays = {
        "a": gaussian_field((2000,), seed=1),
        "b": gaussian_field((9, 9), seed=2),
        "c": gaussian_field((24, 20, 32), slope=-2.0, seed=17),
        "scalar": np.float32(3.25).reshape(()),
        "empty": np.zeros((0,), np.float32),
    }
    roots = {}
    for name, pkg in (("jax", jst), ("torch", tst)):
        roots[name] = str(tmp_path / name)
        _write(pkg, roots[name], arrays, chunk_elems=750, checksums=checksums)
    body = _same_store(roots["jax"], roots["torch"])
    assert sorted(body) == sorted(arrays)
    crcs = [len(p["sign"]) == 4 for c in body["c"]["chunks"]
            for p in c["pieces"]]
    assert all(crcs) if checksums else not any(crcs)
    assert body["c"]["plan"]["backend"] == "auto"


@pytest.mark.parametrize("design", ["register_block", "locality", "shuffle"])
def test_writer_identity_designs_and_plan_spelling(tmp_path, design):
    """Designs and the explicit plain backend: the port's ``torch`` lands in
    the manifest as the reference's ``jnp``, so both plans are equal key for
    key, and reading it back gives the port's spelling again."""
    x = {"v": gaussian_field((20, 20, 20), slope=-2.0, seed=3)}
    _write(jst, str(tmp_path / "j"), x, chunk_elems=3000, design=design,
           backend="jnp")
    _write(tst, str(tmp_path / "t"), x, chunk_elems=3000, design=design,
           backend="torch")
    body = _same_store(str(tmp_path / "j"), str(tmp_path / "t"))
    assert body["v"]["plan"]["backend"] == "jnp"
    assert body["v"]["design"] == design
    v = _open(str(tmp_path / "t")).variable("v")
    assert tn.RefactorConfig.from_json(v.plan).backend == "torch"


def test_plan_json_spells_backends_as_the_reference():
    for port, ref in (("auto", "auto"), ("cuda", "pallas"), ("torch", "jnp")):
        plan = wr.plan_json(tn.RefactorConfig(backend=port))
        assert plan["backend"] == ref
        assert tn.RefactorConfig.from_json(plan).backend == port
        assert set(plan) == set(tn.RefactorConfig().to_json())


def test_rewrite_identity_with_reference(tmp_path):
    """Writing into an existing store replaces one variable and keeps the
    other, in both packages alike (new generation files, merged
    manifests)."""
    xa = gaussian_field((20, 20), seed=1)
    xb = gaussian_field((20, 20), seed=2)
    for name, pkg in (("j", jst), ("t", tst)):
        root = str(tmp_path / name)
        _write(pkg, root, {"a": xa, "b": xb}, chunk_elems=1 << 20)
        _write(pkg, root, {"a": (xa * 3).astype(np.float32)},
               chunk_elems=1 << 20)
    body = _same_store(str(tmp_path / "j"), str(tmp_path / "t"))
    assert sorted(body) == ["a", "b"]
    s = tst.RetrievalService(_open(str(tmp_path / "t"))).open_session()
    xh, bound, _ = s.retrieve("a", 1e-4)
    assert float(np.abs(xh - xa * 3).max()) <= bound


def test_mesh_write_records_shards_and_same_bytes(tmp_path, field):
    """mesh=2 (two shards of the CPU): the payload bytes of a one-device
    write, the round-robin chunk -> shard map in the manifest, and reads
    equal across device counts."""
    _write(tst, str(tmp_path / "one"), {"v": field}, chunk_elems=9000)
    _write(tst, str(tmp_path / "two"), {"v": field}, chunk_elems=9000,
           mesh=2)
    _, b1, s1 = _manifest(str(tmp_path / "one"))
    _, b2, s2 = _manifest(str(tmp_path / "two"))
    assert s1 == s2 and "shards" not in b1["v"]
    assert b2["v"]["shards"] == [ci % 2 for ci in range(len(b2["v"]["chunks"]))]
    x1, bd1, f1 = tst.RetrievalService(_open(str(tmp_path / "two"))) \
        .open_session().retrieve("v", 1e-3)
    x2, bd2, f2 = tst.RetrievalService(_open(str(tmp_path / "one")), mesh=2) \
        .open_session().retrieve("v", 1e-3)
    assert _bits(x1) == _bits(x2) and bd1 == bd2 and f1 == f2


# ------------------------------------------------------------- cross reading

@pytest.mark.parametrize("relative", [True, False])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cross_read_ladder_matches_reference(tmp_path, field, writer,
                                            relative):
    """A store written by either package serves the tolerance ladder
    1e-1 .. 1e-5 in both packages' services with bit-identical arrays,
    equal bounds and equal bytes per step.  (The module's field and chunk
    size: the reference compiles its programs once per shape.)"""
    root = str(tmp_path / "s")
    _write(jst if writer == "jax" else tst, root,
           {"v": field, "w": (field[::-1] * 2).copy()}, chunk_elems=16000)
    js = jst.RetrievalService(jst.DatasetStore.open(root)).open_session()
    ts = tst.RetrievalService(_open(root)).open_session()
    for tol in LADDER:
        for var in ("v", "w"):
            xj, bj, fj = js.retrieve(var, tol, relative=relative)
            xt, bt, ft = ts.retrieve(var, tol, relative=relative)
            assert _bits(xt) == _bits(xj), (var, tol)
            assert xt.shape == xj.shape and xt.dtype == np.float32
            assert (bt, ft) == (bj, fj), (var, tol)
    assert ts.stats.snapshot() == js.stats.snapshot()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_qoi_session_matches_reference(tmp_path, writer):
    """Session.retrieve_qoi over U, V, W stored as three variables: the same
    iterations, bytes, tau', values and degraded groups as the reference's,
    for CP, MA and MAPE, tightening tau in one session."""
    root = str(tmp_path / "q")
    vs = velocity_field((36, 36, 36), seed=3)
    _write(jst if writer == "jax" else tst, root, dict(zip("UVW", vs)),
           chunk_elems=16000)
    for method, kw in METHODS.items():
        js = jst.RetrievalService(jst.DatasetStore.open(root)).open_session()
        ts = tst.RetrievalService(_open(root)).open_session()
        for tau in (1e-2, 1e-4):
            a = ts.retrieve_qoi(("U", "V", "W"), qq.V_TOTAL, tau,
                                method=method, **kw)
            b = js.retrieve_qoi(("U", "V", "W"), jqq.V_TOTAL, tau,
                                method=method, **kw)
            assert (a.iterations, a.bytes_fetched, a.converged,
                    a.degraded_groups, a.per_iteration, a.eps_final,
                    a.tau_estimated) == \
                (b.iterations, b.bytes_fetched, b.converged,
                 b.degraded_groups, b.per_iteration, b.eps_final,
                 b.tau_estimated), (method, tau)
            assert [_bits(v) for v in a.values] == \
                [_bits(v) for v in b.values], (method, tau)
        assert ts.stats.snapshot() == js.stats.snapshot()


# ------------------------------------ the port's versions of test_store.py --

def test_manifest_layout(store_dir, field):
    with open(os.path.join(store_dir, lo.MANIFEST_NAME)) as f:
        man = lo.Manifest.from_json(json.load(f))
    v = man.variables["v"]
    assert v.shape == field.shape
    assert len(v.chunks) == -(-field.size // 16000)
    seg_size = os.path.getsize(lo.segment_path(store_dir, v.segment_file))
    ranges = sorted((g.offset, g.size)
                    for c in v.chunks for p in c.pieces
                    for g in [p.sign] + p.groups)
    pos = 0
    for off, size in ranges:
        assert off == pos
        pos += size
    assert pos == seg_size == v.stored_bytes


def test_cold_incremental_tolerance_sequence(store_dir, field):
    store = _open(store_dir)
    svc = tst.RetrievalService(store)
    s = svc.open_session()
    total_prev = 0
    for tol in [1e-2, 1e-3, 1e-4]:
        xh, bound, fetched = s.retrieve("v", tol)
        err = float(np.abs(xh - field).max())
        assert err <= bound <= tol, (tol, err, bound)
        assert s.bytes_fetched == total_prev + fetched
        assert s.bytes_fetched > total_prev
        total_prev = s.bytes_fetched
        assert s.bytes_fetched < store.stored_bytes
    _, _, fetched = s.retrieve("v", 1e-3)
    assert fetched == 0
    s2 = svc.open_session()
    s2.retrieve("v", 1e-4)
    assert s2.bytes_fetched == s.bytes_fetched


def test_backend_cache_accounting(store_dir):
    backend = tst.CachingBackend(tst.LocalFileBackend(store_dir))
    store = _open(store_dir, backend=backend)
    svc = tst.RetrievalService(store, serving=False)
    svc.open_session().retrieve("v", 1e-3)
    cold = backend.stats.bytes_fetched
    assert cold > 0 and backend.stats.cache_misses > 0
    svc.open_session().retrieve("v", 1e-3)
    assert backend.stats.bytes_fetched == cold
    assert backend.stats.cache_hits > 0
    backend.drop_cache()
    svc.open_session().retrieve("v", 1e-3)
    assert backend.stats.bytes_fetched > cold


def test_in_memory_backend_roundtrip(store_dir, field):
    with open(os.path.join(store_dir, lo.MANIFEST_NAME)) as f:
        seg_key = lo.Manifest.from_json(json.load(f)).variables["v"] \
            .segment_file
    buffers = {}
    for name in [lo.MANIFEST_NAME, seg_key]:
        with open(lo.segment_path(store_dir, name) if "/" in name
                  else os.path.join(store_dir, name), "rb") as f:
            buffers[name] = f.read()
    store = _open(store_dir, backend=tst.InMemoryBackend(buffers))
    xh, bound, _ = tst.RetrievalService(store).open_session().retrieve(
        "v", 1e-3)
    assert float(np.abs(xh - field).max()) <= bound <= 1e-3


def test_planner_sees_true_range_sizes(store_dir):
    v = _open(store_dir).variable("v")
    refd = lo.chunk_refactored(v, 0)
    for pm, pe in zip(refd.pieces, v.chunks[0].pieces):
        assert pm.sign_seg.is_stub and pm.sign_seg.stored_bytes == pe.sign.size
        for g, gr in zip(pm.groups, pe.groups):
            assert g.is_stub and g.stored_bytes == gr.size


def test_retrieve_many_matches_reference(store_dir, field):
    """Batched multi-session serving: the results of the reference's
    ``retrieve_many`` on the same store, and duplicate (session, var) pairs
    accounted once."""
    tsvc = tst.RetrievalService(_open(store_dir))
    jsvc = jst.RetrievalService(jst.DatasetStore.open(store_dir))
    outs = []
    for svc in (tsvc, jsvc):
        s1, s2 = svc.open_session(), svc.open_session()
        outs.append(svc.retrieve_many([(s1, "v", 1e-3), (s2, "v", 1e-4),
                                       (s1, "v", 1e-2)]))
    for (xt, bt, ft), (xj, bj, fj) in zip(*outs):
        assert _bits(xt) == _bits(xj) and (bt, ft) == (bj, fj)
    (x1, b1, f1), (x2, b2, f2), (x3, b3, f3) = outs[0]
    assert float(np.abs(x2 - field).max()) <= b2 <= 1e-4
    assert f1 > 0 and f3 == 0 and _bits(x1) == _bits(x3)


def test_met_tolerance_rerequest_skips_decode(store_dir):
    s = tst.RetrievalService(_open(store_dir)).open_session()
    x1, _, _ = s.retrieve("v", 1e-3)
    x2, _, fetched = s.retrieve("v", 1e-3)
    assert fetched == 0
    assert x2 is x1


def test_qoi_concurrent_sessions(tmp_path):
    vs = list(velocity_field((20, 20, 20), seed=3))
    truth = sum(v.astype(np.float64) ** 2 for v in vs)
    root = str(tmp_path / "qoi_store")
    _write(tst, root, dict(zip(["vx", "vy", "vz"], vs)), chunk_elems=1 << 20)
    svc = tst.RetrievalService(_open(root))
    results = []

    def client():
        s = svc.open_session()
        for tau in [1e-2, 1e-4]:
            before = s.bytes_fetched
            res = s.retrieve_qoi(["vx", "vy", "vz"], qq.V_TOTAL, tau)
            actual = float(np.abs(sum(v.astype(np.float64) ** 2
                                      for v in res.values) - truth).max())
            results.append((res.converged, res.tau_estimated, tau, actual,
                            s.bytes_fetched - before))

    threads = [threading.Thread(target=client) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert len(results) == 4
    for converged, tau_est, tau, actual, delta in results:
        assert converged and actual <= tau_est <= tau
        assert delta > 0


def test_interrupted_rewrite_keeps_old_store_consistent(tmp_path):
    root = str(tmp_path / "rw")
    x = gaussian_field((30, 30), seed=5)
    _write(tst, root, {"v": x}, chunk_elems=1 << 20)
    w2 = tst.DatasetWriter(root, chunk_elems=1 << 20, use_tune_cache=False,
                           device="cpu")
    w2.write("v", (x * 2).astype(np.float32))  # finalize never runs yet
    s = tst.RetrievalService(_open(root)).open_session()
    xh, bound, _ = s.retrieve("v", 1e-4)
    assert float(np.abs(xh - x).max()) <= bound
    w2.finalize()
    s2 = tst.RetrievalService(_open(root)).open_session()
    xh2, bound2, _ = s2.retrieve("v", 1e-4)
    assert float(np.abs(xh2 - x * 2).max()) <= bound2


def test_relative_tolerance_uses_global_range(store_dir, field):
    s = tst.RetrievalService(_open(store_dir)).open_session()
    xh, bound, _ = s.retrieve("v", 1e-3, relative=True)
    rng = float(field.max() - field.min())
    assert float(np.abs(xh - field).max()) <= 1e-3 * rng


def test_write_duplicate_name_raises(tmp_path, field):
    root = str(tmp_path / "dup")
    with tst.DatasetWriter(root, chunk_elems=16000, use_tune_cache=False,
                           device="cpu") as w:
        w.write("v", field)
        with pytest.raises(ValueError, match="already written"):
            w.write("v", field * 2)
        with pytest.raises(ValueError, match="invalid variable name"):
            w.write("", field)
        w.write("u", field[0])
    store = _open(root)
    assert sorted(store.variables) == ["u", "v"]
    xh, bound, _ = tst.RetrievalService(store).open_session().retrieve(
        "v", 1e-3)
    assert float(np.abs(xh - field).max()) <= bound


def test_manifest_records_write_plan(store_dir):
    store = _open(store_dir)
    v = store.variable("v")
    cfg = tn.RefactorConfig.from_json(v.plan)
    assert cfg.design == v.design and cfg.group_size == v.group_size
    r = tst.RetrievalService(store).open_session().reader("v")
    assert r.plan_config == tn.as_config(cfg)


def test_pre_plan_manifest_loads_and_serves(tmp_path, field):
    root = str(tmp_path / "legacy")
    _write(tst, root, {"v": field}, chunk_elems=16000)
    s = tst.RetrievalService(_open(root)).open_session()
    x_new, b_new, f_new = s.retrieve("v", 1e-3)
    mpath = os.path.join(root, lo.MANIFEST_NAME)
    with open(mpath) as f:
        j = json.load(f)
    j.pop("crc32", None)
    for v in j["variables"].values():
        v.pop("plan", None)
        v.pop("shards", None)
        for c in v["chunks"]:
            for p in c["pieces"]:
                p["sign"] = p["sign"][:3]
                p["groups"] = [g[:3] for g in p["groups"]]
    with open(mpath, "w") as f:
        json.dump(j, f)
    store = _open(root)
    assert store.variable("v").plan is None
    assert store.variable("v").chunks[0].pieces[0].sign.crc is None
    x_old, b_old, f_old = (tst.RetrievalService(store).open_session()
                           .retrieve("v", 1e-3))
    assert _bits(x_old) == _bits(x_new) and (b_old, f_old) == (b_new, f_new)


def test_unknown_manifest_keys_ignored(tmp_path, field):
    root = str(tmp_path / "future")
    _write(tst, root, {"v": field}, chunk_elems=16000)
    mpath = os.path.join(root, lo.MANIFEST_NAME)
    with open(mpath) as f:
        j = json.load(f)
    j["future_top_level"] = {"a": 1}
    for v in j["variables"].values():
        v["future_variable_key"] = [1, 2, 3]
        v["plan"]["future_knob"] = "x"
    j["crc32"] = rl.manifest_body_checksum(j["variables"])
    with open(mpath, "w") as f:
        json.dump(j, f)
    xh, bound, _ = tst.RetrievalService(_open(root)).open_session().retrieve(
        "v", 1e-3)
    assert float(np.abs(xh - field).max()) <= bound <= 1e-3


def test_groupref_and_plan_roundtrip():
    for crc in (None, 0, 2 ** 32 - 1):
        g = lo.GroupRef(12, 34, "huffman", crc)
        j = json.loads(json.dumps(g.to_json()))
        assert lo.GroupRef.from_json(j) == g
        assert len(j) == (3 if crc is None else 4)
    base = lo.VariableEntry(
        name="v", shape=(8,), levels=1, design="register_block", mag_bits=30,
        group_size=4, chunk_elems=8, segment_file="segments/v.seg",
        amax=1.0, range=2.0, chunks=[])
    assert "plan" not in base.to_json()
    for backend in ("auto", "cuda", "torch"):
        cfg = tn.RefactorConfig(design="shuffle", group_size=8, depth=3,
                                backend=backend)
        import dataclasses
        e = dataclasses.replace(base, plan=wr.plan_json(cfg))
        back = lo.VariableEntry.from_json(json.loads(json.dumps(e.to_json())))
        assert tn.RefactorConfig.from_json(back.plan) == cfg


def test_checksum_detects_segment_byte_flip(store_dir, tmp_path):
    root = str(tmp_path / "flip")
    shutil.copytree(store_dir, root)
    store = _open(root)
    v = store.variable("v")
    ref = v.chunks[0].pieces[0].groups[0]
    assert ref.crc is not None
    with open(lo.segment_path(root, v.segment_file), "r+b") as f:
        f.seek(ref.offset + ref.size // 2)
        b = f.read(1)
        f.seek(ref.offset + ref.size // 2)
        f.write(bytes([b[0] ^ 0x40]))
    store.backend.drop_cache()
    with pytest.raises(rl.CorruptSegmentError):
        store.read_segment("v", ref)
    store.close()
    unchecked = _open(root, verify=False)
    try:
        unchecked.read_segment("v", ref)
    except ValueError:
        pass
    finally:
        unchecked.close()


def test_manifest_body_checksum_detects_tamper(store_dir):
    with open(os.path.join(store_dir, lo.MANIFEST_NAME)) as f:
        j = json.load(f)
    assert "crc32" in j
    lo.Manifest.from_json(json.loads(json.dumps(j)))
    v = next(iter(j["variables"].values()))
    v["chunks"][0]["pieces"][0]["groups"][0][1] += 1
    with pytest.raises(rl.CorruptSegmentError):
        lo.Manifest.from_json(j)
    # the reference's reader refuses the same tampered body
    from repro.store import layout as jlo
    from repro.store import reliability as jrl
    with pytest.raises(jrl.CorruptSegmentError):
        jlo.Manifest.from_json(j)
