"""The port's exact bitcast codec and checkpoint manager vs the JAX reference,
on the CPU (ports of tests/test_ckpt_train.py's codec and checkpoint tests
and of tests/test_pipeline_fp64.py's float64 codec tests).

Inputs are made with numpy from a seed and given to both packages; the port
runs with ``device="cpu"``.  Tolerance: none.  Blobs are byte-identical for
float32, bfloat16, float16, int32 and float64 (both signs, signed zeros,
subnormals; float64 across 2**-40 .. 2**40); retrieves give the same bits
and byte counts at every relative error; each package reads the other's
blobs and checkpoint directories, whose files are byte-identical and whose
manifests differ only in ``time``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.ckpt import bitcast_codec as jbc  # noqa: E402
from repro.ckpt import manager as jck  # noqa: E402
from repro.core import lossless as jll  # noqa: E402
from repro_torch.ckpt import bitcast_codec as bc  # noqa: E402
from repro_torch.ckpt import manager as ck  # noqa: E402

torch.set_num_threads(1)

DTYPES = ["float32", "bfloat16", "float16", "int32", "float64"]
SIZES = [1, 1000, 3000, 4095, 4096, 4097, 20000]
RELS = [1e-1, 1e-2, 1e-4, 1e-6, None]
# a value this far below 1 is subnormal in each float format
SUBNORMAL = {"float32": 2.0 ** -140, "bfloat16": 2.0 ** -130,
             "float16": 2.0 ** -20, "float64": 2.0 ** -1040}


def _values(dtype, n, seed=0):
    """numpy input of ``dtype`` (``ml_dtypes`` bfloat16, as jax gives it):
    both signs, signed zeros and subnormals; float64 across 2**-40 ..
    2**40."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    span = 40 if dtype == "float64" else 12
    x = rng.normal(size=n) * np.exp2(rng.integers(-span, span + 1, n))
    x[::7] = 0.0
    x[3::11] = -0.0
    x[5::13] = SUBNORMAL[dtype] * rng.normal(size=x[5::13].size)
    if dtype == "float64":
        return x
    return np.asarray(jnp.asarray(x.astype(np.float32), jnp.dtype(dtype)))


def _bytes(t):
    """The raw bytes of a tensor or numpy array."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


# ------------------------------------------------------------------- codec --

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_blobs_and_retrieves_match_reference(dtype, n):
    x = _values(dtype, n, seed=n)
    blob = bc.exact_to_bytes(bc.exact_refactor(x, device="cpu"))
    jblob = jbc.exact_to_bytes(jbc.exact_refactor(x))
    assert blob == jblob
    r = bc.exact_from_bytes(jblob)          # the port reads the reference's
    assert bc.exact_to_bytes(r) == jblob
    jr = jbc.exact_from_bytes(blob)         # the reference reads the port's
    prev = 0
    for rel in RELS:
        got, nb = bc.exact_retrieve(r, rel, device="cpu")
        want, jnb = jbc.exact_retrieve(jr, rel)
        assert got.dtype == bc.TORCH_DTYPES[dtype]
        assert tuple(got.shape) == want.shape == (n,)
        assert nb == jnb and nb >= prev
        assert _bytes(got) == _bytes(want), rel
        prev = nb
    assert _bytes(got) == _bytes(x)         # rel None: bit-exact


def test_progressive_relative_error():
    """The port alone: each prefix honours its relative bound, and bytes
    never decrease (tests/test_ckpt_train.py's codec test)."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=5000)
         * np.exp2(rng.integers(-10, 10, 5000))).astype(np.float32)
    r = bc.exact_refactor(torch.from_numpy(x), device="cpu")
    prev = 0
    for rel in [1e-1, 1e-2, 1e-4, None]:
        out, nb = bc.exact_retrieve(r, rel, device="cpu")
        if rel is not None:
            err = np.abs(out.numpy().astype(np.float64) - x)
            assert (err / np.maximum(np.abs(x), 1e-30)).max() \
                <= rel * 1.01 + 2 ** -23
        assert nb >= prev
        prev = nb
    assert np.array_equal(out.numpy(), x)


def test_fp64_codec_bit_exact_and_progressive():
    rng = np.random.default_rng(0)
    x = rng.normal(size=4000) * np.exp2(rng.integers(-40, 40, 4000))
    r = bc.exact_refactor(x, device="cpu")
    assert r.n_bits == 64 and sum(r.group_planes) == 64
    full, nb_full = bc.exact_retrieve(r, None, device="cpu")
    assert full.dtype == torch.float64
    assert _bytes(full) == _bytes(x)
    approx, nb_part = bc.exact_retrieve(r, 1e-3, device="cpu")
    rel = np.abs(approx.numpy() - x) / np.maximum(np.abs(x), 1e-300)
    assert rel.max() <= 1e-3 * 1.01 + 2 ** -20
    assert nb_part < nb_full


def test_tensor_input_keeps_its_dtype_and_shape():
    x = _values("bfloat16", 3000, seed=4).reshape(30, 100)
    t = bc.as_tensor(x, "cpu")
    assert t.dtype == torch.bfloat16
    r = bc.exact_refactor(t, device="cpu")
    assert bc.exact_to_bytes(r) == jbc.exact_to_bytes(jbc.exact_refactor(x))
    out, _ = bc.exact_retrieve(r, None, device="cpu")
    assert out.shape == (30, 100) and torch.equal(out, t)


def _pallas_width(jr, words):
    """The reference blob ``jr`` as its Pallas path would write it: each
    group's planes padded with zero words to ``words`` a plane (the
    padding elements are zeros, whose tiles come last in every plane)."""
    groups = []
    for g, seg in zip(jr.group_planes, jr.groups):
        w = seg.meta["n_words"]
        planes = jll.decompress_group(seg).view(np.uint32).reshape(g, w)
        wide = np.zeros((g, words), np.uint32)
        wide[:, :w] = planes
        s = jll.compress_group(wide.reshape(-1).view(np.uint8))
        s.meta["n_planes"] = g
        s.meta["n_words"] = words
        groups.append(s)
    return jbc.ExactRefactored(jr.dtype, jr.shape, jr.n_bits, jr.n_exp,
                               list(jr.group_planes), groups)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_pallas_width_blob_decodes(dtype):
    """The reference's Pallas path pads N to 4096 * tiles_per_block (8): a
    blob it writes has more words per plane, which the port reads from each
    group's ``n_words``."""
    x = _values(dtype, 5000, seed=9)
    jr = jbc.exact_refactor(x)
    assert jr.groups[0].meta["n_words"] == 256
    wide = bc.exact_from_bytes(jbc.exact_to_bytes(_pallas_width(jr, 1024)))
    for rel in RELS:
        got, _ = bc.exact_retrieve(wide, rel, device="cpu")
        want, _ = jbc.exact_retrieve(jr, rel)
        assert _bytes(got) == _bytes(want), rel


# ------------------------------------------------------------- checkpoints --

def _trees(seed=2):
    """The same tree for both packages: nested dicts, a list, a bfloat16
    leaf, a leaf under 1024 elements, a 0-d int and a repeated sanitized
    name."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    emb = _values("bfloat16", 2048, seed=seed)
    half = rng.normal(size=(4096,)).astype(np.float16)
    small = rng.normal(size=(10,)).astype(np.float32)
    ids = rng.integers(-1000, 1000, (32, 40)).astype(np.int32)
    jt = {"layer": {"w": jnp.asarray(w), "bias": jnp.asarray(small),
                    "ids": jnp.asarray(ids)},
          "emb": [jnp.asarray(emb), jnp.asarray(half)],
          "step": jnp.int32(3), "a b": jnp.asarray(small),
          "a_b": jnp.asarray(small * 2)}
    tt = {"layer": {"w": torch.from_numpy(w), "bias": torch.from_numpy(small),
                    "ids": torch.from_numpy(ids)},
          "emb": [bc.as_tensor(emb, "cpu"), torch.from_numpy(half)],
          "step": torch.tensor(3, dtype=torch.int32),
          "a b": torch.from_numpy(small), "a_b": torch.from_numpy(small * 2)}
    return jt, tt


def _step_dir(root, step):
    return root / f"step_{step:08d}"


def _same_checkpoint(a, b):
    ma = json.loads((a / "manifest.json").read_text())
    mb = json.loads((b / "manifest.json").read_text())
    ma.pop("time")
    mb.pop("time")
    assert ma == mb
    for entry in ma["leaves"].values():
        assert (a / entry["file"]).read_bytes() == \
            (b / entry["file"]).read_bytes(), entry["file"]
    return ma


def _leaves(tree):
    return [v for _, v in ck._paths(tree)]


def test_checkpoints_cross_load(tmp_path):
    jt, tt = _trees()
    jck.save(tmp_path / "ref", 3, jt)
    ck.save(tmp_path / "port", 3, tt, device="cpu")
    man = _same_checkpoint(_step_dir(tmp_path / "ref", 3),
                           _step_dir(tmp_path / "port", 3))
    assert list(man["leaves"]) == ["a_b", "a_b__1", "emb.0", "emb.1",
                                   "layer.bias", "layer.ids", "layer.w",
                                   "step"]
    assert man["leaves"]["step"] == {"dtype": "int32", "shape": [],
                                     "codec": "raw", "file": "step.raw",
                                     "stored_bytes": 4, "raw_bytes": 4}
    assert man["leaves"]["emb.0"]["codec"] == "mdr"
    assert man["leaves"]["emb.0"]["dtype"] == "bfloat16"
    assert man["leaves"]["layer.bias"]["codec"] == "raw"
    fractions = []
    for rel in (None, 1e-2):
        # the port reads the reference's checkpoint, and the other way round
        got, st = ck.load(tmp_path / "ref", 3, tt, rel_error=rel,
                          device="cpu")
        want, jst = jck.load(tmp_path / "port", 3, jt, rel_error=rel)
        assert st == jst
        fractions.append(st["read_fraction"])
        assert got.keys() == tt.keys() and isinstance(got["emb"], list)
        for g, w, orig in zip(_leaves(got), _leaves(want), _leaves(tt)):
            assert g.dtype == orig.dtype and g.shape == orig.shape
            assert _bytes(g) == _bytes(w)
            if rel is None:
                assert torch.equal(g, orig)
    assert fractions[1] < fractions[0] <= 1.0
    assert ck.latest_step(tmp_path / "ref") == 3


def test_load_rejects_an_unknown_manifest_dtype(tmp_path):
    ck.save(tmp_path, 1, {"b": torch.ones(4)}, device="cpu")
    path = _step_dir(tmp_path, 1) / "manifest.json"
    man = json.loads(path.read_text())
    man["leaves"]["b"]["dtype"] = "save"
    path.write_text(json.dumps(man))
    with pytest.raises(ValueError, match="unknown dtype"):
        ck.load(tmp_path, 1, {"b": torch.ones(4)}, device="cpu")


def test_tuples_and_none_keep_their_structure(tmp_path):
    tree = {"t": (torch.ones(3), torch.zeros(2)), "none": None,
            "l": [torch.arange(4)]}
    ck.save(tmp_path, 1, tree, device="cpu")
    got, _ = ck.load(tmp_path, 1, tree, device="cpu")
    assert isinstance(got["t"], tuple) and got["none"] is None
    assert torch.equal(got["t"][1], tree["t"][1])
    assert torch.equal(got["l"][0], tree["l"][0])
    jgot, _ = jck.load(tmp_path, 1, {"t": (np.ones(3, np.float32),
                                           np.zeros(2, np.float32)),
                                     "none": None,
                                     "l": [np.arange(4)]})
    assert np.array_equal(np.asarray(jgot["l"][0]), np.arange(4))


def test_load_places_leaves_by_a_device_tree(tmp_path):
    _, tt = _trees()
    ck.save(tmp_path, 1, tt, device="cpu")
    devs = {k: ([("cpu") for _ in v] if isinstance(v, list) else
                {kk: torch.device("cpu") for kk in v}
                if isinstance(v, dict) else "cpu") for k, v in tt.items()}
    got, _ = ck.load(tmp_path, 1, tt, device=devs)
    assert all(torch.equal(g, o) for g, o in zip(_leaves(got),
                                                 _leaves(tt)))
    with pytest.raises(ValueError, match="device tree"):
        ck.load(tmp_path, 1, tt, device={"a": "cpu"})


def test_async_checkpointer(tmp_path):
    a = ck.AsyncCheckpointer(tmp_path, device="cpu")
    w = torch.ones(2048)
    a.save(5, {"w": w})
    w.fill_(2.0)                 # the snapshot was taken at save()
    a.wait()
    assert ck.latest_step(tmp_path) == 5
    got, _ = ck.load(tmp_path, 5, {"w": w}, device="cpu")
    assert torch.equal(got["w"], torch.ones(2048))


def test_async_checkpointer_raises_at_wait(tmp_path):
    (tmp_path / "file").write_text("not a directory")
    a = ck.AsyncCheckpointer(tmp_path / "file", device="cpu")
    a.save(1, {"w": torch.ones(8)})
    with pytest.raises(OSError):
        a.wait()
    a.wait()                     # the error is raised once


def test_save_sweeps_stale_tmp_dirs(tmp_path):
    tree = {"w": torch.ones(64)}
    stale = tmp_path / ".tmp_step_00000007"
    stale.mkdir(parents=True)
    (stale / "w.raw").write_bytes(b"\0" * 256)  # half-written leftovers
    ck.save(tmp_path, 9, tree, device="cpu")
    assert not stale.exists()
    assert ck.latest_step(tmp_path) == 9
    loaded, _ = ck.load(tmp_path, 9, tree, device="cpu")
    assert torch.equal(loaded["w"], tree["w"])


def test_mid_save_crash_leaves_previous_checkpoint_loadable(tmp_path,
                                                            monkeypatch):
    rng = np.random.default_rng(4)
    tree1, tree2 = ({"w": torch.from_numpy(
        rng.normal(size=(2048,)).astype(np.float32))} for _ in range(2))
    ck.save(tmp_path, 1, tree1, device="cpu")

    calls = {"n": 0}
    real_write_bytes = ck.Path.write_bytes

    def crashing_write_bytes(self, data):
        calls["n"] += 1
        if calls["n"] == 1:
            # die mid-write: leave a partial file, then raise
            real_write_bytes(self, data[: len(data) // 2])
            raise RuntimeError("simulated crash mid-save")
        return real_write_bytes(self, data)

    monkeypatch.setattr(ck.Path, "write_bytes", crashing_write_bytes)
    with pytest.raises(RuntimeError):
        ck.save(tmp_path, 2, tree2, device="cpu")
    monkeypatch.setattr(ck.Path, "write_bytes", real_write_bytes)
    assert ck.latest_step(tmp_path) == 1
    loaded, _ = ck.load(tmp_path, 1, tree1, device="cpu")
    assert torch.equal(loaded["w"], tree1["w"])
    assert (tmp_path / ".tmp_step_00000002").exists()
    ck.save(tmp_path, 3, tree2, device="cpu")
    assert not (tmp_path / ".tmp_step_00000002").exists()
    assert ck.latest_step(tmp_path) == 3
    loaded3, _ = ck.load(tmp_path, 3, tree2, device="cpu")
    assert torch.equal(loaded3["w"], tree2["w"])


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    x = np.ones(2048, np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bc.exact_refactor(x)
    r = bc.exact_refactor(x, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bc.exact_retrieve(r)
    tree = {"w": torch.from_numpy(x)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ck.save(tmp_path, 1, tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ck.AsyncCheckpointer(tmp_path)
    ck.save(tmp_path, 1, tree, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ck.load(tmp_path, 1, tree)


# ------------------------------------------- training state across packages --

def _train_trees():
    """The ``Trainer``'s checkpoint tree, ``{"params", "opt": AdamWState,
    "ef"}``, in both packages with the same values."""
    import jax
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw

    rng = np.random.default_rng(4)
    leaf = lambda *s: rng.normal(size=s).astype(np.float32)
    p, m, v, ef = ({"w": leaf(64, 64), "b": leaf(8)} for _ in range(4))
    jt = {"params": p, "ef": ef,
          "opt": jadamw.AdamWState(step=jnp.asarray(7, jnp.int32),
                                   m=jax.tree.map(jnp.asarray, m),
                                   v=jax.tree.map(jnp.asarray, v))}
    to_t = lambda d: {k: torch.from_numpy(x.copy()) for k, x in d.items()}
    tt = {"params": to_t(p), "ef": to_t(ef),
          "opt": adamw.AdamWState(step=torch.tensor(7, dtype=torch.int32),
                                  m=to_t(m), v=to_t(v))}
    return jt, tt


def test_named_tuples_are_named_by_field_and_rebuilt(tmp_path):
    from repro_torch.optim import adamw
    jt, tt = _train_trees()
    jck.save(tmp_path / "ref", 1, jt)
    ck.save(tmp_path / "port", 1, tt, device="cpu")
    man = _same_checkpoint(_step_dir(tmp_path / "ref", 1),
                           _step_dir(tmp_path / "port", 1))
    # a NamedTuple flattens in field order, a dict in sorted key order
    assert list(man["leaves"]) == [
        "ef.b", "ef.w", "opt.step", "opt.m.b", "opt.m.w", "opt.v.b",
        "opt.v.w", "params.b", "params.w"]
    got, _ = ck.load(tmp_path / "ref", 1, tt, device="cpu")
    assert type(got["opt"]) is adamw.AdamWState
    assert int(got["opt"].step) == 7 and got["opt"].step.dtype == torch.int32
    for g, w in zip(_leaves(got), _leaves(tt)):
        assert torch.equal(g, w)
    want, _ = jck.load(tmp_path / "port", 1, jt)
    assert type(want["opt"]).__name__ == "AdamWState"
    for g, w in zip(_leaves(got), [np.asarray(x) for x in
                                   __import__("jax").tree.leaves(want)]):
        assert _bytes(g) == _bytes(w)


def _tiny_trainers(ckpt_dir, total):
    """A reference and a port ``Trainer`` of one tiny model (the
    reference's ``tests/test_ckpt_train.py`` config), 8-plane gradient
    compression, checkpoints in ``ckpt_dir``."""
    import jax
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models.model import Model as JModel
    from repro.optim import adamw as jadamw
    from repro.train import loop as jloop
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_from_reference
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    kw = dict(name="tiny", family="dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
              compute_dtype="float32", remat=False)
    jm = JModel(JModelConfig(**kw))
    m = Model(ModelConfig(**kw), params_from_reference(
        jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))), "cpu"),
        device="cpu")
    okw = dict(lr=1e-3, warmup_steps=2, total_steps=total)
    tkw = dict(total_steps=total, ckpt_every=2, ckpt_dir=str(ckpt_dir),
               log_every=1, grad_compress_planes=8)
    ref = jloop.Trainer(jm, jadamw.AdamWConfig(**okw),
                        jloop.TrainerConfig(**tkw),
                        jloop.synthetic_data(jm.cfg, 4, 16, seed=1))
    port = loop.Trainer(m, adamw.AdamWConfig(**okw), loop.TrainerConfig(**tkw),
                        loop.synthetic_data(m.cfg, 4, 16, seed=1,
                                            device="cpu"))
    return ref, port


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_trainer_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    import shutil
    first = _tiny_trainers(tmp_path / "a", 4)[writer == "port"]
    first.run()
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    ref, _ = _tiny_trainers(tmp_path / "a", 5)
    _, port = _tiny_trainers(tmp_path / "b", 5)
    want, got = ref.run(), port.run()
    assert want["final_step"] == got["final_step"] == 5
    assert [r["step"] for r in got["metrics"]] == [5]   # resumed at step 4
    assert got["metrics"][0]["loss"] == pytest.approx(
        want["metrics"][0]["loss"], rel=1e-5)
    assert got["metrics"][0]["grad_norm"] == pytest.approx(
        want["metrics"][0]["grad_norm"], rel=1e-4)
    assert int(got["opt_state"].step) == 5
