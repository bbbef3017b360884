"""The port's training path vs the JAX reference, on the CPU: AdamW,
error-feedback gradient compression, the train step, synthetic data, the
``Trainer`` and the ``launch.train`` CLI.

Inputs are made with numpy from seeds and handed to both packages; the
reference's outputs are computed once per module where several tests read
them.

Tolerances, and why:
* ``adamw.update`` from the reference's state and gradients, without
  clipping: the moments bit-identical at every step, the parameters
  bit-identical at every step where the learning rate is, and within one
  ulp where it is not.  The learning rate is bit-identical or one ulp off:
  XLA's CPU ``cos`` is glibc's ``cosf``, which differs from torch's by an
  ulp at some arguments (no step of the warmup, where the argument is 0).
  Under clipping the port's global norm (accumulated in float64) and XLA's
  float32 reduction differ in the last bits, so the scaled gradient
  differs by an ulp, the moments by under 1e-6 of a leaf's largest and
  each parameter's step by under 1e-6 of the learning rate;
* ``ef_quantize``: q, the residual and the packed planes bit- and
  byte-identical;
* the train step and the ``Trainer``: losses within 1e-5 relative of the
  reference's, then within 1e-3 after 10 steps (float32 compute; the
  gradients agree within ``test_torch_train_grads``' tolerances, and Adam's
  first steps move each parameter by about ``lr * sign(g)``, so a
  parameter whose gradient is near 0 may step the other way);
* ``synthetic_data``: identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import smoke_config as jsmoke  # noqa: E402
from repro.distributed import grad_compress as jgc  # noqa: E402
from repro.launch.policy import CellPolicy as JCellPolicy  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs.base import ModelConfig, smoke_config  # noqa: E402
from repro_torch.distributed import grad_compress as gc  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.policy import CellPolicy, tp_friendly  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (_leaf_tensor,  # noqa: E402
                                       params_from_reference, tree_leaves)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import loop, step  # noqa: E402

torch.set_num_threads(1)

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, compute_dtype="float32",
            remat=False)


def bits(x):
    """A float tensor or array as integers of its width (bit equality)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()]
                      ).numpy()
    a = np.asarray(x)
    return np.ascontiguousarray(a).view({2: np.int16, 4: np.int32}[a.itemsize])


def ulps(a, b):
    """Largest distance in units in the last place between float32s."""
    ia = bits(a).astype(np.int64)
    ib = bits(b).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


def to_torch(tree):
    return jax.tree.map(lambda x: _leaf_tensor(np.asarray(x)), tree)


def port_state(js):
    return adamw.AdamWState(step=torch.tensor(int(js.step),
                                              dtype=torch.int32),
                            m=to_torch(js.m), v=to_torch(js.v))


def grad_tree(rng, scale):
    return {"a": (rng.normal(size=20_000) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(300, 7)) * scale).astype(np.float32),
                  "d": (rng.normal(size=(5,)) * scale).astype(np.float32)}}


# ------------------------------------------------------------------ adamw --

@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_bit_identical_to_the_jitted_reference(state_dtype):
    kw = dict(warmup_steps=3, total_steps=12, clip_norm=1e9,
              state_dtype=state_dtype)
    jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    jp = jax.tree.map(jnp.asarray, grad_tree(rng, 1.0))
    js = jadamw.init(jp, jcfg)
    upd = jax.jit(jadamw.update, static_argnums=3)
    lr_equal = 0
    for it in range(12):
        g = grad_tree(rng, 1e-3 if it % 2 else 3.0)
        p_in, s_in = to_torch(jp), port_state(js)
        jp, js, jm = upd(jax.tree.map(jnp.asarray, g), js, jp, jcfg)
        tp, ts, tm = adamw.update(to_torch(g), s_in, p_in, cfg)
        assert int(ts.step) == int(js.step) == it + 1
        assert tm["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]),
                                                       rel=1e-6)
        same_lr = ulps(tm["lr"], jm["lr"])
        assert same_lr <= 1, it
        lr_equal += same_lr == 0
        for name, want, got in (("m", js.m, ts.m), ("v", js.v, ts.v)):
            for w, h in zip(jax.tree.leaves(want), tree_leaves(got)):
                assert h.dtype == adamw.DTYPES[state_dtype]
                np.testing.assert_array_equal(bits(w), bits(h), err_msg=name)
        for w, h in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            if same_lr == 0:
                np.testing.assert_array_equal(bits(w), bits(h))
            else:
                assert ulps(w, h) <= 1
    assert lr_equal >= 10   # 4 warmup steps and most of the cosine


def test_adamw_update_under_clipping_within_the_stated_bound():
    jcfg = jadamw.AdamWConfig(warmup_steps=2, total_steps=8)
    cfg = adamw.AdamWConfig(warmup_steps=2, total_steps=8)
    rng = np.random.default_rng(1)
    jp = jax.tree.map(jnp.asarray, grad_tree(rng, 1.0))
    js = jadamw.init(jp, jcfg)
    upd = jax.jit(jadamw.update, static_argnums=3)
    for it in range(4):
        g = grad_tree(rng, 2.0)          # global norm ~290: clipped
        p_in, s_in = to_torch(jp), port_state(js)
        jp, js, jm = upd(jax.tree.map(jnp.asarray, g), js, jp, jcfg)
        tp, ts, tm = adamw.update(to_torch(g), s_in, p_in, cfg)
        assert float(jm["grad_norm"]) > 100
        assert ulps(tm["grad_norm"], jm["grad_norm"]) <= 4
        for want, got in ((js.m, ts.m), (js.v, ts.v)):
            for w, h in zip(jax.tree.leaves(want), tree_leaves(got)):
                w = np.asarray(w, np.float64)
                assert (np.abs(w - h.double().numpy()).max()
                        <= 1e-6 * np.abs(w).max())
        lr = float(jm["lr"])
        for w, h in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            w = np.asarray(w)
            # the step itself within 1e-6 of lr, plus the parameter's ulp
            bound = np.spacing(np.abs(w)).astype(np.float64) + 1e-6 * lr
            assert (np.abs(w.astype(np.float64) - h.double().numpy())
                    <= bound).all()


def test_adamw_schedule_over_warmup_and_decay():
    jcfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=40)
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=40)
    sched = jax.jit(lambda s: jadamw._schedule(jcfg, s))
    worst = 0
    for s in range(0, 45):
        want = sched(jnp.float32(s))
        got = adamw._schedule(cfg, torch.tensor(float(s)))
        d = ulps(got, want)
        if s <= 5:
            assert d == 0, s
        worst = max(worst, d)
    assert worst <= 1


def test_adamw_init_and_state_dtypes():
    p = {"w": torch.ones(3, 4), "n": {"b": torch.ones(2)}}
    for sdt, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        s = adamw.init(p, adamw.AdamWConfig(state_dtype=sdt))
        assert s.step.dtype == torch.int32 and int(s.step) == 0
        assert s.m["w"].dtype == dt and s.v["n"]["b"].shape == (2,)
        assert not s.m["w"].any()


# -------------------------------------------------------------- ef_quantize --

def _ef_cases():
    rng = np.random.default_rng(0)
    sub = (rng.normal(size=4100) * 1e-39).astype(np.float32)
    mixed = (rng.normal(size=4100) * 1e-36).astype(np.float32)
    mixed[:50] = sub[:50]
    below = rng.uniform(-1, 1, size=8193).astype(np.float32)
    below[7] = np.nextafter(np.float32(2), np.float32(0))
    return {
        "normal_5000": (rng.normal(size=5000).astype(np.float32),
                        (rng.normal(size=5000) * 1e-3).astype(np.float32)),
        "all_zero_777": (np.zeros(777, np.float32), np.zeros(777, np.float32)),
        "subnormal": (sub, np.zeros(4100, np.float32)),
        "subnormal_residual": (mixed, sub),
        "amax_below_pow2": (below, np.zeros_like(below)),
        "matrix_33x129": (rng.normal(size=(33, 129)).astype(np.float32),
                          (rng.normal(size=(33, 129)) * 0.01
                           ).astype(np.float32)),
    }


EF_CASES = _ef_cases()


@pytest.mark.parametrize("planes", [1, 4, 8, 23])
@pytest.mark.parametrize("case", sorted(EF_CASES))
def test_ef_quantize_bit_and_byte_identical(case, planes):
    x, r = EF_CASES[case]
    jq, jr = jax.jit(jgc.ef_quantize, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(r), planes)
    tq, tr = gc.ef_quantize(torch.from_numpy(x), torch.from_numpy(r), planes)
    assert tq.shape == x.shape and tq.dtype == torch.float32
    np.testing.assert_array_equal(bits(jq), bits(tq))
    np.testing.assert_array_equal(bits(jr), bits(tr))
    flat = (x + r).reshape(-1)
    jpk, je = jax.jit(jgc._encode_planes, static_argnums=1)(
        jnp.asarray(flat), planes)
    tpk, te = gc._encode_planes(torch.from_numpy(flat), planes)
    assert tpk.shape == (planes + 1, -(-flat.size // 4096) * 128)
    assert np.asarray(jpk).tobytes() == tpk.numpy().tobytes()
    assert int(je) == int(te)
    dec = gc._decode_planes(tpk, te, flat.size, planes)
    np.testing.assert_array_equal(
        bits(jax.jit(jgc._decode_planes, static_argnums=(2, 3))(
            jpk, je, flat.size, planes)), bits(dec))


def test_ef_quantize_rejects_plane_counts_out_of_range():
    x = torch.ones(10)
    for planes in (0, 24):
        with pytest.raises(ValueError, match="planes"):
            gc.ef_quantize(x, torch.zeros(10), planes)


def test_ef_quantize_unbiased_accumulation():
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    res = torch.zeros_like(g)
    total_q = torch.zeros_like(g)
    for _ in range(8):
        q, res = gc.ef_quantize(g, res, planes=4)
        total_q = total_q + q
    # error feedback: accumulated quantized grads track accumulated true grads
    err = float((total_q - 8 * g).abs().max()) / float(g.abs().max())
    assert err < 0.15


# ------------------------------------------------------------- train step --

def _tiny_models():
    jcfg = JModelConfig(**TINY)
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    m = Model(ModelConfig(**TINY),
              params_from_reference(jax.tree.map(np.asarray, jparams), "cpu"),
              device="cpu")
    return jm, jparams, m


def _tiny_batch(seed=3, b=4, s=16):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, TINY["vocab_size"], (b, s)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}


@pytest.mark.parametrize("n_micro", [1, 2])
def test_make_train_step_matches_the_reference(n_micro):
    jm, jparams, m = _tiny_models()
    jcfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jfn = jax.jit(jstep.make_train_step(
        jm, jcfg, JCellPolicy((), n_micro, "float32", 16)))
    fn = step.make_train_step(m, cfg, CellPolicy((), n_micro, "float32", 16))
    batch = _tiny_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jp, js, tp, ts = jparams, jadamw.init(jparams, jcfg), m.params, None
    ts = adamw.init(tp, cfg)
    for _ in range(2):
        jp, js, jmet = jfn(jp, js, jb)
        tp, ts, tmet = fn(tp, ts, tb)
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                    rel=1e-5)
        assert float(tmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-4)
        lr = float(jmet["lr"])
        for w, h in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            d = np.abs(np.asarray(w, np.float64) - h.double().numpy())
            assert d.max() <= 4 * lr + 1e-6          # a sign flip at most
            assert (d > 1e-6).mean() < 0.01


def test_n_micro_accumulation_averages_the_microbatches():
    _, _, m = _tiny_models()
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    tb = {k: torch.from_numpy(v) for k, v in _tiny_batch().items()}
    outs = []
    for n in (1, 2):
        fn = step.make_train_step(m, cfg, CellPolicy((), n, "float32", 16))
        outs.append(fn(m.params, adamw.init(m.params, cfg), tb)[2])
    assert float(outs[1]["loss"]) == pytest.approx(float(outs[0]["loss"]),
                                                   rel=1e-6)
    assert float(outs[1]["grad_norm"]) == pytest.approx(
        float(outs[0]["grad_norm"]), rel=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        step.make_train_step(m, cfg, CellPolicy((), 3, "float32", 16))(
            m.params, adamw.init(m.params, cfg), tb)


def test_value_and_grad_gives_zeros_for_unread_leaves():
    p = {"a": torch.ones(3), "b": torch.ones(2, 2)}
    val, g = step.value_and_grad(lambda t: (t["a"] * 2).sum(), p)
    assert float(val) == 6 and not val.requires_grad
    assert torch.equal(g["a"], torch.full((3,), 2.0))
    assert torch.equal(g["b"], torch.zeros(2, 2))


def test_prefill_and_decode_steps_wrap_the_model():
    _, _, m = _tiny_models()
    toks = torch.from_numpy(_tiny_batch()["tokens"])
    logits, cache = step.make_prefill_step(m)(None, {"tokens": toks[:, :-1]})
    assert logits.shape == (4, 1, TINY["vocab_size"])
    full = m.forward(None, tokens=toks)
    _, cache = m.prefill(None, tokens=toks[:, :-1], max_len=16)
    out, _ = step.make_decode_step(m)(None, cache, 15,
                                      {"tokens": toks[:, -1:]})
    assert float((out[:, 0] - full[:, -1]).abs().max()) < 1e-4


def test_policy_tp_friendly_and_fields():
    assert tp_friendly(smoke_config("qwen2-7b")) is False   # 4 heads
    assert tp_friendly(dataclasses.replace(smoke_config("qwen2-7b"),
                                           n_heads=32)) is True
    p = CellPolicy(("data",), 2, "float32", 4096)
    assert (p.seq_shard, p.notes, p.n_micro) == (False, "", 2)


# --------------------------------------------------------- synthetic data --

@pytest.mark.parametrize("arch", ["qwen2-7b", "hubert-xlarge",
                                  "llama-3.2-vision-90b"])
def test_synthetic_data_identical(arch):
    jfn = jloop.synthetic_data(jsmoke(arch), 3, 16, seed=7)
    fn = loop.synthetic_data(smoke_config(arch), 3, 16, seed=7,
                             device="cpu")
    for s in (0, 1, 5):
        want, got = jfn(s), fn(s)
        assert sorted(want) == sorted(got)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].dtype == {np.dtype(np.int32): torch.int32,
                                    np.dtype(np.float32): torch.float32
                                    }[w.dtype]
            np.testing.assert_array_equal(got[k].numpy(), w)


# ---------------------------------------------------------------- trainer --

def _trainers(tmp_path, planes, steps=10):
    jm, jparams, m = _tiny_models()
    kw = dict(lr=1e-3, warmup_steps=3, total_steps=steps)
    t_kw = dict(total_steps=steps, ckpt_every=5, log_every=1,
                grad_compress_planes=planes)
    jt = jloop.Trainer(jm, jadamw.AdamWConfig(**kw),
                       jloop.TrainerConfig(ckpt_dir=str(tmp_path / "j"),
                                           **t_kw),
                       jloop.synthetic_data(jm.cfg, 4, 16, seed=1))
    t = loop.Trainer(m, adamw.AdamWConfig(**kw),
                     loop.TrainerConfig(ckpt_dir=str(tmp_path / "t"), **t_kw),
                     loop.synthetic_data(m.cfg, 4, 16, seed=1, device="cpu"))
    return jt, t


@pytest.mark.parametrize("planes", [0, 8])
def test_trainer_tracks_the_reference_trainer(tmp_path, planes):
    jt, t = _trainers(tmp_path, planes)
    want, got = jt.run(), t.run()
    assert got["final_step"] == want["final_step"] == 10
    jl = [r["loss"] for r in want["metrics"]]
    tl = [r["loss"] for r in got["metrics"]]
    assert [r["step"] for r in got["metrics"]] == list(range(1, 11))
    assert tl[0] == pytest.approx(jl[0], rel=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]


def _mk_trainer(tmp_path, total=30, planes=0, straggle=False):
    """``tests/test_ckpt_train.py``'s ``_mk_trainer`` in the port."""
    cfg = ModelConfig(**TINY)
    m = Model(cfg, device="cpu", seed=0)
    data = loop.synthetic_data(cfg, batch=4, seq=16, seed=1, device="cpu")
    if straggle:
        import time
        base = data

        def data(step, _base=base):
            if step == 20:
                time.sleep(1.0)  # injected host-side straggle
            return _base(step)
    return loop.Trainer(m, adamw.AdamWConfig(lr=1e-3, warmup_steps=5,
                                             total_steps=total),
                        loop.TrainerConfig(total_steps=total, ckpt_every=10,
                                           ckpt_dir=str(tmp_path), log_every=5,
                                           grad_compress_planes=planes), data)


def test_trainer_loss_decreases(tmp_path):
    res = _mk_trainer(tmp_path / "a", total=40).run()
    losses = [m["loss"] for m in res["metrics"]]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("planes", [0, 8])
def test_crash_restart_resumes_exactly(tmp_path, planes):
    d = tmp_path / "b"
    with pytest.raises(RuntimeError, match="injected crash"):
        _mk_trainer(d, total=30, planes=planes).run(crash_at=20)
    res = _mk_trainer(d, total=30, planes=planes).run()
    assert res["final_step"] == 30
    res2 = _mk_trainer(tmp_path / "c", total=30, planes=planes).run()
    for key in ("params", "ef"):
        for a, b in zip(tree_leaves(res[key]), tree_leaves(res2[key])):
            assert torch.equal(a, b)
    for a, b in zip(res["opt_state"], res2["opt_state"]):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y)


def test_straggler_detection(tmp_path):
    res = _mk_trainer(tmp_path / "d", total=30, straggle=True).run()
    assert res["straggler_events"] >= 1


def test_grad_compression_converges(tmp_path):
    base = _mk_trainer(tmp_path / "e", total=40).run()
    comp = _mk_trainer(tmp_path / "f", total=40, planes=8).run()
    lb = base["metrics"][-1]["loss"]
    lc = comp["metrics"][-1]["loss"]
    assert lc < base["metrics"][0]["loss"]           # it learns
    assert abs(lc - lb) / lb < 0.25                  # and tracks the baseline


# -------------------------------------------------------------------- cli --

def test_train_cli_on_the_cpu(tmp_path, capsys):
    res = train_cli.main(["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
                          "--steps", "4", "--batch", "2", "--seq", "16",
                          "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                          "--grad-compress-planes", "8"])
    assert res["final_step"] == 4
    assert (tmp_path / "step_00000002" / "manifest.json").exists()
    assert (tmp_path / "step_00000004" / "manifest.json").exists()
    assert "step     4" in capsys.readouterr().out
    assert all(np.isfinite(m["loss"]) for m in res["metrics"])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.synthetic_data(smoke_config("qwen2-7b"), 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "qwen2-7b", "--smoke", "--steps", "1"])
