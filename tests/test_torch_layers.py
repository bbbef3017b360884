"""The port's configs, parameter trees, layers, MoE and SSM mixers vs the JAX
reference, on the CPU (``repro_torch.configs`` and ``repro_torch.models``).

Inputs are made with numpy from a seed and given to both packages, the
reference's parameters carried across with ``params_from_reference``; the
port runs on the CPU.  Tolerances, float32 compute: ``max|a - b| <= 1e-5 x
max|a|`` for the layers and mixers (XLA's and torch's CPU kernels round
their sums in different orders; a layer lands within a few float32 ulps).
Without tolerance: config values, parameter counts, abstract parameter and
cache trees, ``kv_quantize``'s int8 codes and bfloat16 scales, MoE routing
(experts, ranks, capacity drops) and the dispatch buffer.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import base as jcfg  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

torch.set_num_threads(1)

ARCHS = cfgs.list_archs()
TOL = 1e-5


def _t(x):
    """numpy / jax -> CPU tensor (bfloat16 through its bits)."""
    return P._leaf_tensor(np.asarray(x))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def _close(a, b, tol=TOL):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err, top = np.abs(a - b).max(), np.abs(a).max()
    assert err <= tol * top, (err, top)


def _params(abstract_fn, cfg, seed=0):
    """The reference's init of an abstract tree, as numpy, and the port's
    tree of the same values."""
    tree = JP.tree_init(abstract_fn(cfg), jax.random.PRNGKey(seed),
                        cfg.param_dtype)
    ref = jax.tree.map(np.asarray, tree)
    return tree, P.params_from_reference(ref, "cpu")


def _cfg(**kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab_size=64,
                compute_dtype="float32")
    base.update(kw)
    return (jcfg.ModelConfig(**_ref_kw(base)), cfgs.ModelConfig(**base))


def _ref_kw(kw):
    """The port's sub-config dataclasses -> the reference's."""
    out = dict(kw)
    for k, cls in (("moe", jcfg.MoEConfig), ("mla", jcfg.MLAConfig),
                   ("ssm", jcfg.SSMConfig)):
        if out.get(k) is not None:
            out[k] = cls(**dataclasses.asdict(out[k]))
    return out


def _rng(seed=0):
    return np.random.default_rng(seed)


# ----------------------------------------------------------------- configs --

@pytest.mark.parametrize("arch", ARCHS + ["hpmdr-field"])
def test_configs_equal_the_reference(arch):
    for mine, ref in ((cfgs.get_config(arch), jcfg.get_config(arch)),
                      (cfgs.smoke_config(arch), jcfg.smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.head_dim == ref.head_dim


def test_registry_shapes_and_skip_rules_equal_the_reference():
    assert cfgs.list_archs() == jcfg.list_archs()
    assert list(cfgs.ARCH_REGISTRY) == list(jcfg.ARCH_REGISTRY)
    assert {k: dataclasses.asdict(v) for k, v in cfgs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}
    assert dataclasses.asdict(cfgs.RunConfig()) == \
        dataclasses.asdict(jcfg.RunConfig())
    for arch in ARCHS:
        for s, js in zip(cfgs.SHAPES.values(), jcfg.SHAPES.values()):
            assert cfgs.cell_supported(cfgs.get_config(arch), s) == \
                jcfg.cell_supported(jcfg.get_config(arch), js)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_reference(arch):
    for get in ("get_config", "smoke_config"):
        mine, ref = getattr(cfgs, get)(arch), getattr(jcfg, get)(arch)
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()


def _flat_pspecs(tree):
    return {jax.tree_util.keystr(p): (v.shape, v.axes, v.init, v.scale,
                                      v.dtype)
            for p, v in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=JP.is_pspec)[0]}


def _flat_port(tree, fn):
    out = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + f"['{k}']")
            else:
                out[path + f"['{k}']"] = fn(v)
    walk(tree, "")
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_of_full_configs_equal_the_reference(arch):
    """Every full CONFIG's parameter tree (names, shapes, axes, init) and
    decode-cache tree (shapes, dtypes, bf16 and int8), without
    allocating: the port's cache tree is ``meta`` tensors."""
    cfg, jc = cfgs.get_config(arch), jcfg.get_config(arch)
    mine = _flat_port(M.model_abstract(cfg), lambda v: (
        v.shape, v.axes, v.init, v.scale, v.dtype))
    assert mine == _flat_pspecs(JM.model_abstract(jc))
    variants = [(cfg, jc)]
    if cfg.mla is None and cfg.ssm is None:
        variants.append((dataclasses.replace(cfg, kv_cache_int8_scale=8.0),
                         dataclasses.replace(jc, kv_cache_int8_scale=8.0)))
    for c, j in variants:
        if c.encoder_only:
            continue
        got = _flat_port(T.stack_cache_abstract(c, 4, 288), lambda v: (
            tuple(v.shape), str(v.dtype).split(".")[-1], v.device.type))
        want = {jax.tree_util.keystr(p): (v.shape, str(v.dtype), "meta")
                for p, v in jax.tree_util.tree_flatten_with_path(
                    JT.stack_cache_abstract(j, 4, 288))[0]}
        assert got == want


# ------------------------------------------------------------ params tree --

def test_tree_init_fan_in_rule_dtypes_and_pieces(monkeypatch):
    """normal x scale/sqrt(fan_in) (fan-in = dim 0 of a matrix, the size of
    a vector), zeros and ones, each leaf's dtype; drawing in pieces gives
    the values of one draw."""
    tree = {"m": P.PSpec((400, 300), (None, None)),
            "v": P.PSpec((5000,), (None,), scale=2.0),
            "z": P.PSpec((7, 3), (None, None), init="zeros"),
            "o": P.PSpec((9,), (None,), init="ones", dtype="float32"),
            "b": P.PSpec((64, 1000), (None, None))}
    out = P.tree_init(tree, torch.Generator().manual_seed(3), "bfloat16",
                      "cpu")
    assert out["m"].dtype == out["b"].dtype == out["z"].dtype == \
        torch.bfloat16 and out["o"].dtype == torch.float32
    assert float(out["m"].float().std()) == pytest.approx(1 / 20, rel=0.02)
    assert float(out["v"].float().std()) == pytest.approx(2 / 5000 ** 0.5,
                                                          rel=0.05)
    assert float(out["b"].float().std()) == pytest.approx(1 / 8, rel=0.02)
    assert not out["z"].float().any() and bool((out["o"] == 1).all())
    monkeypatch.setattr(P, "INIT_PIECE", 4096)
    again = P.tree_init(tree, torch.Generator().manual_seed(3), "bfloat16",
                        "cpu")
    for k in tree:
        assert torch.equal(out[k], again[k]), k


def test_params_from_reference_keeps_names_shapes_and_bits():
    """bfloat16 leaves arrive as ml_dtypes bfloat16 or as uint16 views."""
    cfg, jc = cfgs.smoke_config("qwen2-7b"), jcfg.smoke_config("qwen2-7b")
    jc = dataclasses.replace(jc, param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JM.Model(jc).init(jax.random.PRNGKey(0)))
    for view in (False, True):
        src = jax.tree.map(lambda a: a.view(np.uint16) if view else a, tree)
        got = P.params_from_reference(src, "cpu")
        flat = _flat_port(got, lambda v: v)
        for path, want in jax.tree_util.tree_flatten_with_path(tree)[0]:
            t = flat[jax.tree_util.keystr(path)]
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == want.shape
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  want.view(np.int16))
    m = M.Model(cfg, P.params_from_reference(tree, "cpu"), device="cpu")
    assert len(m.state_dict()) == len(jax.tree.leaves(tree))
    assert tuple(m.state_dict()["blocks.dense.sub0_attn.attn.wq"].shape) == \
        (2, 112, 7, 16)


# ------------------------------------------------------------------ layers --

def test_norms_and_rope_match_the_reference():
    r = _rng(1)
    x = r.normal(size=(2, 5, 3, 32)).astype(np.float32) * 3
    w = r.normal(size=(32,)).astype(np.float32)
    for kind in ("rmsnorm", "layernorm"):
        _close(JL.norm(jnp.asarray(x), jnp.asarray(w), kind),
               L.norm(_t(x), _t(w), kind))
    pos = np.arange(5)[None].repeat(2, 0) + np.array([[0], [700]])
    for theta in (1e4, 1e6):
        _close(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
               L.apply_rope(_t(x), _t(pos), theta))
    for dh in (8, 16, 64, 128, 192):
        for theta in (1e4, 5e5, 1e6, 7.5e7):
            want = JL.rope_freqs(dh, theta)
            np.testing.assert_array_equal(L.rope_freqs(dh, theta), want)
            np.testing.assert_array_equal(
                L._rope_freqs_on(dh, theta, "cpu").numpy(),
                want.astype(np.float32))


ATTN_CASES = [
    # b, sq, skv, h, hkv, dh, causal, window, q_offset, q_chunk, kv_chunk
    (2, 37, 37, 4, 2, 16, True, 0, 0, 8, 16),     # chunk edges, GQA g=2
    (1, 37, 37, 4, 1, 16, True, 5, 0, 8, 8),      # SWA inside chunks, MQA
    (2, 23, 41, 4, 4, 8, False, 0, 0, 16, 16),    # bidirectional / cross
    (1, 9, 30, 6, 2, 16, True, 0, 21, 4, 7),      # chunked prefill offset
    (1, 33, 33, 2, 2, 16, True, 12, 0, 1024, 1024),  # one block, SWA
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_matches_the_reference(case):
    b, sq, skv, h, hkv, dh, causal, window, off, qc, kc = case
    r = _rng(2)
    q = r.normal(size=(b, sq, h, dh)).astype(np.float32)
    k = r.normal(size=(b, skv, hkv, dh)).astype(np.float32)
    v = r.normal(size=(b, skv, hkv, dh + 4)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=off, q_chunk=qc,
              kv_chunk=kc)
    _close(JL.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), **kw),
           L.flash_attention(_t(q), _t(k), _t(v), **kw))


@pytest.mark.parametrize("int8", [False, True])
def test_decode_attention_matches_the_reference(int8):
    r = _rng(3)
    q = r.normal(size=(2, 1, 6, 16)).astype(np.float32)
    kc = r.normal(size=(2, 45, 3, 16)).astype(np.float32)
    vc = r.normal(size=(2, 45, 3, 16)).astype(np.float32)
    for clen, window, chunk in ((45, 0, 2048), (30, 0, 8), (30, 7, 8),
                                (1, 0, 16)):
        jk, jv, tk, tv = (jnp.asarray(kc), jnp.asarray(vc), _t(kc), _t(vc))
        js = ts = None
        if int8:
            (jk, jks), (jv, jvs) = JL.kv_quantize(jk), JL.kv_quantize(jv)
            (tk, tks), (tv, tvs) = L.kv_quantize(tk), L.kv_quantize(tv)
            js, ts = (jks, jvs), (tks, tvs)
        _close(JL.decode_attention(jnp.asarray(q), jk, jv, jnp.int32(clen),
                                   window=window, kv_chunk=chunk,
                                   kv_scales=js),
               L.decode_attention(_t(q), tk, tv, clen, window=window,
                                  kv_chunk=chunk, kv_scales=ts))


def _gqa_case(window, int8, L_cache, index, seed=4):
    jc, cfg = _cfg(attn_window=window, qkv_bias=True,
                   kv_cache_int8_scale=8.0 if int8 else 0.0)
    jp, tp = _params(JL.gqa_abstract, cfg, seed)
    jp = jax.tree.map(lambda a: a + 0.1, jp)   # non-zero biases
    tp = P.tree_map(lambda a: a + 0.1, tp)
    r = _rng(seed)
    # a prefill of L_cache tokens, then one decode token at ``index``
    x = r.normal(size=(2, L_cache, 64)).astype(np.float32)
    xn = r.normal(size=(2, 1, 64)).astype(np.float32)
    pos = np.arange(L_cache)[None].repeat(2, 0)
    ya, ca = JL.gqa_apply(jp, jnp.asarray(x), jc, jnp.asarray(pos))
    yb, cb = L.gqa_apply(tp, _t(x), cfg, _t(pos))
    _close(ya, yb)
    # int8 codes of K/V that differ by float32 ulps may differ by one step
    code_tol = {"k": 1 / 127, "v": 1 / 127} if int8 else {}
    for key in ca:
        _close(ca[key], cb[key], code_tol.get(key, TOL))
    pn = np.full((2, 1), index)
    ya, ca = JL.gqa_apply(jp, jnp.asarray(xn), jc, jnp.asarray(pn),
                          cache=ca, cache_index=jnp.int32(index))
    yb, cb2 = L.gqa_apply(tp, _t(xn), cfg, _t(pn), cache=cb,
                          cache_index=index)
    assert cb2 is cb
    _close(ya, yb)
    for key in ca:
        _close(ca[key], cb[key], code_tol.get(key, TOL))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("branch", ["rolling", "window", "full"])
def test_gqa_decode_cache_branches_match_the_reference(branch, int8):
    """The rolling window cache (L <= window, the slot wraps), the plain
    window over a longer cache, and the full cache, bf16-free int8 or not."""
    window, L_cache, index = {"rolling": (16, 12, 15),
                              "window": (6, 20, 17),
                              "full": (0, 20, 13)}[branch]
    _gqa_case(window, int8, L_cache, index)


def test_seq_shard_decode_raises_not_silently_another_branch():
    """Without a mesh, seq_shard_decode raises (the reference cannot run it
    either) and leaves the cache as it was."""
    _, cfg = _cfg(seq_shard_decode=True)
    tp = P.tree_init(L.gqa_abstract(cfg), torch.Generator().manual_seed(0),
                     "float32", "cpu")
    x = torch.zeros(1, 1, 64)
    cache = {"k": torch.zeros(1, 8, 2, 16), "v": torch.zeros(1, 8, 2, 16)}
    with pytest.raises(RuntimeError, match="'model' axis of the current mesh"):
        L.gqa_apply(tp, x, cfg, torch.zeros(1, 1, dtype=torch.long),
                    cache=cache, cache_index=3)
    assert not cache["k"].any() and not cache["v"].any()


@pytest.mark.parametrize("case", ["gqa_past_end", "gqa_negative",
                                  "gqa_window_past_end", "mla_past_end"])
def test_cache_index_outside_the_cache_raises_index_error(case):
    """A decode index outside the cache raises ``IndexError`` and leaves
    the cache as it was (the reference's ``dynamic_update_slice`` would
    clamp it and overwrite the last slot, a difference by design)."""
    L_cache = 8
    if case.startswith("mla"):
        mla = cfgs.MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                             qk_rope_dim=8, v_head_dim=16)
        _, cfg = _cfg(mla=mla, n_kv_heads=4)
        p = P.tree_init(L.mla_abstract(cfg), torch.Generator().manual_seed(0),
                        "float32", "cpu")
        cache = {"ckv": torch.zeros(1, L_cache, 16),
                 "kr": torch.zeros(1, L_cache, 8)}
        fn, index = L.mla_apply, L_cache
    else:
        # a window shorter than the cache is not the rolling cache: the
        # index is not taken modulo the cache
        _, cfg = _cfg(attn_window=4 if "window" in case else 0)
        p = P.tree_init(L.gqa_abstract(cfg), torch.Generator().manual_seed(0),
                        "float32", "cpu")
        cache = {"k": torch.zeros(1, L_cache, 2, 16),
                 "v": torch.zeros(1, L_cache, 2, 16)}
        fn, index = L.gqa_apply, -1 if case == "gqa_negative" else L_cache
    x = torch.ones(1, 1, 64)
    with pytest.raises(IndexError, match=f"cache index {index} outside a "
                                         f"cache of {L_cache}"):
        fn(p, x, cfg, torch.full((1, 1), index), cache=cache,
           cache_index=index)
    assert not any(t.any() for t in cache.values())


def test_mla_prefill_and_absorbed_decode_match_the_reference():
    mla = cfgs.MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                         qk_rope_dim=8, v_head_dim=16)
    jc, cfg = _cfg(mla=mla, n_kv_heads=4)
    jp, tp = _params(JL.mla_abstract, cfg, 5)
    r = _rng(5)
    x = r.normal(size=(2, 11, 64)).astype(np.float32)
    pos = np.arange(11)[None].repeat(2, 0)
    ya, ca = JL.mla_apply(jp, jnp.asarray(x[:, :10]), jc,
                          jnp.asarray(pos[:, :10]))
    yb, cb = L.mla_apply(tp, _t(x[:, :10]), cfg, _t(pos[:, :10]))
    _close(ya, yb)
    for key in ca:
        _close(ca[key], cb[key])
    pad = lambda c, f: {k: f(v) for k, v in c.items()}  # noqa: E731
    ca = pad(ca, lambda a: jnp.pad(a, ((0, 0), (0, 3), (0, 0))))
    cb = pad(cb, lambda a: torch.cat([a, a.new_zeros(2, 3, a.shape[-1])], 1))
    ya, ca = JL.mla_apply(jp, jnp.asarray(x[:, 10:]), jc,
                          jnp.asarray(pos[:, 10:]), cache=ca,
                          cache_index=jnp.int32(10))
    yb, cb = L.mla_apply(tp, _t(x[:, 10:]), cfg, _t(pos[:, 10:]), cache=cb,
                         cache_index=10)
    _close(ya, yb)
    for key in ca:
        _close(ca[key], cb[key])


def test_mlp_matches_the_reference():
    jc, cfg = _cfg()
    jp, tp = _params(JL.mlp_abstract, cfg, 6)
    x = _rng(6).normal(size=(2, 7, 64)).astype(np.float32)
    _close(JL.mlp_apply(jp, jnp.asarray(x), jc), L.mlp_apply(tp, _t(x), cfg))


def test_kv_quantize_codes_and_scales_bit_identical():
    """Codes and bfloat16 scales equal the reference's bit for bit: wide
    magnitudes, exact halves of a code step, signed zeros, all-zero and
    subnormal head vectors, and subnormal entries beside normal ones."""
    r = _rng(7)
    x = (r.normal(size=(3, 9, 4, 16))
         * np.exp2(r.integers(-30, 30, (3, 9, 4, 1)))).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 0, 1] = -0.0
    x[0, 1, 0] = 2.0 ** -140 * r.normal(size=16)          # all subnormal
    x[0, 1, 1, :8] = 2.0 ** -135                          # subnormal beside
    x[0, 1, 1, 8:] = 1.5e-38
    x[0, 2, 0] = (np.arange(16) - 8) / 16.0 * (1.0 / 127)  # code-step halves
    x[0, 2, 0, 0] = 1.0
    xb = x.astype(jnp.bfloat16)
    for arr in (x, np.asarray(xb)):
        qa, sa = JL.kv_quantize(jnp.asarray(arr))
        qb, sb = L.kv_quantize(_t(arr))
        assert qb.dtype == torch.int8 and sb.dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(qa), qb.numpy())
        np.testing.assert_array_equal(np.asarray(sa).view(np.uint16),
                                      sb.view(torch.int16).numpy()
                                      .view(np.uint16))
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            da = np.asarray(JL.kv_dequantize(qa, sa, jdt), np.float32)
            db = L.kv_dequantize(qb, sb, dt).float().numpy()
            np.testing.assert_array_equal(da, db)


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-v2-236b", "rwkv6-3b",
                                  "jamba-v0.1-52b"])
def test_one_block_in_bfloat16_within_a_bfloat16_step(arch):
    """One block of each family under bfloat16 compute (float32
    parameters, cast on read): every bfloat16 op rounds as XLA's does, so
    the block's output stays within ``2**-6 x max|y|`` of the reference's
    (a float32 ulp of XLA's exp/sin/tanh can flip one bfloat16 rounding)."""
    jc = dataclasses.replace(jcfg.smoke_config(arch), compute_dtype="bfloat16")
    cfg = dataclasses.replace(cfgs.smoke_config(arch),
                              compute_dtype="bfloat16")
    g = T.stack_plan(cfg)[-1]
    kind = g.kinds[-1]
    jp, tp = _params(lambda c: JT.block_abstract(c, kind), cfg, 11)
    x = _rng(11).normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    pos = np.arange(9)[None].repeat(2, 0)
    ya, _, auxa = JT.block_apply(jp, xb, jc, kind, jnp.asarray(pos))
    yb, _, auxb = T.block_apply(tp, _t(np.asarray(xb)), cfg, kind, _t(pos))
    assert yb.dtype == torch.bfloat16
    _close(ya, yb, 2 ** -6)
    assert float(auxb) == pytest.approx(float(auxa), rel=1e-5, abs=1e-9)


# --------------------------------------------------------------------- MoE --

def _moe_cfg(**moe_kw):
    kw = dict(n_experts=8, top_k=2, d_expert=32, n_shared=1)
    kw.update(moe_kw)
    return _cfg(family="moe", moe=cfgs.MoEConfig(**kw))


@pytest.mark.parametrize("cap_factor", [8.0, 1.0, 0.25])
def test_moe_routing_drops_and_dispatch_match_the_reference(cap_factor):
    """Experts, weights and aux of the routing, each assignment's rank in
    its expert, the capacity drops and the dispatch equal the reference's;
    with capacity for all, the dispatch equals both packages' oracle."""
    jc, cfg = _moe_cfg(capacity_factor=cap_factor)
    jp, tp = _params(JMOE.moe_abstract, cfg, 8)
    x = _rng(8).normal(size=(2, 32, 64)).astype(np.float32)
    xs = x.reshape(-1, 64)
    wa, ea, auxa = JMOE._routing(jp, jnp.asarray(xs), jc.moe)
    wb, eb, auxb = MOE._routing(tp, _t(xs), cfg.moe)
    np.testing.assert_array_equal(np.asarray(ea), eb.numpy())
    _close(wa, wb)
    assert float(auxb) == pytest.approx(float(auxa), rel=1e-6)
    e_flat = np.asarray(ea).reshape(-1)
    ra = np.asarray(JMOE._rank_in_expert(jnp.asarray(e_flat), e_flat.size))
    rb = MOE._rank_in_expert(_t(e_flat).long(), e_flat.size).numpy()
    np.testing.assert_array_equal(ra, rb)
    cap = MOE._capacity(64, cfg.moe)
    assert cap == JMOE._capacity(64, jc.moe)
    if cap_factor >= 8:
        assert not (rb >= cap).any()
    elif cap_factor < 1:
        assert (rb >= cap).any()
    oa, auxa2 = JMOE.moe_apply(jp, jnp.asarray(x), jc)
    ob, auxb2 = MOE.moe_apply(tp, _t(x), cfg)
    _close(oa, ob)
    assert float(auxb2) == pytest.approx(float(auxa2), rel=1e-6)
    if cap_factor >= 8:
        _close(JMOE.moe_reference(jp, jnp.asarray(x), jc),
               MOE.moe_reference(tp, _t(x), cfg))
        _close(MOE.moe_reference(tp, _t(x), cfg), ob)


def test_moe_ties_resolve_to_the_lower_expert_as_top_k_does():
    """A zero router makes every expert tie: ``lax.top_k`` takes experts 0
    and 1 for every token, and so does the port; the capacity then drops
    the same (later) tokens."""
    jc, cfg = _moe_cfg(capacity_factor=0.5)
    jp, tp = _params(JMOE.moe_abstract, cfg, 9)
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    x = _rng(9).normal(size=(1, 40, 64)).astype(np.float32)
    _, ea, _ = JMOE._routing(jp, jnp.asarray(x[0]), jc.moe)
    _, eb, _ = MOE._routing(tp, _t(x[0]), cfg.moe)
    np.testing.assert_array_equal(np.asarray(ea), eb.numpy())
    assert (eb.numpy() == [0, 1]).all()
    _close(JMOE.moe_apply(jp, jnp.asarray(x), jc)[0],
           MOE.moe_apply(tp, _t(x), cfg)[0])


# --------------------------------------------------------------------- SSM --

def _ssm_cfg(kind):
    return _cfg(family="ssm", d_model=128, d_ff=256,
                ssm=cfgs.SSMConfig(kind=kind, d_state=8, expand=2,
                                   dt_rank=8))


@pytest.mark.parametrize("kind", ["rwkv6", "rwkv6_cmix", "mamba"])
def test_ssm_mixers_match_the_reference_and_their_step_form(kind):
    """Prefill (the scan) and a step-by-step decode from its state match
    the reference; the port's step form reproduces its scan."""
    jc, cfg = _ssm_cfg("mamba" if kind == "mamba" else "rwkv6")
    fns = {"rwkv6": (JSSM.rwkv_time_mix_abstract, JSSM.rwkv_time_mix_apply,
                     SSM.rwkv_time_mix_apply),
           "rwkv6_cmix": (JSSM.rwkv_channel_mix_abstract,
                          JSSM.rwkv_channel_mix_apply,
                          SSM.rwkv_channel_mix_apply),
           "mamba": (JSSM.mamba_abstract, JSSM.mamba_apply,
                     SSM.mamba_apply)}[kind]
    jp, tp = _params(fns[0], cfg, 10)
    # non-zero mixing and decay offsets (their init is zeros)
    r = _rng(10)
    for name in ("mu_x", "mu", "ddlerp_b", "w0", "decay_b", "u", "mu_k",
                 "mu_r", "dt_bias", "conv_b"):
        if name in jp:
            noise = (0.3 * r.normal(size=jp[name].shape)).astype(np.float32)
            jp[name] = jp[name] + noise
            tp[name] = tp[name] + _t(noise)
    x = (r.normal(size=(2, 10, 128)) * 0.5).astype(np.float32)
    ya, sa = fns[1](jp, jnp.asarray(x[:, :7]), jc)
    yb, sb = fns[2](tp, _t(x[:, :7]), cfg)
    _close(ya, yb)
    steps = []
    for t in range(7, 10):
        ya, sa = fns[1](jp, jnp.asarray(x[:, t:t + 1]), jc, state=sa)
        yb, sb = fns[2](tp, _t(x[:, t:t + 1]), cfg, state=sb)
        _close(ya, yb)
        steps.append(yb)
    for key in sa:
        jl, tl = sa[key], sb[key]
        for a, b in ((jl, tl),) if not isinstance(jl, dict) else \
                ((jl[k], tl[k]) for k in jl):
            _close(a, b)
    full, _ = fns[2](tp, _t(x), cfg)
    first, st = fns[2](tp, _t(x[:, :7]), cfg)
    _close(full[:, 7:], torch.cat(steps, 1), 1e-5)
    _close(full[:, :7], first)
