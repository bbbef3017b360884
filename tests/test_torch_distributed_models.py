"""The port's mesh-bound model layers vs the JAX reference, on the CPU:
the seq-sharded flash decode (``seqshard_decode_gqa`` on a bfloat16 cache,
``seqshard_decode_gqa_int8`` on an int8 one, and MLA's absorbed decode) on
(1, 2) and (2, 2) meshes, and the MoE ``shard_map`` dispatch, forward and
gradients, on (1, 2), (2, 2) and (1, 4) meshes, with and without capacity
drops.

The reference runs once in a subprocess with host devices, its meshes
built with Auto axes where jax has ``AxisType``; the port's ranks are the
processes of gloo worlds of 2 and 4 (``tests/_torch_dist_worker.py``),
each rank holding its shards of the same numpy inputs.

Tolerances, and why:
* outputs within ``tests/test_torch_layers.py``'s ``_close``: max|a - b|
  <= 1e-5 x max|a| for float32 results (XLA's and torch's CPU kernels
  round their sums in different orders); a bfloat16 output within one
  bfloat16 step of its value (2**-8 relative: a float32 result an ulp
  apart can round to either neighbour);
* the updated cache shards: bit-identical (a write, no arithmetic), but
  MLA's new latent entry, which the layer computes (``_close``);
* MoE: each shard's kept and dropped assignments (expert slot and keep
  flag) equal; outputs and gradients (w1, w2, w3, router) within
  ``_close``'s 1e-5 of each leaf's largest.  Each rank's gradient is that
  of its own loss, ``sum(out * cot) + aux / n_dp``, summed over the
  data-parallel ranks: the reference's gradient of ``sum(out * cot) +
  aux``, which its shard_map gives without scaling by the model axis;
* against the same call on one device: the same tolerances, but for the
  bfloat16 cache's output, within one bfloat16 step of the largest output
  (2**-8 x max|out|): each shard rounds its probabilities to bfloat16
  against its own running maximum, one device against the global one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.params import _leaf_tensor, tree_init  # noqa: E402

from _torch_dist_worker import run_world  # noqa: E402
from conftest import run_devices  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
BF16_STEP = 2.0 ** -8
B, LEN, HKV, G, DH = 2, 64, 2, 2, 16
INDEXES = (5, 40)                  # one in each half of the cache
SEQ_MESHES = ((1, 2), (2, 2))
MOE_MESHES = ((1, 2), (2, 2), (1, 4))
MOE_CAPACITY = {"kept": 4.0, "dropping": 0.5}
MLA = dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
           v_head_dim=16)
MLA_CFG = dict(name="mla", family="moe", n_layers=1, d_model=64, n_heads=4,
               n_kv_heads=4, d_ff=128, vocab_size=64,
               compute_dtype="float32", decode_batch_axes=("data",))
MOE = dict(n_experts=8, top_k=2, d_expert=32, n_shared=1,
           dispatch="shard_map")
MOE_CFG = dict(name="moe", family="moe", n_layers=1, d_model=64, n_heads=4,
               n_kv_heads=4, d_ff=128, vocab_size=64,
               compute_dtype="float32")
MOE_X = (4, 16, 64)


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    h = HKV * G
    inp = {"q": f(B, 1, h, DH), "k": f(B, LEN, HKV, DH),
           "v": f(B, LEN, HKV, DH), "kn": f(B, 1, HKV, DH),
           "vn": f(B, 1, HKV, DH)}
    for name in ("k", "v"):                     # an int8 cache's codes
        inp[name + "8"] = rng.integers(-127, 128, (B, LEN, HKV)
                                       + (DH,)).astype(np.int8)
        inp[name + "s"] = (np.abs(f(B, LEN, HKV)) + 0.5)
        inp[name + "n8"] = rng.integers(-127, 128, (B, 1, HKV, DH)
                                        ).astype(np.int8)
        inp[name + "ns"] = np.abs(f(B, 1, HKV)) + 0.5
    inp["mla_x"] = f(B, 1, MLA_CFG["d_model"])
    inp["ckv"] = f(B, LEN, MLA["kv_lora_rank"])
    inp["kr"] = f(B, LEN, MLA["qk_rope_dim"])
    inp["moe_x"] = f(*MOE_X)
    inp["moe_cot"] = f(*MOE_X)
    return inp


REFERENCE = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.base import MLAConfig, ModelConfig, MoEConfig
from repro.distributed import sharding as shd
from repro.models import layers as L
from repro.models import moe as M
from repro.models.params import tree_init

OUT = sys.argv[1]
CFG = eval(sys.argv[2])
inp = dict(np.load(OUT + "/inputs.npz"))
bf = lambda a: jnp.asarray(a, jnp.bfloat16)

def mesh_of(shape):
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
    return jax.sharding.Mesh(devs, ("data", "model"), **kw)

def bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a

res = {}
mla_cfg = ModelConfig(**dict(CFG["mla_cfg"], mla=MLAConfig(**CFG["mla"]),
                             seq_shard_decode=True))
mla_p = jax.tree.map(np.asarray, tree_init(L.mla_abstract(mla_cfg),
                                           jax.random.PRNGKey(1), "float32"))
for k, v in mla_p.items():
    res[f"mla_param.{k}"] = v
for shape in CFG["seq_meshes"]:
    mesh = mesh_of(shape)
    tag = "x".join(map(str, shape))
    with shd.use_mesh(mesh):
        for idx in CFG["indexes"]:
            out, kc, vc = jax.jit(lambda q, k, v, kn, vn, i: L.seqshard_decode_gqa(
                q, k, v, kn, vn, i, ("data",)))(
                bf(inp["q"]), bf(inp["k"]), bf(inp["v"]), bf(inp["kn"]),
                bf(inp["vn"]), jnp.int32(idx))
            for n, a in (("out", out), ("k", kc), ("v", vc)):
                res[f"bf16_{tag}_{idx}_{n}"] = bits(a)
            outs = jax.jit(lambda *a: L.seqshard_decode_gqa_int8(
                *a, ("data",)))(
                jnp.asarray(inp["q"]), inp["k8"], inp["v8"], bf(inp["ks"]),
                bf(inp["vs"]), inp["kn8"], inp["vn8"], bf(inp["kns"]),
                bf(inp["vns"]), jnp.int32(idx))
            for n, a in zip(("out", "k", "v", "ks", "vs"), outs):
                res[f"int8_{tag}_{idx}_{n}"] = bits(a)
            pos = jnp.full((inp["mla_x"].shape[0], 1), idx, jnp.int32)
            y, cache = jax.jit(lambda p, x, c, i: L.mla_apply(
                p, x, mla_cfg, pos, cache=c, cache_index=i))(
                mla_p, inp["mla_x"], {"ckv": inp["ckv"], "kr": inp["kr"]},
                jnp.int32(idx))
            res[f"mla_{tag}_{idx}_y"] = np.asarray(y)
            res[f"mla_{tag}_{idx}_ckv"] = np.asarray(cache["ckv"])
            res[f"mla_{tag}_{idx}_kr"] = np.asarray(cache["kr"])

for cname, cf in CFG["capacity"].items():
    moe = MoEConfig(**dict(CFG["moe"], capacity_factor=cf))
    cfg = ModelConfig(**dict(CFG["moe_cfg"], moe=moe))
    p = tree_init(M.moe_abstract(cfg), jax.random.PRNGKey(2), "float32")
    for k, v in jax.tree_util.tree_flatten_with_path(p)[0]:
        res[f"moe_param.{cname}." + ".".join(str(q.key) for q in k)] = \
            np.asarray(v)
    x, cot = jnp.asarray(inp["moe_x"]), jnp.asarray(inp["moe_cot"])
    xs = x.reshape(-1, x.shape[-1])
    top_w, top_e, _ = M._routing(p, xs, moe)
    for shape in CFG["moe_meshes"]:
        mesh = mesh_of(shape)
        tag = f"{cname}_" + "x".join(map(str, shape))
        n_dp, tp = shape
        def f(p):
            out, aux = M.moe_apply(p, x, cfg)
            return jnp.sum(out * cot) + aux, (out, aux)
        with shd.use_mesh(mesh):
            (_, (out, aux)), g = jax.jit(jax.value_and_grad(
                f, has_aux=True))(p)
        res[f"moe_{tag}_out"] = np.asarray(out)
        res[f"moe_{tag}_aux"] = np.asarray(aux)
        for k in ("w1", "w2", "w3", "router"):
            res[f"moe_{tag}_grad.{k}"] = np.asarray(g[k])
        # each (data, model) shard's assignments, as the body forms them
        t_l = xs.shape[0] // n_dp
        e_local = moe.n_experts // tp
        cap_l = M._capacity(t_l, moe)
        for d in range(n_dp):
            e_flat = top_e[d * t_l:(d + 1) * t_l].reshape(-1)
            pos = M._rank_in_expert(e_flat, t_l * moe.top_k)
            for m in range(tp):
                lo = m * e_local
                local = (pos < cap_l) & (e_flat >= lo) & (e_flat < lo + e_local)
                slot = jnp.where(local, (e_flat - lo) * cap_l + pos,
                                 e_local * cap_l)
                res[f"moe_{tag}_{d}_{m}_kept"] = np.asarray(local)
                res[f"moe_{tag}_{d}_{m}_slot"] = np.asarray(slot)
np.savez(OUT + "/reference.npz", **res)
print("REFERENCE_OK")
"""


def _tree(flat, prefix):
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            node = out
            parts = k[len(prefix):].split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = _leaf_tensor(v)
    return out


def _rank_block(a, shape, rank, spec):
    """Rank ``rank``'s block of the whole numpy array ``a`` on a ('data',
    'model') mesh of ``shape`` under ``spec`` (entries None, 'data',
    'model')."""
    coord = dict(zip(("data", "model"), np.unravel_index(rank, shape)))
    size = dict(zip(("data", "model"), shape))
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        n = a.shape[d] // size[ax]
        a = np.take(a, range(coord[ax] * n, (coord[ax] + 1) * n), axis=d)
    return a


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distm")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    cfg = {"mla": MLA, "mla_cfg": MLA_CFG, "moe": MOE, "moe_cfg": MOE_CFG,
           "seq_meshes": SEQ_MESHES, "moe_meshes": MOE_MESHES,
           "indexes": INDEXES, "capacity": MOE_CAPACITY}
    script = REFERENCE.replace("sys.argv[1]", repr(str(tmp))).replace(
        "sys.argv[2]", repr(repr(cfg)))
    assert "REFERENCE_OK" in run_devices(script, n_devices=8)
    ref = dict(np.load(tmp / "reference.npz"))
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    bf = lambda a: a.to(torch.bfloat16)  # noqa: E731
    mla_p = _tree(ref, "mla_param.")
    jobs = {2: [], 4: []}
    for shape in SEQ_MESHES:
        n = shape[0] * shape[1]
        for idx in INDEXES:
            jobs[n].append(("seqshard", shape, dict(
                q=bf(t["q"]), k_cache=bf(t["k"]), v_cache=bf(t["v"]),
                k_new=bf(t["kn"]), v_new=bf(t["vn"]), index=idx,
                batch_axes=("data",))))
            jobs[n].append(("seqshard", shape, dict(
                q=t["q"], k_cache=t["k8"], v_cache=t["v8"],
                k_new=t["kn8"], v_new=t["vn8"], index=idx,
                batch_axes=("data",), ks_cache=bf(t["ks"]),
                vs_cache=bf(t["vs"]), ks_new=bf(t["kns"]),
                vs_new=bf(t["vns"]))))
            jobs[n].append(("mla_seqshard", shape, dict(
                params=mla_p, x=t["mla_x"], ckv=t["ckv"], kr=t["kr"],
                index=idx, cfg_kw=dict(MLA_CFG, mla=MLA))))
    for cname, cf in MOE_CAPACITY.items():
        for shape in MOE_MESHES:
            jobs[shape[0] * shape[1]].append(("moe", shape, dict(
                params=_tree(ref, f"moe_param.{cname}."), x=t["moe_x"],
                cot=t["moe_cot"], cfg_kw=dict(MOE_CFG, moe=dict(
                    MOE, capacity_factor=cf)))))
    worlds = {n: run_world(n, j, tmp) for n, j in jobs.items()}
    # each world's results by job, keyed as the jobs were listed
    return {"ref": ref, "inp": inp, "jobs": jobs, "worlds": worlds}


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err, top = np.abs(a - b).max(), np.abs(a).max()
    assert err <= tol * top, (err, top)


def _within_bf16_step(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.all(np.abs(a - b) <= BF16_STEP * np.abs(a) + 1e-30), \
        np.abs(a - b).max()


def _results(runs, name, shape):
    n = shape[0] * shape[1]
    idx = [i for i, (nm, sh, _) in enumerate(runs["jobs"][n])
           if nm == name and tuple(sh) == shape]
    return [[rank[i] for i in idx] for rank in runs["worlds"][n]]


def _bf16(a):
    return torch.from_numpy(np.asarray(a).view(np.int16)).view(
        torch.bfloat16)


@pytest.mark.parametrize("shape", SEQ_MESHES)
def test_seqshard_decode_bf16_cache_against_the_reference(runs, shape):
    ref, tag = runs["ref"], "x".join(map(str, shape))
    cspec, qspec = ("data", "model", None, None), ("data", None, None, None)
    for rank, res in enumerate(_results(runs, "seqshard", shape)):
        for j, idx in enumerate(INDEXES):
            got = res[2 * j]
            key = f"bf16_{tag}_{idx}_"
            want = _bf16(_rank_block(ref[key + "out"], shape, rank, qspec))
            _within_bf16_step(_np(want), _np(got["out"]))
            _close(_np(got["one_device"]), _np(got["out"]), BF16_STEP)
            for c in ("k", "v"):
                want = _rank_block(ref[key + c], shape, rank, cspec)
                np.testing.assert_array_equal(
                    got[c].view(torch.int16).numpy(), want.view(np.int16))


@pytest.mark.parametrize("shape", SEQ_MESHES)
def test_seqshard_decode_int8_cache_against_the_reference(runs, shape):
    ref, tag = runs["ref"], "x".join(map(str, shape))
    cspec, qspec = ("data", "model", None, None), ("data", None, None, None)
    for rank, res in enumerate(_results(runs, "seqshard", shape)):
        for j, idx in enumerate(INDEXES):
            got = res[2 * j + 1]
            key = f"int8_{tag}_{idx}_"
            _close(_rank_block(ref[key + "out"], shape, rank, qspec),
                   got["out"].numpy())
            _close(got["one_device"].numpy(), got["out"].numpy())
            for c, spec in (("k", cspec), ("v", cspec), ("ks", cspec[:3]),
                            ("vs", cspec[:3])):
                want = _rank_block(ref[key + c], shape, rank, spec)
                if got[c].dtype == torch.bfloat16:
                    got_c, want = got[c].view(torch.int16).numpy(), \
                        want.view(np.int16)
                else:
                    got_c = got[c].numpy()
                np.testing.assert_array_equal(got_c, want)


@pytest.mark.parametrize("shape", SEQ_MESHES)
def test_seqshard_mla_absorbed_decode_against_the_reference(runs, shape):
    """MLA's decode is MQA over the (c_kv, k_rope) latent cache; its batch
    stays whole here (the reference's cache spec puts the batch over
    ``decode_batch_axes``, which reads the same values)."""
    ref, tag = runs["ref"], "x".join(map(str, shape))
    for rank, res in enumerate(_results(runs, "mla_seqshard", shape)):
        for j, idx in enumerate(INDEXES):
            got = res[j]
            key = f"mla_{tag}_{idx}_"
            _close(ref[key + "y"], got["y"].numpy())
            _close(got["y_one"].numpy(), got["y"].numpy())
            for c in ("ckv", "kr"):
                want = _rank_block(ref[key + c], shape, rank,
                                   (None, "model", None))
                old = _rank_block(runs["inp"][c], shape, rank,
                                  (None, "model", None))
                written = np.any(want != old, axis=(0, 2))
                assert written.sum() <= 1   # only position idx, if here
                np.testing.assert_array_equal(got[c].numpy()[:, ~written],
                                              want[:, ~written])
                if written.any():
                    _close(want[:, written], got[c].numpy()[:, written])
            np.testing.assert_array_equal(got["ckv"].numpy(),
                                          got["ckv_one"].numpy())


def test_seqshard_without_a_mesh_raises_for_gqa_and_mla():
    kw = dict(MLA_CFG, mla=L.MLAConfig(**MLA), seq_shard_decode=True)
    cfg = L.ModelConfig(**kw)
    p = tree_init(L.mla_abstract(cfg), torch.Generator().manual_seed(0),
                  "float32", "cpu")
    cache = {"ckv": torch.zeros(1, 8, 16), "kr": torch.zeros(1, 8, 8)}
    with pytest.raises(RuntimeError, match="'model' axis of the current"):
        L.mla_apply(p, torch.zeros(1, 1, 64), cfg,
                    torch.zeros(1, 1, dtype=torch.long), cache=cache,
                    cache_index=3)
    with pytest.raises(RuntimeError, match="'model' axis of the current"):
        L.seqshard_decode_gqa(torch.zeros(1, 1, 2, 4),
                              torch.zeros(1, 8, 1, 4),
                              torch.zeros(1, 8, 1, 4),
                              torch.zeros(1, 1, 1, 4),
                              torch.zeros(1, 1, 1, 4), 0)


@pytest.mark.parametrize("cname", list(MOE_CAPACITY))
@pytest.mark.parametrize("shape", MOE_MESHES)
def test_moe_shard_map_dispatch_against_the_reference(runs, shape, cname):
    ref = runs["ref"]
    tag = f"moe_{cname}_" + "x".join(map(str, shape))
    results = _results(runs, "moe", shape)
    i = list(MOE_CAPACITY).index(cname)
    dropped = 0
    for rank, res in enumerate(results):
        got = res[i]
        d, m = np.unravel_index(rank, shape)
        kept = ref[f"{tag}_{d}_{m}_kept"]
        np.testing.assert_array_equal(got["kept"].numpy(), kept)
        np.testing.assert_array_equal(got["slot"].numpy(),
                                      ref[f"{tag}_{d}_{m}_slot"])
        dropped += int((~kept).sum())
        spec = ("data", None, None)
        _close(_rank_block(ref[f"{tag}_out"], shape, rank, spec),
               got["out"].numpy())
        _close(got["one_device"].numpy(), got["out"].numpy())
        _close(ref[f"{tag}_aux"], got["aux"].numpy())
        for k in ("w1", "w2", "w3", "router"):
            _close(ref[f"{tag}_grad.{k}"], got[f"grad.{k}"].numpy())
    # every assignment is kept by exactly one model rank of its shard, but
    # for those over capacity, which none keeps
    total = MOE_X[0] * MOE_X[1] * MOE["top_k"] * shape[1]
    n_not_local = total - total // shape[1]
    over = dropped - n_not_local
    assert (over > 0) == (cname == "dropping"), over
