"""Sharded parameter and AdamW-state storage inside the port's steps
(``distributed/fsdp.py``; ``make_train_step``, ``make_prefill_step`` and
``make_decode_step`` with ``shardings=``) on the CPU: gloo worlds of 2 and
4 ranks (``tests/_torch_dist_worker.py``), and the JAX reference run once
per script in a subprocess with host devices and Auto mesh axes.

What is held, and to what:
* placement: for every arch at SMOKE on (2, 2) and (4, 1), each rank's
  block of every parameter and AdamW ``m``/``v`` leaf (``shard_tree`` of
  ``train_shardings``) is the block that the reference's
  ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives the device
  at the same mesh coordinates; the bytes a rank stores are each leaf's
  bytes over the product of its spec's axis sizes;
* the train step at two ranks, for a dense arch (deepseek-67b), the MoE
  (deepseek-v2-236b) with both dispatches and an SSM (rwkv6-3b): loss,
  gradient blocks, new parameter blocks, ``m`` and ``v`` bit-identical to
  ``local_shard`` of the whole-tree step under the same mesh.  Each of
  ``fsdp``'s gradient rules runs: (a) reduce-scatter ('data' or 'model'
  cutting the leaf and the batch), (b) the own block ('data' trimmed from
  the batch axes), (b') the block computed on ('model' not cutting the
  batch, as for a TP-friendly arch: ``distributed/tp.py``), (c)
  all-reduce (the norms, which no axis cuts).  A sum of two terms rounds
  alike in any order, so nothing separates them, but the cases on the
  tensor-parallel path ('model' of two ranks outside the batch axes):
  their row-parallel matmuls and vocabulary-parallel loss sum the terms
  in another order.  They run twice: with the parameters and the compute
  in float64 (``fsdp_train``'s ``float64``) every block within 1e-5 x
  each leaf's largest value, and in float32 within ``TP_TOL`` (1e-3;
  ``tests/test_torch_tp.py`` says why), the loss within 1e-6 relative;
* at four ranks on (2, 2): gradient blocks within 1e-5 x each leaf's
  largest value of the whole-tree step's (on the tensor-parallel path in
  float64, and in float32 within ``TP_TOL`` beside it), the loss within 1e-6 relative (the
  reduce-scatter and the all-reduce sum four terms in orders of their
  own); the gathered gradients within ``REF_GRAD_TOL`` (2e-3, as
  ``tests/test_torch_distributed_train.py``) of the reference's jitted
  step;
* two microbatches (the gradient accumulated as blocks: the sum over ranks
  comes before the sum over microbatches, so within the 1e-5 above) and
  clipping (every case's gradient norm is above ``clip_norm``; the norm of
  the blocks within 1e-6 relative of the norm of the same step's
  gradient gathered whole, and of the whole tree's, on the
  tensor-parallel path in float64);
* ``WIRE``: the parameter gathers of a step are the ring model's count,
  one gather per cut leaf (over every axis but 'model' on the
  tensor-parallel path), per repeat for a stacked leaf, twice under
  remat (the recompute gathers again), and the gradient reduce-scatters
  one per gathered leaf; under remat no whole stacked leaf is saved for
  the backward;
* serving from blocks at two and four ranks (with and without
  ``drop_fsdp``, and the seq-sharded decode): greedy tokens equal to the
  same steps on the whole tree, under the same mesh, and logits
  bit-identical where 'model' has one rank (the gathered weights are the
  whole tree's bits), within 1e-5 x max|logit| where it has two (the
  tensor-parallel path);
* ``ckpt.manager.save`` under a mesh: leaf i is written before leaf i+1 is
  gathered, and the files equal a save without a mesh byte for byte.

This file adds 43 tests and removes none.
"""
import math
import os
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.configs.base import smoke_config as jsmoke  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs.base import list_archs, smoke_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models.model import Model, model_abstract  # noqa: E402
from repro_torch.models.params import (params_from_reference,  # noqa: E402
                                       tree_leaves, tree_partition_specs)

from _torch_dist_worker import run_world  # noqa: E402
from conftest import run_devices  # noqa: E402
from test_torch_distributed_train import REFERENCE  # noqa: E402
from test_torch_tp import TP_TOL  # noqa: E402

torch.set_num_threads(1)

ARCHS = list_archs()
PLACE_MESHES = ((2, 2), (4, 1))
BATCH, SEQ = 8, 16
GRAD_TOL = 1e-5        # x each leaf's largest: four ranks against the whole
REF_GRAD_TOL = 2e-3    # x each leaf's largest: tests/test_torch_train_grads
CLIP = 1.0             # _torch_dist_worker.fsdp_train's AdamW clip_norm
DA, DM = ("data", "model"), ("data",)
# (case, arch, dispatch, mesh, batch axes, n_micro)
TWO = [("dense_fsdp", "deepseek-67b", None, (2, 1), DA, 1),
       ("dense_tp", "deepseek-67b", None, (1, 2), DM, 1),
       ("dense_dp_trimmed", "deepseek-67b", None, (2, 1), (), 1),
       ("moe", "deepseek-v2-236b", None, (1, 2), DA, 1),
       ("moe_shard_map", "deepseek-v2-236b", "shard_map", (1, 2), DA, 1),
       ("moe_shard_map_tp", "deepseek-v2-236b", "shard_map", (1, 2), DM, 1),
       ("ssm", "rwkv6-3b", None, (2, 1), DA, 1)]
MICRO = ("dense_micro2", "deepseek-67b", None, (2, 1), DA, 2)
FOUR = [("dense", "deepseek-67b", None, (2, 2), DA, 1),
        ("dense_tp", "deepseek-67b", None, (2, 2), DM, 1),
        ("moe_shard_map", "deepseek-v2-236b", "shard_map", (2, 2), DA, 1),
        ("ssm", "rwkv6-3b", None, (2, 2), DA, 1)]
TRAIN_ARCHS = sorted({c[1] for c in TWO + FOUR})
# (case, world, mesh, drop_fsdp, seq_shard)
SERVE = [("fsdp", 2, (2, 1), False, False), ("tp", 2, (1, 2), True, False),
         ("seq_shard", 2, (1, 2), False, True),
         ("fsdp", 4, (2, 2), False, False), ("tp", 4, (2, 2), True, False),
         ("seq_shard", 4, (2, 2), False, True)]
SERVE_ARCH, SERVE_PROMPT, SERVE_NEW = "qwen2-7b", 6, 4


def _on_tp(mesh, axes):
    """Whether a step on ``mesh`` with the batch over ``axes`` computes
    over 'model' (of more than one rank) on the blocks."""
    return mesh[1] > 1 and "model" not in axes

PLACEMENT = r"""
import math, sys
import numpy as np
import jax
from jax.sharding import NamedSharding
from repro.configs.base import list_archs, smoke_config
from repro.distributed import sharding as shd
from repro.launch.policy import CellPolicy
from repro.models.model import Model
from repro.optim import adamw
from repro.train import step as steps

OUT, MESHES = sys.argv[1], eval(sys.argv[2])
res = {}
for shape in MESHES:
    devs = np.array(jax.devices()[:4]).reshape(shape)
    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
    mesh = jax.sharding.Mesh(devs, ("data", "model"), **kw)
    for arch in list_archs():
        model = Model(smoke_config(arch))
        with shd.use_mesh(mesh):
            psh, osh = steps.train_shardings(
                model, CellPolicy(("data",), 1, "float32", 16), mesh,
                adamw.AdamWConfig())
        structs = jax.tree.leaves(model.shape_structs())
        for tag, tree in (("param", psh), ("m", osh.m), ("v", osh.v)):
            flat = jax.tree_util.tree_flatten_with_path(tree)[0]
            for (path, sh), st in zip(flat, structs):
                name = ".".join(str(q.key) for q in path)
                whole = np.arange(math.prod(st.shape)).reshape(st.shape)
                idx = sh.devices_indices_map(st.shape)
                rows = []
                for d in devs.reshape(-1):    # rank order: row-major
                    b = whole[idx[d]]
                    rows.append([b.reshape(-1)[0], b.sum()] + list(b.shape))
                res[f"{shape}.{arch}.{tag}.{name}"] = np.array(rows)
np.savez(OUT + "/placement.npz", **res)
print("PLACEMENT_OK")
"""


def _duck(shape):
    names = ("data", "model")
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    rng = np.random.default_rng(0)
    inp = {}
    for arch in TRAIN_ARCHS:
        v = smoke_config(arch).vocab_size
        for k in ("tokens", "labels"):
            inp[f"{arch}.{k}"] = rng.integers(0, v, (BATCH, SEQ)
                                              ).astype(np.int32)
    np.savez(tmp / "inputs.npz", **inp)
    ref_cases = [(c, a, d, ax, nm) for c, a, d, _, ax, nm in FOUR]
    ref_script = REFERENCE.replace("sys.argv[1]", repr(str(tmp))).replace(
        "sys.argv[2]", repr(repr((ref_cases, sorted({c[1] for c in FOUR}),
                                  (2, 2), BATCH, SEQ))))
    place_script = PLACEMENT.replace("sys.argv[1]", repr(str(tmp))).replace(
        "sys.argv[2]", repr(repr(PLACE_MESHES)))
    params = {a: params_from_reference(jax.tree.map(
        np.asarray, JModel(jsmoke(a)).init(jax.random.PRNGKey(0))), "cpu")
        for a in TRAIN_ARCHS}
    batches = {a: {k: torch.from_numpy(inp[f"{a}.{k}"])
                   for k in ("tokens", "labels")} for a in TRAIN_ARCHS}

    def train(case, gathered=False, float64=False):
        _, arch, dispatch, mesh, axes, n_micro = case
        return ("fsdp_train", mesh, dict(
            arch=arch, params=params[arch], batch=batches[arch],
            batch_axes=axes, n_micro=n_micro, dispatch=dispatch,
            gathered=gathered, float64=float64))
    serve_params = Model(smoke_config(SERVE_ARCH), device="cpu",
                         seed=3).params
    prompts = torch.from_numpy(rng.integers(
        0, smoke_config(SERVE_ARCH).vocab_size, (2, SERVE_PROMPT)
    ).astype(np.int32))

    def serve(world):
        return [("fsdp_serve", mesh, dict(
            arch=SERVE_ARCH, params=serve_params, prompts=prompts,
            n_new=SERVE_NEW, drop_fsdp=drop, seq_shard=seq))
            for _, w, mesh, drop, seq in SERVE if w == world]
    ckpt_params = Model(smoke_config("qwen2-7b"), device="cpu",
                        seed=0).params
    jobs2 = ([train(c) for c in TWO + [MICRO]] + serve(2)
             + [("fsdp_ckpt_order", (2, 1), dict(params=ckpt_params,
                                                 root=str(tmp / "ckpt")))])
    jobs4 = ([("fsdp_placement", m, {"arch": a}) for m in PLACE_MESHES
              for a in ARCHS] + [train(c, True) for c in FOUR] + serve(4))
    # the cases on the tensor-parallel path again in float64, at the end
    ckpt_job = len(jobs2) - 1
    f64 = {}
    for world, cases, jobs in ((2, TWO, jobs2), (4, FOUR, jobs4)):
        for c in cases:
            if _on_tp(c[3], c[4]):
                f64[(world, c[0])] = len(jobs)
                jobs.append(train(c, float64=True))
    with ThreadPoolExecutor(4) as ex:
        ref = ex.submit(run_devices, ref_script, 8)
        place = ex.submit(run_devices, place_script, 4)
        two = ex.submit(run_world, 2, jobs2, tmp)
        four = ex.submit(run_world, 4, jobs4, tmp)
        assert "REFERENCE_OK" in ref.result()
        assert "PLACEMENT_OK" in place.result()
        two, four = two.result(), four.result()
    n_place = len(PLACE_MESHES) * len(ARCHS)
    n_two = len(TWO) + 1
    return {"two": two, "four": four, "n_two": n_two, "n_place": n_place,
            "f64": f64, "ckpt_job": ckpt_job,
            "ref": dict(np.load(tmp / "reference.npz")),
            "place": dict(np.load(tmp / "placement.npz")),
            "ckpt": tmp / "ckpt"}


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _within(a, b, tol):
    """max|a - b| <= tol x max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() <= tol * np.abs(b).max()


def _leaf_keys(res, tag):
    return sorted(k[len(tag) + 1:] for k in res if k.startswith(tag + "."))


# -------------------------------------------------------------- placement --

@pytest.mark.parametrize("mesh", PLACE_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_are_the_reference_named_sharding_blocks(runs, arch, mesh):
    i = PLACE_MESHES.index(mesh) * len(ARCHS) + ARCHS.index(arch)
    place = runs["place"]
    for rank, res in enumerate(r[i] for r in runs["four"]):
        for tag in ("param", "m", "v"):
            names = _leaf_keys(res, tag)
            want = sorted(k.split(f"{tag}.", 1)[1] for k in place
                          if k.startswith(f"{mesh}.{arch}.{tag}."))
            assert names == want
            for name in names:
                got = res[f"{tag}.{name}"].numpy()
                ref = place[f"{mesh}.{arch}.{tag}.{name}"][rank]
                assert got.tolist() == ref.tolist(), (rank, tag, name)
        stored, want = (int(v) for v in res["stored"])
        assert stored == want


# ------------------------------------------------------------- the step --

def _two(runs, case):
    i = [c[0] for c in TWO + [MICRO]].index(case)
    return [r[i] for r in runs["two"]]


def _four(runs, case):
    i = runs["n_place"] + [c[0] for c in FOUR].index(case)
    return [r[i] for r in runs["four"]]


def _float64(runs, case, world):
    """The float64 run of a case on the tensor-parallel path."""
    i = runs["f64"][(world, case)]
    return [r[i] for r in runs["two" if world == 2 else "four"]]


@pytest.mark.parametrize("case", [c[0] for c in TWO])
def test_two_ranks_bit_identical_to_the_whole_tree_step(runs, case):
    """Bit for bit, but on the tensor-parallel path: within 1e-5 in
    float64 and within ``TP_TOL`` in float32."""
    _, _, _, mesh, axes, _ = [c for c in TWO if c[0] == case][0]
    tp = _on_tp(mesh, axes)
    runs_tols = [(_two(runs, case), TP_TOL if tp else 0)]
    if tp:
        runs_tols.append((_float64(runs, case, 2), GRAD_TOL))
    for results, tol in runs_tols:
        for res in results:
            if tol:
                lw, ls = (float(x) for x in res["loss"])
                assert abs(ls - lw) <= 1e-6 * abs(lw)
            else:
                assert torch.equal(_bits(res["loss"][0]),
                                   _bits(res["loss"][1]))
            for tag in ("grad", "param", "m", "v"):
                names = _leaf_keys(res, tag)
                assert names and names == _leaf_keys(res, f"whole_{tag}")
                for name in names:
                    a, b = res[f"{tag}.{name}"], res[f"whole_{tag}.{name}"]
                    assert a.shape == b.shape and a.dtype == b.dtype, name
                    if tol:
                        assert _within(a.numpy(), b.numpy(), tol), \
                            (tag, name)
                    else:
                        assert torch.equal(_bits(a), _bits(b)), (tag, name)


def _close_to_whole(res, tol=GRAD_TOL):
    lw, ls = (float(x) for x in res["loss"])
    assert abs(ls - lw) <= 1e-6 * abs(lw)
    for name in _leaf_keys(res, "grad"):
        a, b = res[f"grad.{name}"], res[f"whole_grad.{name}"]
        assert a.shape == b.shape
        assert _within(a.numpy(), b.numpy(), tol), name


def test_two_microbatches_accumulate_blocks(runs):
    for res in _two(runs, MICRO[0]):
        _close_to_whole(res)


@pytest.mark.parametrize("case", [c[0] for c in FOUR])
def test_four_ranks_within_rounding_and_the_reference(runs, case):
    ref = runs["ref"]
    want = {k[len(case) + 6:]: v for k, v in ref.items()
            if k.startswith(f"{case}.grad.")}
    results = _four(runs, case)
    _, _, _, mesh, axes, _ = [c for c in FOUR if c[0] == case][0]
    if _on_tp(mesh, axes):
        for res in _float64(runs, case, 4):
            _close_to_whole(res)
    for res in results:
        _close_to_whole(res, TP_TOL if _on_tp(mesh, axes) else GRAD_TOL)
        got = {k[9:]: v for k, v in res.items() if k.startswith("gathered.")}
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            assert _within(got[name].numpy(), w, REF_GRAD_TOL), name
        loss = float(ref[f"{case}.loss"])
        assert abs(float(res["loss"][1]) - loss) <= 1e-6 * abs(loss)


def test_global_norm_of_blocks_counts_each_element_once(runs):
    """Every case clips (its gradient norm is above ``clip_norm``), and the
    norm from the blocks is the norm of the same gradient gathered whole
    within 1e-6 relative, and the whole tree's: on the tensor-parallel
    path in float64 (in float32 the gradient itself is the whole tree's
    within ``TP_TOL`` there)."""
    for case in TWO + [MICRO] + FOUR:
        two = case in TWO + [MICRO]
        tp = _on_tp(case[3], case[4])
        results = [(r, not tp) for r in (_two(runs, case[0]) if two
                                          else _four(runs, case[0]))]
        if tp:
            results += [(r, True) for r in _float64(runs, case[0],
                                                     2 if two else 4)]
        for res, to_whole in results:
            whole, blocks = (float(x) for x in res["grad_norm"])
            own = float(res["own_norm"])
            assert whole > CLIP, case
            assert abs(blocks - own) <= 1e-6 * own, case
            if to_whole:
                assert abs(blocks - whole) <= 1e-6 * whole, case


def _gather_bytes(shape, spec, mesh, keep=()):
    """(all-gathers, bytes on the wire) of ``gather_shard`` of a float32
    block of the whole ``shape`` under ``spec``, by the ring model, over
    every axis but ``keep``."""
    block = list(shape)
    cuts = []
    for d, e in enumerate(spec):
        axes = (e,) if isinstance(e, str) else tuple(e or ())
        block[d] //= math.prod(mesh.shape[a] for a in axes)
        cuts.append((d, math.prod(mesh.shape[a] for a in axes
                                  if a not in keep)))
    calls = nbytes = 0
    for d, n in reversed(cuts):
        if n == 1:
            continue
        out = n * 4 * math.prod(block)
        calls, nbytes = calls + 1, nbytes + out * (n - 1) // n
        block[d] *= n
    return calls, nbytes


def _ring_counts(arch, mesh_shape, tp=False):
    """The ring model's (gathers, gather bytes, reduce-scatters) of one
    step of ``arch`` at SMOKE under remat: each cut top-level leaf gathered
    once, each cut stacked leaf once per repeat in the forward and once in
    the recompute; a reduce-scatter per gather of a leaf cut over a batch
    axis.  ``tp``: the step computes over 'model' on the blocks, which are
    gathered over their other axes only (no arch here has Mamba's
    leaves, which stay gathered)."""
    cfg = smoke_config(arch)
    assert cfg.remat and not cfg.tie_embeddings and not cfg.mtp_depth
    mesh = _duck(mesh_shape)
    structs = model_abstract(cfg)
    shd.set_current_mesh(mesh)
    try:
        specs = tree_partition_specs(structs)
    finally:
        shd.set_current_mesh(None)
    calls = nbytes = scatters = 0
    for key in structs:
        sub_specs, sub = specs[key], structs[key]
        keep = ("model",) if tp else ()
        for ps, spec in zip(tree_leaves(sub), tree_leaves(sub_specs)):
            if key == "blocks":
                c, b = _gather_bytes(ps.shape[1:], spec[1:], mesh, keep)
                reps = 2 * ps.shape[0]
            else:
                c, b = _gather_bytes(ps.shape, spec, mesh, keep)
                reps = 1
            calls, nbytes = calls + reps * c, nbytes + reps * b
            if c:
                scatters += reps // (2 if key == "blocks" else 1)
    return calls, nbytes, scatters


@pytest.mark.parametrize("case", ["dense_fsdp", "dense_tp"])
def test_param_gathers_follow_the_ring_model(runs, case):
    """deepseek-67b: every cut leaf is gathered (each stacked one per
    repeat, again in the recompute); with 'data' cutting both leaf and
    batch each gathered leaf's gradient is reduce-scattered; with 'model'
    cutting the leaf alone it is not gathered over 'model' at all (the
    layers compute on the block), so on (1, 2) nothing is gathered."""
    _, _, _, mesh, axes, _ = [c for c in TWO if c[0] == case][0]
    calls, nbytes, scatters = _ring_counts("deepseek-67b", mesh,
                                           _on_tp(mesh, axes))
    for res in _two(runs, case):
        wire = dict(zip(res["wire_keys"], res["wire"].tolist()))
        assert (wire["param_gather"], wire["param_gather_bytes"]) == \
            (calls, nbytes)
        assert wire["grad_reduce_scatter"] == (scatters if case ==
                                               "dense_fsdp" else 0)
        assert wire["all_gather"] == wire["reduce_scatter"] == 0


def test_no_whole_stacked_leaf_is_saved_under_remat(runs):
    """The tensors autograd saves outside the checkpointed repeats (their
    shapes with leading ones dropped, as a batched matmul views them): none
    has the shape of a whole repeat of a cut stacked leaf, while the head,
    read outside the stack, is saved whole."""
    cfg = smoke_config("deepseek-67b")
    structs = model_abstract(cfg)
    blocks = [tuple(ps.shape[1:]) for ps in tree_leaves(structs["blocks"])
              if len(ps.shape) > 2]
    for res in _two(runs, "dense_fsdp"):
        saved = set()
        for shape in res["saved_shapes"]:
            while shape and shape[0] == 1:
                shape = shape[1:]
            saved.add(tuple(shape))
        assert tuple(structs["head"].shape) in saved
        assert not saved & set(blocks)


# -------------------------------------------------------------- serving --

@pytest.mark.parametrize("i", range(len(SERVE)),
                         ids=[f"{s[0]}-{s[1]}ranks" for s in SERVE])
def test_serving_from_blocks_is_the_whole_tree(runs, i):
    _, world, mesh, drop, _ = SERVE[i]
    k = [s for s in SERVE if s[1] == world].index(SERVE[i])
    j = (runs["n_two"] if world == 2 else runs["n_place"] + len(FOUR)) + k
    results = [r[j] for r in runs["two" if world == 2 else "four"]]
    whole_bytes = sum(t.numel() * 4 for t in tree_leaves(Model(
        smoke_config(SERVE_ARCH), device="cpu", seed=3).params))
    for res in results:
        assert torch.equal(res["tokens"], res["whole_tokens"])
        if mesh[1] == 1:
            assert torch.equal(_bits(res["logits"]),
                               _bits(res["whole_logits"]))
        else:           # the tensor-parallel path: the blocks' own sums
            assert _within(res["logits"].numpy(),
                           res["whole_logits"].numpy(), GRAD_TOL)
        # gathers over 'data' alone: nothing is gathered over 'model'
        assert (int(res["gather_bytes"]) > 0) == (mesh[0] > 1 and not drop)
        assert int(res["stored"]) < whole_bytes


# ----------------------------------------------------------- checkpoint --

def test_save_under_a_mesh_gathers_and_writes_one_leaf_at_a_time(runs):
    root = runs["ckpt"]
    logs = [r[runs["ckpt_job"]] for r in runs["two"]]
    n = int(logs[0]["n_leaves"])
    assert logs[0]["log"].tolist() == [x for i in range(1, n + 1)
                                       for x in (i, -i)]
    assert logs[1]["log"].tolist() == list(range(1, n + 1))
    a = root / "mesh" / "step_00000001"
    b = root / "plain" / "step_00000001"
    files = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == files and len(files) == n + 1
    for f in files:
        if f != "manifest.json":
            assert (a / f).read_bytes() == (b / f).read_bytes(), f
    import json
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    ma.pop("time"), mb.pop("time")
    assert ma == mb
