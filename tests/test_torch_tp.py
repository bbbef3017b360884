"""Tensor-parallel compute over 'model' in the port (``distributed/tp.py``;
the layers, the vocabulary-parallel embedding, head and loss, and the
step factories with ``shardings=``) on the CPU: gloo worlds of 1, 2 and 4
ranks (``tests/_torch_dist_worker.py``) on (1, 1), (1, 2), (1, 4) and
(2, 2) ('data', 'model') meshes, and the JAX reference once, in a
subprocess with host devices and Auto mesh axes.

The smoke configs have 2-8 heads, so their attention is not cut over
'model'; the cases use variants that are, made with
``dataclasses.replace`` in both packages: deepseek-67b's smoke with 16
query and 2 kv heads (a group of 8 query heads a kv head, so that at
four ranks two ranks read one kv head, and the sum of ``wk``'s gradient
over 'model' is needed), deepseek-v2-236b's smoke with 16 heads (MLA
plus the MoE, with both dispatches), deepseek-v3-671b's with 16 heads
(the multi-token prediction loss, on blocks too), jamba's smoke (Mamba
on its blocks of ``d_inner``, ``in_proj`` re-cut by ``tp.recut``, beside
the MoE and the MLP on blocks), and rwkv6-3b's smoke
(the channel mix) with a batch of 5, which ``cell_policy`` cannot cut
over 'model', so that 'model' stays out of the batch axes and the step
computes over it.

What is held, and to what:
* each layer that changed (GQA, MLA, MLP, the MoE with both dispatches,
  RWKV's channel mix, Mamba) on blocks against the same layer on whole leaves
  under the same mesh (outputs and the gradients of ``x`` and of each
  block within 1e-5 x the largest value) and against the reference's
  layer (the output within 1e-5, the gradients within 2e-3, the bound of
  ``tests/test_torch_train_grads.py``); Mamba's row-parallel sums with
  the all-reduce of their backward taken away (``tp.summed`` as
  ``tp.leave``) fail that test, and ``tp.recut`` moves ``in_proj``'s
  blocks and their gradients bit for bit;
* the step on blocks against the whole-tree step under the same mesh: at
  one rank loss, gradients, new parameters, m and v bit for bit; at two
  and four ranks the loss within 1e-6 relative and every gradient,
  parameter, m and v block within 1e-5 x each leaf's largest value with
  the parameters and the compute in float64 (``fsdp_train``'s
  ``float64``; the norms, attention and logits stay float32, AdamW's
  state too), and beside it in float32 within ``TP_TOL`` = 1e-3; the
  norm of the blocks within 1e-6 of the norm of the same gradient
  gathered whole (and in float64 of the whole-tree step's); at four ranks
  the gathered gradients within 2e-3 of the reference's jitted step.
  Jamba's Mamba runs its scan in float32 whatever the compute dtype, so
  in float64 its gradients carry float32 rounding, which AdamW's
  per-element step (about ``lr`` whatever the gradient's size) carries
  past 1e-5 of a leaf's largest new parameter: there the new parameters
  are held at ``TP_TOL``, the gradients, m and v at 1e-5.
  Why the float32 step needs 1e-3: the row-parallel sums and the
  vocabulary-parallel loss add float32 terms in another order, and these
  smoke models carry an ulp of difference far: the whole-tree step's own
  gradients move by up to 4.6e-4 of a leaf's largest value when one ulp
  is added to the embedding
  (``test_one_ulp_of_the_embedding_moves_the_whole_tree_step``).  In
  float64 the same step holds at 1e-5, so the gap is the order of the
  sums, not a missing term, which would be off by a rank's share;
* ``wk``'s gradient: the same on every rank of 'model' and, in float64,
  within 1e-5 of the whole step's (each rank reads only its q heads' kv
  heads);
* the blocks a step returns are ``local_shard``'s blocks of the
  whole-tree step's leaves (``devices_indices_map``'s, as
  ``tests/test_torch_fsdp.py`` pins);
* jamba's steps and serving run on its smoke weights with each stacked
  leaf divided by the square root of its first per-layer dim (the fan-in
  rule of the layer's own, unstacked leaves, which the layer tests use).
  The stacked init draws those leaves with a fan-in of 1 (the repeat
  axis), so the smoke's Mamba state reaches 2e7 and its activations 1e10,
  and there one ulp of the embedding moves the whole-tree step's own
  gradients by 0.16 of a leaf's largest
  (``test_one_ulp_moves_the_stacked_jamba_smoke_past_tp_tol``): no
  reordered float32 sum, and Mamba's scan is float32 in either compute
  dtype, can be held there.  On the rescaled weights one ulp moves them by
  2.6e-5, as it moves the other variants.  Now that Mamba computes on
  its blocks, its float32 sums are reordered too, and AdamW's first step
  (``lr x g / (|g| + eps)`` of the clipped gradient, eps 1e-8) is
  steepest where ``|g|`` is near eps: there a gradient rounding far
  inside ``TP_TOL`` moves the new parameter by up to 2.8e-3 of the
  leaf's largest (one element of ``dt_bias`` or ``conv_b``, zeros before
  the step, at a rank).  So in float32 jamba's new parameters are held
  at ``TP_TOL`` except the elements whose whole-tree clipped gradient is
  nonzero and within ``FLIP_FLOOR`` = 2 x eps of 0 (1,671 of 767,232
  elements at two ranks, 1,717 of 796,032 at four; the rest within
  2.4e-4), which may be at most ``EXEMPT_SHARE`` = 1% of them; and every
  new parameter of either step, the exempt ones included, is held within
  ``TP_TOL`` of AdamW's step recomputed from that step's own m and v,
  which are held against each other at ``TP_TOL``.  In float64 jamba's
  new parameters are held at ``TP_TOL`` and by the same recomputation;
* ``WIRE``: the parameter gathers of a step are the ring model's with
  'model' left cut (none over 'model': Mamba's leaves neither), and the
  ``tp_all_reduce`` and ``tp_all_to_all`` calls and bytes the layer
  plan's (``_tp_plan``);
* serving (prefill and greedy decode, the seq-sharded decode included)
  from blocks under ``param_shardings`` against the whole tree: greedy
  tokens equal, logits bit-identical at one rank and within 1e-5 x
  max|logit| at two and four, the logits, the seq-sharded decode's
  queries and Mamba's decode state gathered under ``tp_all_gather``.
"""
import dataclasses
import math
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import base as jcfg  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.distributed import fsdp  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed import tp as TP  # noqa: E402
from repro_torch.launch.policy import cell_policy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import model_abstract  # noqa: E402
from repro_torch.models.params import (params_from_reference,  # noqa: E402
                                       tree_leaves, tree_map,
                                       tree_partition_specs)
from repro_torch.models.transformer import stack_plan  # noqa: E402

from _torch_dist_worker import run_world, unstack_fan_in  # noqa: E402
from conftest import run_devices  # noqa: E402

torch.set_num_threads(1)

SEQ = 16
GRAD_TOL = 1e-5        # x each leaf's largest: blocks against whole leaves
TP_TOL = 1e-3          # x each leaf's largest: the float32 step, see above
LOSS_TOL = 1e-6        # relative
REF_GRAD_TOL = 2e-3    # x each leaf's largest: tests/test_torch_train_grads
# variant: (arch, overrides of both packages' SMOKE, MoE dispatch, batch)
VARIANTS = {
    "dense16": ("deepseek-67b", {"n_heads": 16, "n_kv_heads": 2}, None, 8),
    "mla16": ("deepseek-v2-236b", {"n_heads": 16, "n_kv_heads": 16}, None,
              8),
    "mla16_shard_map": ("deepseek-v2-236b",
                        {"n_heads": 16, "n_kv_heads": 16}, "shard_map", 8),
    "rwkv": ("rwkv6-3b", {}, None, 5),
    "mtp16": ("deepseek-v3-671b", {"n_heads": 16, "n_kv_heads": 16}, None,
              8),
    "jamba": ("jamba-v0.1-52b", {}, None, 8),
}
# variants whose step keeps float32 inside in float64 compute (Mamba's
# scan): their new parameters are held at TP_TOL there, see the docstring
FLOAT32_INSIDE = ("jamba",)
# variants whose stacked leaves are rescaled to the unstacked fan-in rule
UNSTACKED_INIT = ("jamba",)
STEP_LR = 1e-3         # fsdp_train's AdamW: learning rate,
CLIP_NORM = 1.0        # clip norm,
ADAMW_EPS = 1e-8       # eps,
ADAMW_B = (0.9, 0.95)  # b1 and b2,
ADAMW_WD = 0.1         # and weight decay (AdamWConfig's defaults)
FLIP_FLOOR = 2 * ADAMW_EPS  # jamba's float32 step: see the docstring
EXEMPT_SHARE = 0.01    # of the leaves' elements that FLIP_FLOOR may exempt
# (case, world, mesh, variant); every batch over ('data',) alone
STEPS = [("dense16-1x1", 1, (1, 1), "dense16"),
         ("mla16-1x1", 1, (1, 1), "mla16"),
         ("dense16-1x2", 2, (1, 2), "dense16"),
         ("mla16-1x2", 2, (1, 2), "mla16"),
         ("mla16_shard_map-1x2", 2, (1, 2), "mla16_shard_map"),
         ("rwkv-1x2", 2, (1, 2), "rwkv"),
         ("mtp16-1x2", 2, (1, 2), "mtp16"),
         ("jamba-1x1", 1, (1, 1), "jamba"),
         ("jamba-1x2", 2, (1, 2), "jamba"),
         ("jamba-1x4", 4, (1, 4), "jamba"),
         ("jamba-2x2", 4, (2, 2), "jamba"),
         ("dense16-1x4", 4, (1, 4), "dense16"),
         ("mla16-1x4", 4, (1, 4), "mla16"),
         ("mla16_shard_map-1x4", 4, (1, 4), "mla16_shard_map"),
         ("rwkv-1x4", 4, (1, 4), "rwkv"),
         ("dense16-2x2", 4, (2, 2), "dense16"),
         ("mla16_shard_map-2x2", 4, (2, 2), "mla16_shard_map")]
# the cases the reference's step is held against: its mesh is (1, 4);
# jamba's gradients are held against the reference's at 5e-2 in
# tests/test_torch_train_grads.py (the float32 scan over 8 layers), not 2e-3
REF_CASES = [c for c in STEPS if c[2] == (1, 4) and c[3] != "jamba"]
# (case, world, mesh, variant, drop_fsdp, seq_shard)
SERVE = [("dense16-1x1", 1, (1, 1), "dense16", False, False),
         ("mla16-seq-1x1", 1, (1, 1), "mla16", False, True),
         ("dense16-tp-1x2", 2, (1, 2), "dense16", True, False),
         ("dense16-seq-1x2", 2, (1, 2), "dense16", False, True),
         ("mla16-tp-1x2", 2, (1, 2), "mla16", True, False),
         ("mla16-seq-1x2", 2, (1, 2), "mla16", False, True),
         ("dense16-2x2", 4, (2, 2), "dense16", False, False),
         ("dense16-seq-1x4", 4, (1, 4), "dense16", True, True),
         ("mla16-seq-1x4", 4, (1, 4), "mla16", True, True),
         ("jamba-1x1", 1, (1, 1), "jamba", False, False),
         ("jamba-tp-1x2", 2, (1, 2), "jamba", True, False),
         ("jamba-tp-1x4", 4, (1, 4), "jamba", True, False)]
SERVE_PROMPT, SERVE_NEW = 4, 4    # an 8-deep cache splits over 4
LONG = 128        # jamba's step where the scans' chunks nest in the remat
LAYERS = ("gqa", "mla", "mlp", "moe", "moe_shard_map", "cmix", "mamba")
LAYER_MESHES = ((1, 2), (1, 4))
RECUT_WIDTHS = (3, 5)     # odd channel counts a rank of in_proj's re-cut

REFERENCE = r"""
import dataclasses, sys
import numpy as np
import jax
from jax.sharding import NamedSharding
from repro.configs.base import smoke_config
from repro.distributed import sharding as shd
from repro.launch.policy import CellPolicy
from repro.models.model import Model
from repro.train import step as steps

OUT = sys.argv[1]
CASES, MESH = eval(sys.argv[2])
inp = dict(np.load(OUT + "/inputs.npz"))
devs = np.array(jax.devices()[:MESH[0] * MESH[1]]).reshape(MESH)
kw = {}
if hasattr(jax.sharding, "AxisType"):
    kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
mesh = jax.sharding.Mesh(devs, ("data", "model"), **kw)
res = {}
for case, variant, arch, over, dispatch in CASES:
    cfg = smoke_config(arch)
    if dispatch:
        over = dict(over, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    cfg = dataclasses.replace(cfg, **over)
    model = Model(cfg)
    batch = {k: inp[f"{variant}.{k}"] for k in ("tokens", "labels")}
    with shd.use_mesh(mesh):
        policy = CellPolicy(("data",), 1, "float32", batch["labels"].shape[1])
        psh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                           model.partition_specs())
        p = jax.device_put(model.init(jax.random.PRNGKey(0)), psh)
        bsh = steps.batch_shardings(batch, policy, mesh)
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(
            p, {k: jax.device_put(v, bsh[k]) for k, v in batch.items()})
    res[f"{case}.loss"] = np.asarray(loss)
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        res[f"{case}.grad." + ".".join(str(q.key) for q in path)] = \
            np.asarray(leaf)
np.savez(OUT + "/reference.npz", **res)
print("REFERENCE_OK")
"""


def _jcfg(variant):
    arch, over, dispatch, _ = VARIANTS[variant]
    cfg = jcfg.smoke_config(arch)
    if dispatch:
        over = dict(over, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    return dataclasses.replace(cfg, **over)


def _unstacked(tree):
    """A copy of ``tree`` rescaled by ``unstack_fan_in``: the init's
    fan-in rule as for an unstacked layer's leaves."""
    return unstack_fan_in(tree_map(torch.clone, tree))


def _weights(variant, tree):
    return _unstacked(tree) if variant in UNSTACKED_INIT else tree


def _port_cfg(variant):
    arch, over, dispatch, _ = VARIANTS[variant]
    cfg = cfgs.smoke_config(arch)
    if dispatch:
        over = dict(over, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    return dataclasses.replace(cfg, **over)


# ------------------------------------------------------------ the layers --

def _layer_kw(module):
    """The layer's config (fields of both packages' ``ModelConfig``)."""
    kw = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=16,
              n_kv_heads=2, d_ff=128, vocab_size=64, compute_dtype="float32")
    if module == "mla":
        kw.update(n_kv_heads=16, mla=dict(
            q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
            v_head_dim=16))
    if module == "mamba":
        kw.update(family="hybrid", ssm=dict(
            kind="mamba", d_state=8, expand=2, dt_rank=8, conv_width=4,
            attn_period=8, attn_offset=4))
    if module.startswith("moe"):
        kw.update(family="moe", moe=dict(
            n_experts=8, top_k=2, d_expert=32, n_shared=1,
            capacity_factor=4.0,
            dispatch="shard_map" if module == "moe_shard_map" else "gspmd"))
    return kw


def _ref_layer(module, kw, seed):
    """The reference layer's inputs made from ``seed`` (params as numpy,
    x, cot) and a function that returns its output, the gradient of x and
    the gradients of the leaves (compiled while the worlds run)."""
    sub = {"moe": jcfg.MoEConfig, "mla": jcfg.MLAConfig,
           "ssm": jcfg.SSMConfig}
    cfg = jcfg.ModelConfig(**{k: sub[k](**v) if k in sub else v
                              for k, v in kw.items()})
    abstract, fn = {
        "gqa": (JL.gqa_abstract, lambda p, x, pos: JL.gqa_apply(
            p, x, cfg, pos)[0]),
        "mla": (JL.mla_abstract, lambda p, x, pos: JL.mla_apply(
            p, x, cfg, pos)[0]),
        "mlp": (JL.mlp_abstract, lambda p, x, pos: JL.mlp_apply(p, x, cfg)),
        "moe": (JMOE.moe_abstract, lambda p, x, pos: JMOE.moe_apply(
            p, x, cfg)),
        "cmix": (JSSM.rwkv_channel_mix_abstract,
                 lambda p, x, pos: JSSM.rwkv_channel_mix_apply(
                     p, x, cfg)[0]),
        "mamba": (JSSM.mamba_abstract,
                  lambda p, x, pos: JSSM.mamba_apply(p, x, cfg)[0])
    }[module.replace("_shard_map", "")]
    params = JP.tree_init(abstract(cfg), jax.random.PRNGKey(seed),
                          cfg.param_dtype)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 12, 64)).astype(np.float32)
    cot = rng.normal(size=(2, 12, 64)).astype(np.float32)
    pos = jnp.asarray(np.arange(12)[None].repeat(2, 0))

    def loss(p, xx):
        y = fn(p, xx, pos)
        if isinstance(y, tuple):
            return jnp.sum(y[0] * cot) + y[1], y[0]
        return jnp.sum(y * cot), y

    def outputs():
        (_, y), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        return np.asarray(y), np.asarray(gx), jax.tree.map(np.asarray, gp)
    return jax.tree.map(np.asarray, params), x, cot, outputs


# ------------------------------------------------------------- fixture --

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    inp = {}
    for variant, (arch, _, _, b) in VARIANTS.items():
        v = cfgs.smoke_config(arch).vocab_size
        for k in ("tokens", "labels"):
            inp[f"{variant}.{k}"] = rng.integers(0, v, (b, SEQ)
                                                 ).astype(np.int32)
    np.savez(tmp / "inputs.npz", **inp)
    ref_cases = [(c, v) + VARIANTS[v][:3] for c, _, _, v in REF_CASES]
    ref_script = REFERENCE.replace("sys.argv[1]", repr(str(tmp))).replace(
        "sys.argv[2]", repr(repr((ref_cases, (1, 4)))))
    def init(v):
        return _weights(v, params_from_reference(jax.tree.map(
            np.asarray, JModel(_jcfg(v)).init(jax.random.PRNGKey(0))), "cpu"))
    with ThreadPoolExecutor(4) as ex:         # the inits compile at once
        params = dict(zip(VARIANTS, ex.map(init, VARIANTS)))
    batches = {v: {k: torch.from_numpy(inp[f"{v}.{k}"])
                   for k in ("tokens", "labels")} for v in VARIANTS}

    def train(case, float64=False):
        _, world, mesh, v = case
        arch, over, dispatch, _ = VARIANTS[v]
        return ("fsdp_train", mesh, dict(
            arch=arch, params=params[v], batch=batches[v],
            batch_axes=("data",), dispatch=dispatch, overrides=over,
            gathered=world == 4 and not float64, float64=float64))

    def serve(case):
        _, _, mesh, v, drop, seq = case
        arch, over, _, _ = VARIANTS[v]
        return ("fsdp_serve", mesh, dict(
            arch=arch, params=params[v], prompts=batches[v]["tokens"][
                :2, :SERVE_PROMPT], n_new=SERVE_NEW, drop_fsdp=drop,
            seq_shard=seq, overrides=over))
    layers = {}
    for i, module in enumerate(LAYERS):
        kw = _layer_kw(module)
        layers[module] = (kw,) + _ref_layer(module, kw, 10 + i)

    def layer(module, mesh, leave_only=False):
        kw, p, x, cot = layers[module][:4]
        return ("tp_layer", mesh, dict(
            module=module.replace("_shard_map", ""),
            params=params_from_reference(p, "cpu"), x=torch.from_numpy(x),
            cot=torch.from_numpy(cot), cfg_kw=kw, leave_only=leave_only))
    jobs = {1: [], 2: [], 4: []}
    where = {}
    for case in STEPS:
        where[("step", case[0])] = (case[1], len(jobs[case[1]]))
        jobs[case[1]].append(train(case))
        if case[1] > 1:
            where[("step64", case[0])] = (case[1], len(jobs[case[1]]))
            jobs[case[1]].append(train(case, True))
    for case in SERVE:
        where[("serve", case[0])] = (case[1], len(jobs[case[1]]))
        jobs[case[1]].append(serve(case))
    for module in LAYERS:
        for mesh in LAYER_MESHES:
            world = mesh[0] * mesh[1]
            where[("layer", module, mesh)] = (world, len(jobs[world]))
            jobs[world].append(layer(module, mesh))
    for mesh in LAYER_MESHES:
        world = mesh[0] * mesh[1]
        where[("leave_only", mesh)] = (world, len(jobs[world]))
        jobs[world].append(layer("mamba", mesh, leave_only=True))
    long_batch = {k: torch.from_numpy(rng.integers(
        0, cfgs.smoke_config("jamba-v0.1-52b").vocab_size, (2, LONG))
        .astype(np.int32)) for k in ("tokens", "labels")}
    where[("long",)] = (2, len(jobs[2]))
    jobs[2].append(("fsdp_train", (1, 2), dict(
        arch="jamba-v0.1-52b", params=params["jamba"], batch=long_batch,
        batch_axes=("data",), dispatch=None, overrides={})))
    for n in (1, 2, 4):
        for c in RECUT_WIDTHS:
            where[("recut", n, c)] = (n, len(jobs[n]))
            jobs[n].append(("tp_recut", (1, n), dict(
                w=torch.from_numpy(rng.normal(size=(7, 2 * n * c))),
                cot=torch.from_numpy(rng.normal(size=(7, 2 * n * c))))))
    with ThreadPoolExecutor(4) as ex:
        ref = ex.submit(run_devices, ref_script, 4)
        worlds = {n: ex.submit(run_world, n, jobs[n], tmp) for n in jobs}
        layers = {m: v[:4] + v[4]() for m, v in layers.items()}
        assert "REFERENCE_OK" in ref.result()
        worlds = {n: w.result() for n, w in worlds.items()}
    return {"worlds": worlds, "where": where, "layers": layers,
            "ref": dict(np.load(tmp / "reference.npz"))}


def _results(runs, *key):
    world, i = runs["where"][key]
    return [r[i] for r in runs["worlds"][world]]


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _within(a, b, tol):
    """max|a - b| <= tol x max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() <= tol * np.abs(b).max()


def _leaf_keys(res, tag):
    return sorted(k[len(tag) + 1:] for k in res if k.startswith(tag + "."))


def _wire(res):
    return dict(zip(res["wire_keys"], res["wire"].tolist()))


# ------------------------------------------------------------ the rules --

def test_drop_axes_and_kv_heads():
    assert fsdp.drop_axes((("pod", "data"), "model", None), ("model",)) == \
        (("pod", "data"), None, None)
    assert fsdp.drop_axes(("model", ("pod", "data")), ()) == \
        ("model", ("pod", "data"))
    # 8 q heads a rank of groups of 4: two whole groups; 2 of groups of 4
    # (danube's 32 heads over 16 ranks): inside one group
    assert TP.kv_heads(8, 8, 4) == slice(2, 4)
    assert TP.kv_heads(6, 2, 4) == slice(1, 2)
    with pytest.raises(ValueError, match="do not nest"):
        TP.kv_heads(0, 6, 4)


def test_heads_cut_is_the_specs_rule():
    """``heads_cut`` (which the layer reads) is the spec's own condition
    for every full-size arch."""
    for arch in cfgs.list_archs():
        cfg = cfgs.get_config(arch)
        if cfg.mla or cfg.n_layers == 0:
            continue
        axes = L.gqa_abstract(cfg)["wq"].axes
        assert (axes[1] == "tp") == L.heads_cut(cfg), arch


# ------------------------------------------------------------ the layers --

@pytest.mark.parametrize("mesh", LAYER_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("module", LAYERS)
def test_layer_on_blocks_matches_the_whole_layer(runs, module, mesh):
    """Output and gradients (of x and of each block) of the layer on this
    rank's blocks within 1e-5 of the layer on whole leaves."""
    for res in _results(runs, "layer", module, mesh):
        assert _within(res["out"], res["whole_out"], GRAD_TOL)
        assert _within(res["grad_x"], res["whole_grad_x"], GRAD_TOL)
        names = _leaf_keys(res, "grad")
        assert names == _leaf_keys(res, "whole_grad")
        for name in names:
            a, b = res[f"grad.{name}"], res[f"whole_grad.{name}"]
            assert a.shape == b.shape, name
            assert _within(a, b, GRAD_TOL), name
        assert _wire(res)["tp_all_reduce"] > 0


@pytest.mark.parametrize("module", LAYERS)
def test_layer_on_blocks_matches_the_reference(runs, module):
    """At four ranks: the output within 1e-5 and the gradients (x, and each
    leaf gathered from the ranks' blocks) within 2e-3 of the reference's
    layer on one device."""
    _, p, _, _, y, gx, gp = runs["layers"][module]
    results = _results(runs, "layer", module, (1, 4))
    for res in results:
        assert _within(res["out"], y, 1e-5)
        assert _within(res["grad_x"], gx, REF_GRAD_TOL)
    flat = dict(jax.tree_util.tree_flatten_with_path(gp)[0])
    want = {".".join(str(q.key) for q in path): v for path, v in flat.items()}
    for name, w in want.items():
        blocks = [r[f"grad.{name}"] for r in results]
        if blocks[0].shape == w.shape:
            got = blocks[0]
        else:       # cut over 'model' on one dim: the ranks' blocks in order
            d = [i for i, (a, b) in enumerate(zip(blocks[0].shape, w.shape))
                 if a != b][0]
            got = torch.cat(blocks, d)
        assert _within(got, w, REF_GRAD_TOL), name


@pytest.mark.parametrize("mesh", LAYER_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_mamba_sums_all_reduced_forward_only_fail(runs, mesh):
    """The fault the layer test must catch: with ``dt_low``, ``Bm`` and
    ``Cm`` all-reduced forward only (``tp.leave`` for ``tp.summed``), each
    rank's ``w_dt_down``, ``w_b`` and ``w_c`` gradient holds only its own
    channels' share, and misses the whole layer's by far more than 1e-5
    (the output, which needs the forward sum only, still holds)."""
    for res in _results(runs, "leave_only", mesh):
        assert _within(res["out"], res["whole_out"], GRAD_TOL)
        for name in ("w_dt_down", "w_b", "w_c"):
            assert not _within(res[f"grad.{name}"],
                               res[f"whole_grad.{name}"], GRAD_TOL), name


@pytest.mark.parametrize("c", RECUT_WIDTHS)
@pytest.mark.parametrize("n", (1, 2, 4))
def test_recut_moves_in_proj_blocks_bit_for_bit(runs, n, c):
    """``tp.recut`` of each rank's stored block of ``[x, z]`` is the
    rank's channels of ``x`` beside the same channels of ``z``, sliced
    from the whole leaf, and its backward hands the stored block the
    columns of the cotangent it holds, bit for bit; one all-to-all each
    way at the ring model's ``out x (n - 1) / n`` (0 B at one rank)."""
    for res in _results(runs, "recut", n, c):
        assert torch.equal(res["got"], res["want"])
        assert torch.equal(res["grad"], res["want_grad"])
        out = res["got"].numel() * res["got"].element_size()
        wire = _wire(res)
        assert wire["tp_all_to_all"] == 2
        assert wire["tp_all_to_all_bytes"] == 2 * (out * (n - 1) // n)


# -------------------------------------------------------------- the step --

@pytest.mark.parametrize("case", [c[0] for c in STEPS if c[1] == 1])
def test_one_rank_bit_identical_to_the_whole_tree_step(runs, case):
    (res,) = _results(runs, "step", case)
    assert torch.equal(_bits(res["loss"][0]), _bits(res["loss"][1]))
    for tag in ("grad", "param", "m", "v"):
        names = _leaf_keys(res, tag)
        assert names and names == _leaf_keys(res, f"whole_{tag}")
        for name in names:
            a, b = res[f"{tag}.{name}"], res[f"whole_{tag}.{name}"]
            assert torch.equal(_bits(a), _bits(b)), (tag, name)


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("case", [c[0] for c in STEPS if c[1] > 1])
def test_step_on_blocks_within_rounding_of_the_whole_tree_step(
        runs, case, precision):
    """In float64 within 1e-5 x each leaf's largest (``GRAD_TOL``),
    in float32 within ``TP_TOL``; the loss within 1e-6 relative; jamba's
    new parameters at ``TP_TOL``, in float32 but for the elements whose
    clipped gradient is within ``FLIP_FLOOR`` of 0 (at most
    ``EXEMPT_SHARE`` of them), and on each side within ``TP_TOL`` of
    AdamW's step from that side's own m and v (the module docstring)."""
    f64 = precision == "float64"
    variant = [c for c in STEPS if c[0] == case][0][3]
    for res in _results(runs, "step64" if f64 else "step", case):
        exempt = total = 0
        scale = min(1.0, CLIP_NORM / float(res["grad_norm"][0]))
        lw, ls = (float(x) for x in res["loss"])
        assert abs(ls - lw) <= LOSS_TOL * abs(lw)
        for tag in ("grad", "param", "m", "v"):
            names = _leaf_keys(res, tag)
            assert names and names == _leaf_keys(res, f"whole_{tag}")
            for name in names:
                a, b = res[f"{tag}.{name}"], res[f"whole_{tag}.{name}"]
                # the block devices_indices_map gives: local_shard's
                assert a.shape == b.shape and a.dtype == b.dtype, name
                inside = tag == "param" and variant in FLOAT32_INSIDE
                if inside:
                    for side, q in (("", a), ("whole_", b)):
                        assert _within(q, _adamw_first_step(res, side, name),
                                       TP_TOL), (side, name)
                if inside and not f64:
                    g = res[f"whole_grad.{name}"].double() * scale
                    flip = (g != 0) & (g.abs() <= FLIP_FLOOR)
                    exempt, total = exempt + int(flip.sum()), total + g.numel()
                    a, b = a.double(), b.double()
                    assert float((a - b).abs()[~flip].max()) \
                        <= TP_TOL * float(b.abs().max()), (tag, name)
                    continue
                tol = GRAD_TOL if f64 and not inside else TP_TOL
                assert _within(a, b, tol), (tag, name)
        assert exempt <= EXEMPT_SHARE * total, (exempt, total)
        own, blocks = float(res["own_norm"]), float(res["grad_norm"][1])
        assert abs(blocks - own) <= LOSS_TOL * own
        if f64:
            whole = float(res["grad_norm"][0])
            assert abs(blocks - whole) <= LOSS_TOL * whole


def _adamw_first_step(res, side, name):
    """The new parameter block AdamW's first step gives from the start
    block and ``side``'s own m and v ("" the step on blocks, "whole_" the
    whole-tree step's), in float64."""
    p0 = res[f"start.{name}"].double()
    m, v = (res[f"{side}{t}.{name}"].double() for t in ("m", "v"))
    m_hat, v_hat = m / (1 - ADAMW_B[0]), v / (1 - ADAMW_B[1])
    return p0 - STEP_LR * (ADAMW_WD * p0
                           + m_hat / (torch.sqrt(v_hat) + ADAMW_EPS))


def _ulp_spread(variant, unstacked):
    """The largest change, relative to each leaf's largest value, of the
    whole-tree step's gradients on one device when one ulp is added to
    every embedding weight (the variant's weights, or with ``unstacked``
    the rescaled ones)."""
    from repro_torch.models.model import Model
    from repro_torch.train.step import value_and_grad
    model = Model(_port_cfg(variant), device="cpu", seed=0)
    params = _unstacked(model.params) if unstacked else model.params
    rng = np.random.default_rng(0)
    v = model.cfg.vocab_size
    batch = {k: torch.from_numpy(rng.integers(0, v, (8, SEQ)).astype(
        np.int32)) for k in ("tokens", "labels")}
    nudged = dict(params)
    nudged["embed"] = torch.nextafter(nudged["embed"],
                                      torch.full_like(nudged["embed"], 1e9))
    grads = [tree_leaves(value_and_grad(lambda p: model.loss(p, batch),
                                        tree)[1])
             for tree in (params, nudged)]
    return max(float((a.double() - b.double()).abs().max()
                     / b.double().abs().max()) for a, b in zip(*grads))


@pytest.mark.parametrize("variant", ["dense16", "mla16", "jamba"])
def test_one_ulp_of_the_embedding_moves_the_whole_tree_step(variant):
    """The measure behind ``TP_TOL``: the whole-tree step's gradients on
    one device (on the weights the step tests use), and again with one
    ulp added to every embedding weight, differ by more than the 1e-5
    that holds each layer alone, and by less than half ``TP_TOL``."""
    spread = _ulp_spread(variant, variant in UNSTACKED_INIT)
    assert GRAD_TOL < spread < TP_TOL / 2, spread


def test_one_ulp_moves_the_stacked_jamba_smoke_past_tp_tol():
    """Why jamba's step tests rescale its weights: on the smoke's stacked
    init one ulp of the embedding moves the whole-tree step's own
    gradients by more than ``TP_TOL``."""
    assert _ulp_spread("jamba", False) > TP_TOL


@pytest.mark.parametrize("case", [c[0] for c in REF_CASES])
def test_step_on_blocks_within_the_reference(runs, case):
    ref = runs["ref"]
    want = {k[len(case) + 6:]: v for k, v in ref.items()
            if k.startswith(f"{case}.grad.")}
    for res in _results(runs, "step", case):
        got = {k[9:]: v for k, v in res.items() if k.startswith("gathered.")}
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            assert _within(got[name].numpy(), w, REF_GRAD_TOL), name
        loss = float(ref[f"{case}.loss"])
        assert abs(float(res["loss"][1]) - loss) <= LOSS_TOL * abs(loss)


@pytest.mark.parametrize("case", ["dense16-1x2", "dense16-1x4",
                                  "dense16-2x2"])
def test_wk_gradient_is_summed_over_model(runs, case):
    """Each rank reads only the kv heads of its q heads; ``wk``'s and
    ``wv``'s gradients are the same on every rank of 'model' and the
    whole-tree step's within 1e-5 in float64 (at four ranks on (1, 4) two
    ranks share a kv head: without the sum each would hold its own
    part)."""
    n_model = [c for c in STEPS if c[0] == case][0][2][1]
    for leaf in ("blocks.dense.sub0_attn.attn.wk",
                 "blocks.dense.sub0_attn.attn.wv"):
        for res in _results(runs, "step64", case):
            assert _within(res[f"grad.{leaf}"], res[f"whole_grad.{leaf}"],
                           GRAD_TOL)
        results = _results(runs, "step", case)
        by_data = {}
        for r, res in enumerate(results):
            by_data.setdefault(r // n_model, []).append(res[f"grad.{leaf}"])
        for grads in by_data.values():
            assert all(torch.equal(g, grads[0]) for g in grads)


# ----------------------------------------------------- WIRE, ring model --

def _duck(shape):
    names = ("data", "model")
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)))


def _ring_gathers(cfg, mesh_shape):
    """The ring model's (param gathers, bytes) of one remat step of
    ``cfg`` on blocks, 'model' kept cut but for RWKV's time-mix leaves,
    which that layer gathers over 'model' itself (``tp.whole``; Mamba
    computes on its blocks): a top-level leaf once, a stacked one per
    repeat in the forward and again in the recompute."""
    mesh = _duck(mesh_shape)
    structs = model_abstract(cfg)
    shd.set_current_mesh(mesh)
    try:
        specs = tree_partition_specs(structs)
    finally:
        shd.set_current_mesh(None)

    def walk(tree, spec, stacked, path=()):
        if isinstance(tree, dict):
            for k in tree:
                yield from walk(tree[k], spec[k], stacked, path + (k,))
            return
        sp = spec[1:] if stacked else spec
        kept = () if "tmix" in path else ("model",)
        shape = tree.shape[1:] if stacked else tree.shape
        yield sp, kept, shape, (2 * tree.shape[0] if stacked else 1)
    calls = nbytes = 0
    for key in structs:
        for sp, kept, shape, reps in walk(structs[key], specs[key],
                                          key == "blocks"):
            block = list(shape)
            cuts = []
            for d, e in enumerate(sp):
                axes = (e,) if isinstance(e, str) else tuple(e or ())
                block[d] //= math.prod(mesh.shape[a] for a in axes)
                cuts.append((d, math.prod(mesh.shape[a] for a in axes
                                          if a not in kept)))
            for d, n in reversed(cuts):
                if n > 1:
                    out = n * 4 * math.prod(block)
                    calls += reps
                    nbytes += reps * (out * (n - 1) // n)
                    block[d] *= n
    return calls, nbytes


def _tp_plan(cfg, b, s, n, dp):
    """The layer plan's ``tp_all_reduce`` and ``tp_all_to_all`` (calls,
    bytes) of one remat train step on blocks (b sequences of s tokens a
    rank, n ranks of 'model', dp of 'data', float32). Per repeat: each
    row-parallel exit (GQA or MLA output, MLP, MoE combine and shared
    expert, channel mix, Mamba's output) all-reduces (b, s, d) in the
    forward, and Mamba's three sums (its delta's low rank, B and C) their
    (b, s, dt_rank) and (b, s, d_state); the recompute
    under remat stops once the last tensor the backward needs is
    back (``torch.utils.checkpoint``'s early stop), so a repeat's
    last exit, whose output nothing saves, is not recomputed (the
    channel mix's is: ``r * v`` saves it); the backward sums each
    entry's gradient: GQA's x, K and V (when its heads are cut),
    MLA's query latent, kv latent and rope key, the MLP's and the
    shared expert's x, the MoE's tokens and routing weights, Mamba's x
    and its three sums again (``tp.summed``). Mamba's ``in_proj`` is
    re-cut in the forward, the recompute and the backward, (d, 2 x
    d_inner / n) each time. Outside
    the stack: the embedding's sum, the head's entry, and the loss's
    maximum, sum of exponentials and target logit, and again for the
    multi-token prediction loss, whose block runs outside the remat
    region (its exits are not recomputed)."""
    d = cfg.d_model
    ring = lambda numel: 2 * 4 * numel * (n - 1) // n  # noqa: E731
    act = ring(b * s * d)
    calls = nbytes = 0
    recuts = 0

    def add(k, each):
        nonlocal calls, nbytes
        calls, nbytes = calls + k, nbytes + k * each

    def attention():
        """(exits, entries) of an attention sub-layer."""
        if cfg.mla:
            m = cfg.mla
            return [act], [ring(b * s * m.q_lora_rank),
                           ring(b * s * m.kv_lora_rank),
                           ring(b * s * m.qk_rope_dim)]
        if L.heads_cut(cfg):
            kv = ring(b * s * cfg.n_kv_heads * cfg.head_dim)
            return [act], [act, kv, kv]
        return [], []
    for g in stack_plan(cfg):
        for i, kind in enumerate(g.kinds):
            exits, entries = attention() if kind.startswith("attn") \
                else ([], [])
            if kind.startswith("mamba"):
                ssm = cfg.ssm
                sums = [ring(b * s * (ssm.dt_rank or d // 16)),
                        ring(b * s * ssm.d_state), ring(b * s * ssm.d_state)]
                exits, entries = [act] + sums, [act] + sums
                recuts += 3 * g.repeats
            if kind == "rwkv":
                exits, entries = [act], [act]
            elif kind.endswith("_moe"):
                # the capacity dispatch enters the global batch's
                # tokens, the shard_map dispatch its data shard's
                t = b * s * (1 if cfg.moe.dispatch == "shard_map"
                             and n > 1 else dp)
                exits.append(act)
                entries += [ring(t * d), ring(t * cfg.moe.top_k)]
                if cfg.moe.n_shared:
                    exits.append(act)
                    entries.append(act)
            else:           # the MLP after attention or Mamba
                exits.append(act)
                entries.append(act)
            # every exit but the repeat's last feeds a tensor that the
            # backward saves (the channel mix's last too)
            last = i == len(g.kinds) - 1 and kind != "rwkv"
            recompute = exits[:-1] if last else exits
            for each in exits + recompute + entries:
                add(g.repeats, each)
    loss = (act, act, ring(b * s), ring(b * s), ring(b * s))
    for each in loss:
        add(1, each)
    if cfg.mtp_depth:
        exits, entries = attention()
        for each in exits + entries + [act, act] + list(loss):
            add(1, each)
    din = cfg.ssm.expand * d if cfg.ssm else 0
    recut = 4 * d * 2 * (din // n) * (n - 1) // n
    return (calls, nbytes), (recuts, recuts * recut)


@pytest.mark.parametrize("case", [c[0] for c in STEPS])
def test_wire_follows_the_ring_model(runs, case):
    """No parameter is gathered over 'model' (the ring model's gathers of
    the other axes only), and the step's ``tp_all_reduce`` and
    ``tp_all_to_all`` calls and bytes are the layer plan's."""
    _, world, mesh, v = [c for c in STEPS if c[0] == case][0]
    cfg = _port_cfg(v)
    b = VARIANTS[v][3] // mesh[0]
    calls, nbytes = _ring_gathers(cfg, mesh)
    plan, recuts = _tp_plan(cfg, b, SEQ, mesh[1], mesh[0])
    for res in _results(runs, "step", case):
        wire = _wire(res)
        assert (wire["param_gather"], wire["param_gather_bytes"]) == \
            (calls, nbytes)
        assert (wire["tp_all_reduce"], wire["tp_all_reduce_bytes"]) == plan
        assert (wire["tp_all_to_all"], wire["tp_all_to_all_bytes"]) == recuts
        assert wire["tp_all_gather"] == 0


def test_wire_follows_the_plan_with_chunks_nested_in_the_remat(runs):
    """jamba's step at 2 x 128 tokens on (1, 2): the scans run as chunks
    under ``checkpoint`` inside each repeat's, and the collectives are
    still the layer plan's (no collective runs inside a scan, so the
    nested recompute adds none); the step within 1e-3 of the whole tree's
    gradients."""
    cfg = _port_cfg("jamba")
    plan, recuts = _tp_plan(cfg, 2, LONG, 2, 1)
    for res in _results(runs, "long"):
        wire = _wire(res)
        assert (wire["tp_all_reduce"], wire["tp_all_reduce_bytes"]) == plan
        assert (wire["tp_all_to_all"], wire["tp_all_to_all_bytes"]) == recuts
        assert wire["param_gather_bytes"] == 0
        for name in _leaf_keys(res, "grad"):
            assert _within(res[f"grad.{name}"], res[f"whole_grad.{name}"],
                           TP_TOL), name


def test_batch_axes_that_name_model_turn_tensor_parallel_off():
    """rwkv6-3b's smoke with a batch that divides over 'model' folds it
    into the batch axes (``cell_policy``), and then no layer computes over
    it; with the test's batch of 5 it does not."""
    cfg = cfgs.smoke_config("rwkv6-3b")
    for batch, axes in ((8, ("data", "model")), (5, ("data",))):
        shape = cfgs.ShapeConfig("t", SEQ, batch, "train")
        assert cell_policy(cfg, shape, _duck((1, 4))).batch_axes == axes


# -------------------------------------------------------------- serving --

@pytest.mark.parametrize("case", [c[0] for c in SERVE])
def test_serving_from_blocks(runs, case):
    _, world, mesh, v, drop, seq = [c for c in SERVE if c[0] == case][0]
    cfg = _port_cfg(v)
    n_attn, n_mamba = (sum(g.repeats * sum(k.startswith(kind)
                                           for k in g.kinds)
                           for g in stack_plan(cfg))
                       for kind in ("attn", "mamba"))
    q_gathers = n_attn * (SERVE_NEW - 1) if seq else 0
    # Mamba's conv and SSM states, whole in the cache: the prefill's and
    # each decode step's
    q_gathers += 2 * n_mamba * SERVE_NEW
    for res in _results(runs, "serve", case):
        assert torch.equal(res["tokens"], res["whole_tokens"])
        if world == 1:
            assert torch.equal(_bits(res["logits"]),
                               _bits(res["whole_logits"]))
        else:
            assert _within(res["logits"], res["whole_logits"], GRAD_TOL)
        wire = _wire(res)
        # the logits of every step, and the seq-sharded decode's queries
        assert wire["tp_all_gather"] == SERVE_NEW + q_gathers
        if drop or mesh[0] == 1:
            assert wire["param_gather"] == 0
