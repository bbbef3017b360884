"""The port's data-parallel train step under a mesh vs the JAX reference's
sharded step, on the CPU, for a dense (deepseek-67b), an MoE
(deepseek-v2-236b, with the capacity dispatch and with the ``shard_map``
dispatch) and an SSM (rwkv6-3b) arch at their ``SMOKE`` sizes, on a (2, 2)
``('data', 'model')`` mesh over a gloo world of 4; and, in a world of one,
the step under a (1, 1) mesh against the step without a mesh.

The reference's step is its loss's gradient, ``jax.value_and_grad`` jitted
under the mesh (Auto axes where jax has ``AxisType``) with the parameters
and the batch placed by ``partition_specs`` and ``batch_shardings``: the
gradient its jitted ``make_train_step`` hands AdamW (with ``n_micro`` 2,
the mean of the two microbatches' gradients).  The port's step gets the
global batch on every rank and averages the loss and the gradients over
``policy.batch_axes``; the test reads the gradients it hands AdamW.

Tolerances, and why: the loss within 1e-6 relative of the reference's and
of the port's step on one device.  Each gradient leaf within 1e-5 x its
largest value of the port's step on one device (gloo's sums over ranks and
the port's over tokens round in their own orders; measured up to 6e-7),
and within ``tests/test_torch_train_grads.py``'s 2e-3 x its largest value
of the reference's sharded step: on one device the port's gradients are
already that far from ``jax.value_and_grad``'s (XLA's float32 ``exp`` and
``tanh`` differ from torch's by an ulp, and a weight's gradient sums a
batch of products; measured up to 4.1e-4 here, on deepseek-67b's ``w2``
with and without the mesh alike), and the sharded step inherits that
distance.  The parameters after AdamW are not compared: Adam turns an ulp
of gradient noise on a near-zero gradient into a step of about lr the
other way.  At world size 1 the step (loss, gradients, new parameters) is
bit-identical to the step without a mesh.
"""
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.configs.base import smoke_config as jsmoke  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs.base import ShapeConfig, smoke_config  # noqa: E402
from repro_torch.launch import policy  # noqa: E402
from repro_torch.models.params import params_from_reference  # noqa: E402

from _torch_dist_worker import run_world  # noqa: E402
from conftest import run_devices  # noqa: E402

torch.set_num_threads(1)

BATCH, SEQ = 8, 16
MESH = (2, 2)
GRAD_TOL = 1e-5        # x each leaf's largest: sharded against one device
REF_GRAD_TOL = 2e-3    # x each leaf's largest: tests/test_torch_train_grads
# (case, arch, dispatch, batch_axes or None for cell_policy's, n_micro)
CASES = [("dense", "deepseek-67b", None, None, 1),
         ("dense_micro2", "deepseek-67b", None, None, 2),
         ("moe", "deepseek-v2-236b", None, None, 1),
         ("moe_shard_map", "deepseek-v2-236b", "shard_map", None, 1),
         ("moe_shard_map_dp", "deepseek-v2-236b", "shard_map", ("data",), 1),
         ("ssm", "rwkv6-3b", None, None, 1)]
ARCHS = sorted({c[1] for c in CASES})

REFERENCE = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs.base import ShapeConfig, smoke_config
from repro.distributed import sharding as shd
from repro.launch.policy import cell_policy, CellPolicy
from repro.models.model import Model
from repro.train import step as steps

OUT = sys.argv[1]
CASES, ARCHS, MESH, BATCH, SEQ = eval(sys.argv[2])
inp = dict(np.load(OUT + "/inputs.npz"))
devs = np.array(jax.devices()[:MESH[0] * MESH[1]]).reshape(MESH)
kw = {}
if hasattr(jax.sharding, "AxisType"):
    kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
mesh = jax.sharding.Mesh(devs, ("data", "model"), **kw)
res = {}
for case, arch, dispatch, batch_axes, n_micro in CASES:
    cfg = smoke_config(arch)
    if dispatch:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch))
    model = Model(cfg)
    batch = {"tokens": inp[f"{arch}.tokens"], "labels": inp[f"{arch}.labels"]}
    with shd.use_mesh(mesh):
        policy = cell_policy(cfg, ShapeConfig("t", SEQ, BATCH, "train"), mesh)
        if batch_axes is not None:
            policy = dataclasses.replace(policy, batch_axes=tuple(batch_axes))
        res[f"{case}.batch_axes"] = np.array(policy.batch_axes)
        psh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                           model.partition_specs())
        p = jax.device_put(model.init(jax.random.PRNGKey(0)), psh)
        vg = jax.jit(jax.value_and_grad(model.loss))
        loss, grads = 0.0, None
        for i in range(n_micro):
            sl = slice(i * BATCH // n_micro, (i + 1) * BATCH // n_micro)
            mb = {k: v[sl] for k, v in batch.items()}
            bsh = steps.batch_shardings(mb, policy, mesh)
            l, g = vg(p, {k: jax.device_put(v, bsh[k]) for k, v in mb.items()})
            loss += l
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        loss, grads = loss / n_micro, jax.tree.map(lambda g: g / n_micro, grads)
    res[f"{case}.loss"] = np.asarray(loss)
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        res[f"{case}.grad." + ".".join(str(q.key) for q in path)] = \
            np.asarray(leaf)
np.savez(OUT + "/reference.npz", **res)
print("REFERENCE_OK")
"""


def _policy_axes(arch, dispatch, axes):
    if axes is not None:
        return axes
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape=dict(zip(("data", "model"), MESH)))
    return policy.cell_policy(smoke_config(arch),
                              ShapeConfig("t", SEQ, BATCH, "train"),
                              mesh).batch_axes


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distt")
    rng = np.random.default_rng(0)
    inp = {}
    for arch in ARCHS:
        v = smoke_config(arch).vocab_size
        for k in ("tokens", "labels"):
            inp[f"{arch}.{k}"] = rng.integers(0, v, (BATCH, SEQ)
                                              ).astype(np.int32)
    np.savez(tmp / "inputs.npz", **inp)
    script = REFERENCE.replace("sys.argv[1]", repr(str(tmp))).replace(
        "sys.argv[2]", repr(repr((CASES, ARCHS, MESH, BATCH, SEQ))))
    # the reference's parameters, as its subprocess draws them
    params = {a: params_from_reference(jax.tree.map(
        np.asarray, JModel(jsmoke(a)).init(jax.random.PRNGKey(0))), "cpu")
        for a in ARCHS}
    batches = {a: {k: torch.from_numpy(inp[f"{a}.{k}"])
                   for k in ("tokens", "labels")} for a in ARCHS}
    jobs = [("train_step", MESH, dict(
        arch=arch, params=params[arch], batch=batches[arch],
        batch_axes=_policy_axes(arch, dispatch, axes), n_micro=n_micro,
        dispatch=dispatch))
        for case, arch, dispatch, axes, n_micro in CASES]
    one = []
    for arch in ARCHS:
        for shape in ((1, 1), None):
            one.append(("train_step", shape, dict(
                arch=arch, params=params[arch], batch=batches[arch],
                batch_axes=("data", "model"), n_micro=1)))
    # the reference and the port's two worlds run at once
    with ThreadPoolExecutor(3) as ex:
        ref_out = ex.submit(run_devices, script, 8)
        four = ex.submit(run_world, 4, jobs, tmp)
        one = ex.submit(run_world, 1, one, tmp)
        assert "REFERENCE_OK" in ref_out.result()
        out = {"four": four.result(), "one": one.result()[0]}
    out["ref"] = dict(np.load(tmp / "reference.npz"))
    out["axes"] = [job[2]["batch_axes"] for job in jobs]
    return out


def _within(a, b, tol):
    """max|a - b| <= tol x max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() <= tol * np.abs(b).max()


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_data_parallel_step_matches_the_reference_sharded_step(runs, case):
    ref = runs["ref"]
    i = [c[0] for c in CASES].index(case)
    want_loss = float(ref[f"{case}.loss"])
    grads = {k[len(case) + 6:]: v for k, v in ref.items()
             if k.startswith(f"{case}.grad.")}
    results = [rank[i] for rank in runs["four"]]
    one = runs["one"][2 * ARCHS.index(CASES[i][1]) + 1]
    for res in results:
        assert abs(float(res["loss"]) - want_loss) <= 1e-6 * abs(want_loss)
        assert abs(float(res["loss"]) - float(one["loss"])) <= \
            1e-6 * abs(float(one["loss"]))
        got = {k[5:]: v for k, v in res.items() if k.startswith("grad.")}
        assert sorted(got) == sorted(grads)
        for name, w in grads.items():
            g = got[name].numpy()
            # what the mesh adds to the step: against the port's own step
            # on one device
            assert _within(g, one["grad." + name].numpy(), GRAD_TOL), name
            # against the reference's sharded step: the port's one-device
            # distance to the reference, which the sharded step inherits
            assert _within(g, w, REF_GRAD_TOL), name
    # every rank ends the step with the same parameters
    for res in results[1:]:
        for k, v in res.items():
            if k.startswith("param."):
                assert torch.equal(v, results[0][k]), k


def test_policies_fold_the_model_axis_into_the_batch(runs):
    """The smoke archs' head counts do not divide 16: cell_policy folds the
    model axis into data parallelism (the reference's policy and the
    port's alike), so the MoE's shard_map dispatch runs with 'model'
    cutting the batch (and once with it not)."""
    ref = runs["ref"]
    for (case, _, _, axes, _), got in zip(CASES, runs["axes"]):
        want = axes or ("data", "model")
        assert tuple(str(a) for a in ref[f"{case}.batch_axes"]) == want
        assert tuple(got) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_step_under_a_one_rank_mesh_is_the_step_without_one(runs, arch):
    i = ARCHS.index(arch)
    meshed, plain = runs["one"][2 * i], runs["one"][2 * i + 1]
    assert sorted(meshed) == sorted(plain)
    for k, v in plain.items():
        assert v.dtype == meshed[k].dtype
        assert torch.equal(v.view(torch.int32) if v.dtype == torch.float32
                           else v, meshed[k].view(torch.int32)
                           if v.dtype == torch.float32 else meshed[k]), k
