"""The port's mesh-bound plumbing vs the JAX reference, on the CPU:
``cell_policy``, the spec builders, ``compressed_psum`` over gloo worlds of
2 and 4 ranks, and an elastic checkpoint restore across worlds.

The reference runs in one subprocess with host devices
(``conftest.run_devices``), its meshes built with Auto axes where jax has
``AxisType`` (jax 0.9 makes Explicit axes by default, under which its
sharded train step and mini dry-run fail: ``tests/test_distributed.py``).
The port's ranks run as processes of a gloo world
(``tests/_torch_dist_worker.py``); each world runs once per module.

Tolerances, and why:
* ``cell_policy``, the specs, the inputs' stand-ins: equal;
* ``compressed_psum`` at 2 ranks: output, residual, the exponents and the
  packed planes on the wire bit-identical (a sum of two terms is exact in
  any order); at 4 ranks: the reference's own bound, max|out - mean| <
  2**-6 x max|mean|, against the exact mean and against the reference's
  output, and the wire payload bit-identical when the port's encode is fed
  the reference's reduce-scattered shard (gloo's and XLA's sums of four
  terms round in their own orders);
* wire bytes, ring model: below 0.62 x a plain all-reduce at 6 planes (the
  reference's assertion), ``(1 + (1 + P)/32) / 2`` of it in general;
* the checkpoint: leaf files byte-identical to the reference's, each
  rank's restored block equal to its slice.
"""
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.configs import base as jcfg  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.distributed.grad_compress import _encode_planes as j_encode  # noqa: E402,E501
from repro.launch import policy as jpolicy  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.distributed import grad_compress as gc  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import policy  # noqa: E402
from repro_torch.models.model import Model, model_abstract  # noqa: E402
from repro_torch.models.params import (params_from_reference,  # noqa: E402
                                       tree_partition_specs,
                                       tree_shape_structs)
from repro_torch.models.transformer import stack_cache_abstract  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step  # noqa: E402

from _torch_dist_worker import run_world  # noqa: E402
from conftest import run_devices  # noqa: E402

torch.set_num_threads(1)

ARCHS = cfgs.list_archs()
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
N_WIRE = 1 << 20
PLANES = (6, 8)


def _duck(shape, names):
    """A mesh stand-in that both packages' policy and spec code read."""
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)),
                                 devices=np.empty(shape, np.int8))


# ---------------------------------------------------------------- policy --

@pytest.mark.parametrize("arch", ARCHS)
def test_cell_policy_equals_the_reference_on_the_production_meshes(arch):
    for shape_name in jcfg.SHAPES:
        for mesh_shape, names in MESHES.values():
            mesh = _duck(mesh_shape, names)
            want = jpolicy.cell_policy(jcfg.get_config(arch),
                                       jcfg.SHAPES[shape_name], mesh)
            got = policy.cell_policy(cfgs.get_config(arch),
                                     cfgs.SHAPES[shape_name], mesh)
            assert vars(got) == vars(want), (arch, shape_name, mesh_shape)


def test_cell_policy_on_a_built_mesh_reads_its_axes():
    """A host mesh's policy: qwen2's 28 heads fold 'model' into the batch;
    a 64-head arch keeps it for tensor parallelism."""
    mesh = _duck((4, 2), ("data", "model"))
    shape = cfgs.ShapeConfig("t", 32, 8, "train")
    assert policy.cell_policy(cfgs.smoke_config("deepseek-67b"), shape,
                              mesh).batch_axes == ("data", "model")
    assert policy.cell_policy(cfgs.get_config("command-r-plus-104b"), shape,
                              mesh).batch_axes == ("data",)


# ----------------------------------------------------------------- specs --

def _canon(spec):
    """A spec with each one-axis tuple as its name (jax 0.9's
    ``PartitionSpec`` normalizes so; older ones keep the tuple)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _meta(t):
    return (tuple(t.shape), str(t.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    for shape in jcfg.SHAPES.values():
        want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
                jcfg.input_specs(jcfg.get_config(arch), shape).items()}
        got = cfgs.input_specs(cfgs.get_config(arch),
                               cfgs.SHAPES[shape.name])
        assert {k: _meta(v) for k, v in got.items()} == want
        assert all(v.device.type == "meta" for v in got.values())
        assert list(got) == list(want)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("arch", ARCHS)
def test_partition_and_state_specs_equal_the_reference(arch):
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    for mesh_shape, names in MESHES.values():
        mesh = _duck(mesh_shape, names)
        jshd.set_current_mesh(mesh)
        shd.set_current_mesh(mesh)
        try:
            jm, cfg = JModel(jcfg.get_config(arch)), cfgs.get_config(arch)
            abstract = model_abstract(cfg)
            for drop in (False, True):
                want = dict(_leaves(jax.tree.map(
                    _canon, jm.partition_specs(drop), is_leaf=is_p)))
                got = dict(_leaves(tree_partition_specs(abstract, drop)))
                assert got == want, (arch, mesh_shape, drop)
            jo = jadamw.state_partition_specs(jm.partition_specs())
            po = adamw.state_partition_specs(tree_partition_specs(abstract))
            assert tuple(jo.step) == po.step == ()
            assert dict(_leaves(po.m)) == dict(_leaves(jax.tree.map(
                _canon, jo.m, is_leaf=is_p)))
            assert po.v is po.m
            structs = dict(_leaves(tree_shape_structs(abstract,
                                                      cfg.param_dtype)))
            for name, s in _leaves(jm.shape_structs()):
                assert _meta(structs[name]) == (tuple(s.shape), str(s.dtype))
        finally:
            jshd.set_current_mesh(None)
            shd.set_current_mesh(None)


def test_model_spec_methods_are_the_tree_functions():
    cfg = cfgs.smoke_config("deepseek-v2-236b")
    model = Model(cfg, device="cpu")
    mesh = _duck((2, 2), ("data", "model"))
    with shd.use_mesh(mesh):
        assert model.partition_specs(True) == tree_partition_specs(
            model.abstract_params(), True)
        specs = model.partition_specs()
    assert specs["embed"] == ("model", "data")
    assert model.abstract_params() == model_abstract(cfg)
    assert {k: _meta(v) for k, v in _leaves(model.shape_structs())} == \
        {k: _meta(v) for k, v in _leaves(model.params)}


def test_spec_without_a_mesh_and_its_filtering():
    assert shd.spec("dp", "model", None) == (None, None, None)
    mesh = _duck((2, 2), ("data", "model"))
    with shd.use_mesh(mesh):
        assert shd.spec("dp", ("model", "pod"), None) == ("data", "model",
                                                          None)
        assert shd.named(("data",)).spec == ("data",)
        x = torch.arange(4.0)
        assert shd.constraint(x, "dp") is x
    assert shd.named(("data",)) is None


def test_mesh_context_is_process_wide():
    """A CUDA backward runs on autograd's own thread, where
    ``torch.utils.checkpoint`` recomputes a layer's forward: that thread
    sees the mesh and the batch axes the forward saw."""
    import threading
    mesh = _duck((2, 2), ("data", "model"))
    mesh.axes = lambda axes: tuple(axes)
    seen = []
    with shd.use_mesh(mesh), shd.use_batch_axes(("data", "model")):
        t = threading.Thread(target=lambda: seen.append(
            (shd.get_current_mesh(), shd.batch_axes())))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen == [(mesh, ("data", "model"))]
    assert shd.get_current_mesh() is None and shd.batch_axes() == ()


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-v2-236b",
                                  "jamba-v0.1-52b", "rwkv6-3b",
                                  "llama-3.2-vision-90b"])
def test_batch_and_cache_shardings_equal_the_reference(arch):
    """Decode caches and batches on both production meshes' policies
    (seq-sharded at decode_32k), specs compared as tuples."""
    for mesh_shape, names in MESHES.values():
        duck = _duck(mesh_shape, names)
        jmesh = jax.make_mesh((1,) * len(names), names)
        for shape in (jcfg.SHAPES["decode_32k"], jcfg.SHAPES["train_4k"]):
            jp = jpolicy.cell_policy(jcfg.get_config(arch), shape, duck)
            pp = policy.cell_policy(cfgs.get_config(arch),
                                    cfgs.SHAPES[shape.name], duck)
            jsmoke, psmoke = jcfg.smoke_config(arch), cfgs.smoke_config(arch)
            want = jax.tree.map(lambda s: _canon(s.spec), jstep.cache_shardings(
                JModel(jsmoke).init_cache_structs(2, 64), jp, jmesh))
            got = step.cache_shardings(stack_cache_abstract(psmoke, 2, 64),
                                       pp, duck)
            assert ({k: v.spec for k, v in _leaves(got)}
                    == dict(_leaves(want))), (arch, shape.name, mesh_shape)
            jb = jstep.batch_shardings(jcfg.input_specs(jsmoke, shape), jp,
                                       jmesh)
            pb = step.batch_shardings(cfgs.input_specs(psmoke,
                                                       cfgs.SHAPES[shape.name]),
                                      pp, duck)
            assert {k: v.spec for k, v in pb.items()} == \
                {k: _canon(v.spec) for k, v in jb.items()}
            assert step.batch_pspec(pp, 3) == _canon(jstep.batch_pspec(jp, 3))


# ------------------------------------------------------ reference oracle --

REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.ckpt import manager as ck
from repro.configs.base import smoke_config
from repro.distributed import grad_compress as gc
from repro.distributed.sharding import shard_map
from repro.models.model import Model

OUT = sys.argv[1]
inp = np.load(OUT + "/inputs.npz")

def mesh_of(shape, names):
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * len(names)
    return jax.sharding.Mesh(devs, names, **kw)

res = {}
for n in (2, 4):
    mesh = mesh_of((n,), ("data",))
    x = inp[f"x{n}"]
    sh = NamedSharding(mesh, P("data", None))
    for planes in (6, 8):
        f = gc.make_compressed_allreduce(mesh, "data", planes=planes)
        out, resid = jax.jit(f)(jax.device_put(x, sh))

        def wire(xb, planes=planes, n=n):
            flat = xb.astype(jnp.float32).reshape(-1)
            flat = jnp.pad(flat, (0, (-flat.shape[0]) % (n * 4096)))
            shard = jax.lax.psum_scatter(flat.reshape(n, -1), "data",
                                         scatter_dimension=0,
                                         tiled=False) / n
            packed, e = gc._encode_planes(shard, planes)
            return shard[None], packed[None], e[None]
        shard, packed, e = jax.jit(shard_map(
            wire, mesh=mesh, in_specs=P("data"),
            out_specs=(P("data"), P("data"), P("data")),
            check_vma=False))(jax.device_put(x, sh))
        key = f"n{n}_p{planes}"
        res[key + "_out"] = np.asarray(out)
        res[key + "_residual"] = np.asarray(resid)
        res[key + "_shard"] = np.asarray(shard)
        res[key + "_packed"] = np.asarray(packed).view(np.int32)
        res[key + "_e"] = np.asarray(e)

model = Model(smoke_config("qwen2-7b"))
params = model.init(jax.random.PRNGKey(0))
ck.save(OUT + "/ref_ckpt", 1, params)
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    res["param." + ".".join(str(p.key) for p in path)] = np.asarray(leaf)
np.savez(OUT + "/reference.npz", **res)
print("REFERENCE_OK")
"""


def _unflat(flat, prefix):
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        parts = k[len(prefix):].split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    xs = {n: rng.normal(size=(n, N_WIRE)).astype(np.float32)
          for n in (1, 2, 4)}
    np.savez(tmp / "inputs.npz", **{f"x{n}": x for n, x in xs.items()})
    out = run_devices(REFERENCE.replace("sys.argv[1]", repr(str(tmp))),
                      n_devices=8)
    assert "REFERENCE_OK" in out
    ref = dict(np.load(tmp / "reference.npz"))
    params = params_from_reference(_unflat(ref, "param."), device="cpu")
    port_ckpt = str(tmp / "port_ckpt")
    worlds = {}
    for n in (4, 2, 1):
        jobs = [("compressed", (n, 1), {"x": torch.from_numpy(xs[n]),
                                        "planes": p}) for p in PLANES]
        if n == 4:
            jobs.append(("ckpt_save", (2, 2), {"params": params,
                                               "root": port_ckpt}))
        elif n == 2:
            jobs.append(("ckpt_load", (2, 1), {"params": params,
                                               "root": port_ckpt}))
        worlds[n] = run_world(n, jobs, tmp)
    return {"ref": ref, "x": xs, "worlds": worlds, "tmp": tmp}


def _bits(t):
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("planes", PLANES)
def test_compressed_psum_at_two_ranks_bit_identical_to_the_reference(
        runs, planes):
    ref = runs["ref"]
    key = f"n2_p{planes}"
    n_local = ref[key + "_residual"].shape[0] // 2
    for r, res in enumerate(runs["worlds"][2]):
        got = res[PLANES.index(planes)]
        np.testing.assert_array_equal(_bits(got["out"][0]),
                                      ref[key + "_out"][r].view(np.int32))
        np.testing.assert_array_equal(
            _bits(got["residual"]),
            ref[key + "_residual"][r * n_local:(r + 1) * n_local]
            .view(np.int32))
        np.testing.assert_array_equal(got["packed"].numpy(),
                                      ref[key + "_packed"][r])
        assert int(got["e"]) == int(ref[key + "_e"][r])


@pytest.mark.parametrize("planes", PLANES)
def test_compressed_psum_at_four_ranks_within_the_reference_bound(runs,
                                                                  planes):
    ref, x = runs["ref"], runs["x"][4]
    key = f"n4_p{planes}"
    mean = x.astype(np.float64).mean(0)
    top = np.abs(mean).max()
    outs = [res[PLANES.index(planes)]["out"][0].numpy()
            for res in runs["worlds"][4]]
    for r, out in enumerate(outs):
        assert np.array_equal(out, outs[0])      # the same on every rank
        assert np.abs(out - mean).max() / top < 2 ** -6
        assert np.abs(out - ref[key + "_out"][r]).max() / top < 2 ** -6
    # the port's encode of the reference's reduce-scattered shards puts
    # the reference's bytes on the wire
    for r in range(4):
        packed, e = gc._encode_planes(torch.from_numpy(ref[key + "_shard"][r]),
                                      planes)
        np.testing.assert_array_equal(packed.numpy(), ref[key + "_packed"][r])
        assert int(e) == int(ref[key + "_e"][r])
        jp, je = j_encode(ref[key + "_shard"][r], planes)
        np.testing.assert_array_equal(packed.numpy(),
                                      np.asarray(jp).view(np.int32))


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_wire_bytes_by_the_ring_model(runs, n):
    for i, planes in enumerate(PLANES):
        comp, plain = (int(v) for v in runs["worlds"][n][0][i]["wire"])
        s = 4 * N_WIRE
        want = (s * (n - 1) // n                     # reduce-scatter
                + (n * (1 + planes) * (N_WIRE // n // 32) * 4 + 4 * n)
                * (n - 1) // n)                      # two all-gathers
        assert plain == 2 * s * (n - 1) // n
        assert abs(comp - want) <= 2, (comp, want)
        if planes == 6:
            assert comp < 0.62 * plain, (comp, plain)


def test_compressed_psum_one_rank_is_ef_quantize(runs):
    """With an axis of one rank the mean is x, and the output is
    ``ef_quantize``'s q bit for bit (padding does not move the maximum);
    the residual is x - q."""
    got = runs["worlds"][1][0][0]
    x = torch.from_numpy(runs["x"][1][0])
    q = got["ef_q"][0]
    assert torch.equal(got["out"][0].view(torch.int32), q.view(torch.int32))
    assert torch.equal(got["residual"][:x.numel()].view(torch.int32),
                       (x - q).view(torch.int32))


def test_elastic_restore_from_a_2x2_save_onto_a_2x1_world(runs):
    tmp = runs["tmp"]
    ref_dir, port_dir = tmp / "ref_ckpt" / "step_00000001", \
        tmp / "port_ckpt" / "step_00000001"
    jm = json.loads((ref_dir / "manifest.json").read_text())
    pm = json.loads((port_dir / "manifest.json").read_text())
    for m in (jm, pm):
        m.pop("time")
    assert pm == jm
    for name, entry in jm["leaves"].items():
        assert (port_dir / entry["file"]).read_bytes() == \
            (ref_dir / entry["file"]).read_bytes(), name
    ref = runs["ref"]
    for r, res in enumerate(runs["worlds"][2]):
        loaded = res[-1]
        names = [k[4:] for k in loaded if k.startswith("got.")]
        assert len(names) == len([k for k in ref if k.startswith("param.")])
        cut = 0
        for name in names:
            got, want = loaded[f"got.{name}"], loaded[f"want.{name}"]
            assert torch.equal(got, want), (r, name)
            cut += got.shape != ref[f"param.{name}"].shape
        assert cut > 0        # the (2, 1) specs cut some leaves over 'data'
