"""The port's dispatched-op analysis (``repro_torch.launch.op_analysis``)
against the reference's HLO analysis (``repro.launch.hlo_analysis``), on
the CPU.

What is held:
* FLOPs: a jitted chain of three ``jnp.dot``s and the port's chain of three
  ``torch.mm``s, both ``2 m n k`` each, exactly; h2o-danube-3-4b's smoke
  prefill, the reference's compiled program against the port's eager run,
  within 1% (the two count the same dots and matmuls: equal today);
* the wire: the port's ``compressed_psum`` against a plain all-reduce on
  an 8-rank world (the fake backend, ``meta`` tensors, the kernels' fakes)
  below 0.62 of the plain wire, the reference's own bound
  (``tests/test_distributed.py::test_compressed_allreduce_saves_wire``),
  and the totals by kind equal to ``WIRE``'s;
* the byte rule: a view 0, ``add_`` 3 x nbytes, a kernel's operator its
  operand and result bytes, ``4 N + 4 P W``;
* peak and temp bytes: one known sequence of allocations and frees, on
  ``meta`` and on the CPU, gives the same, expected, numbers;
* the fused write program: on ``meta`` and run for real on the CPU (the
  plain backend on both), equal counts operator by operator.
Tolerance: none but the prefill's 1%.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.launch.hlo_analysis import HloAnalysis  # noqa: E402
from repro_torch.kernels import bitplane as bp  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch.op_analysis import OpAnalysis  # noqa: E402

torch.set_num_threads(1)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def test_dot_chain_flops_equal_the_reference():
    m, k1, k2, k3, n = 8, 16, 32, 4, 12
    shapes = [(m, k1), (k1, k2), (k2, k3), (k3, n)]
    want = 2 * (m * k1 * k2 + m * k2 * k3 + m * k3 * n)
    args = [jnp.ones(s, jnp.float32) for s in shapes]
    hlo = jax.jit(lambda a, b, c, d: jnp.dot(jnp.dot(jnp.dot(a, b), c), d)
                  ).lower(*args).compile().as_text()
    ref = HloAnalysis(hlo).summary()["flops_per_device"]
    for dev in ("cpu", "meta"):
        a, b, c, d = (torch.ones(s, device=dev) for s in shapes)
        with OpAnalysis() as ana:
            torch.mm(torch.mm(torch.mm(a, b), c), d)
        assert ana.summary()["flops_per_device"] == ref == want
        assert ana.summary()["ops_by_name"]["aten.mm.default"]["count"] == 3


def test_danube_smoke_prefill_flops_within_one_percent():
    """The reference's compiled prefill and the port's eager one count the
    same products: the projections, the MLP, the head and attention's two
    batched products (a dot each in the HLO, a ``bmm`` each here), none of
    the softmax or norms.  Equal today; 1% leaves room for a fusion that
    XLA might turn into another dot shape."""
    from repro.configs.base import smoke_config as jsmoke
    from repro.models.model import Model as JModel
    from repro_torch.configs.base import smoke_config
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_from_reference
    arch, b, s = "h2o-danube-3-4b", 2, 24
    jm = JModel(jsmoke(arch))
    params = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, jm.cfg.vocab_size, (b, s),
                                             dtype=np.int32)
    hlo = jax.jit(lambda p, t: jm.prefill(p, tokens=t, max_len=s)).lower(
        params, jnp.asarray(toks)).compile().as_text()
    ref = HloAnalysis(hlo).summary()["flops_per_device"]
    model = Model(smoke_config(arch), params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu"), device="cpu")
    with torch.inference_mode(), OpAnalysis() as ana:
        model.prefill(tokens=torch.from_numpy(toks), max_len=s)
    got = ana.summary()["flops_per_device"]
    assert ref > 0 and abs(got - ref) <= 0.01 * ref, (got, ref)


_WIRE_WORLD = """
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.grad_compress import compressed_psum
from repro_torch.launch.op_analysis import OpAnalysis
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = shd.Mesh((8,), ("data",), "cpu")
x = torch.empty(1 << 20, device="meta")
out = {}
with shd.use_mesh(mesh):
    for name, fn in (("plain", lambda: shd.psum(x, "data")),
                     ("compressed", lambda: compressed_psum(
                         x, "data", planes=6, backend="cuda"))):
        shd.WIRE.reset()
        with OpAnalysis() as ana:
            fn()
        w = shd.WIRE.snapshot()
        out[name] = dict(ana.summary(), wire={
            k: {"count": w[k], "wire_bytes": w[k + "_bytes"]}
            for k in w if not k.endswith("_bytes") and w[k]})
dist.destroy_process_group()
print("WIRE_WORLD " + json.dumps(out))
"""


def test_compressed_psum_wire_below_the_reference_bound():
    r = subprocess.run([sys.executable, "-c", _WIRE_WORLD], text=True,
                       capture_output=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=SRC))
    line = [x for x in r.stdout.splitlines() if x.startswith("WIRE_WORLD ")]
    assert line, r.stderr[-3000:]
    out = json.loads(line[0][len("WIRE_WORLD "):])
    plain, comp = out["plain"], out["compressed"]
    for rec in (plain, comp):
        assert rec["collectives_by_kind"] == rec["wire"]
        assert rec["collective_wire_bytes_per_device"] == sum(
            v["wire_bytes"] for v in rec["wire"].values())
        assert sum(c["wire_bytes"] for c in rec["top_collectives"]) == \
            rec["collective_wire_bytes_per_device"]
        assert all(c["group_size"] == 8 for c in rec["top_collectives"])
    assert plain["collective_wire_bytes_per_device"] == 2 * 4 * (1 << 20) \
        * 7 // 8
    assert set(comp["wire"]) == {"reduce_scatter", "all_gather"}
    assert comp["collective_wire_bytes_per_device"] < \
        0.62 * plain["collective_wire_bytes_per_device"]
    # the kernels ran as operators, faked on meta
    ops = comp["ops_by_name"]
    assert ops["repro_torch.rb_encode.default"]["count"] == 2
    assert ops["repro_torch.rb_decode.default"]["count"] == 2


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_the_byte_rule(dev):
    n = 1000
    a = torch.ones(n, device=dev)
    b = torch.ones(n, device=dev)
    with OpAnalysis() as ana:
        a.view(10, 100).t()
        a.add_(b)
    ops = ana.summary()["ops_by_name"]
    assert ops["aten.view.default"]["bytes"] == 0
    assert ops["aten.t.default"]["bytes"] == 0
    assert ops["aten.add_.Tensor"]["bytes"] == 3 * 4 * n
    assert ana.summary()["hbm_bytes_per_device"] == 3 * 4 * n


@pytest.mark.parametrize("k,planes", [(1, 1), (3, 23), (5, 8)])
def test_a_kernel_counts_its_operand_and_result_bytes(k, planes):
    n = 4096 * k
    words = n // 32
    mags = torch.empty((1, n), dtype=torch.int32, device="meta")
    launches = bp.encode_register_block_cuda.launches
    with OpAnalysis() as ana:
        out = kops.encode_bitplanes_batch(mags, planes, backend="cuda",
                                          device="meta")
        kops.decode_bitplanes_batch(out, planes, n, backend="cuda",
                                    device="meta")
    assert tuple(out.shape) == (1, planes, words)
    ops = ana.summary()["ops_by_name"]
    for name in ("repro_torch.rb_encode.default",
                 "repro_torch.rb_decode.default"):
        assert ops[name] == {"count": 1, "bytes": 4 * n + 4 * planes * words,
                             "flops": 0}
    # a fake launches nothing
    assert bp.encode_register_block_cuda.launches == launches


def test_meta_under_auto_takes_the_plain_version_and_cpu_under_cuda_raises():
    mags = torch.empty((2, 4096), dtype=torch.int32, device="meta")
    with OpAnalysis() as ana:
        kops.encode_bitplanes_batch(mags, 4, backend="auto", device="meta")
    assert not any(k.startswith("repro_torch.")
                   for k in ana.summary()["ops_by_name"])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kops.encode_bitplanes_batch(torch.zeros((1, 64), dtype=torch.int32),
                                    4, backend="cuda", device="cpu")


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_peak_and_temp_bytes_of_a_known_sequence(dev):
    """Entry holds a (4 kB) and b (2 kB).  Inside: c = a * 2 (4 kB) and d
    (8 kB) live at once (18 kB), d freed, e (1 kB) made, a freed, then f
    (12 kB) made: b + c + e + f = 19 kB, the peak; temp = peak - (a + b)
    = 13 kB, though a is gone by then."""
    a = torch.ones(1000, device=dev)
    b = torch.ones(500, device=dev)
    with OpAnalysis() as ana:
        c = a * 2
        d = torch.empty(2000, device=dev)
        d.fill_(1.0)
        del d
        e = torch.zeros(250, device=dev)
        b.add_(1.0)
        del a
        f = torch.empty(3000, device=dev)
        del c, e, f
    s = ana.summary()
    assert s["base_bytes"] == 6000
    assert s["temp_bytes"] == 13000
    assert s["peak_live_bytes"] == 19000


def test_the_fused_program_counts_alike_on_meta_and_on_the_cpu():
    """The fused write program (``fused_encode_plan(...).run``) on the plain
    backend, counted on ``meta`` (nothing executed) and run for real on the
    CPU: the same operators, FLOPs, bytes, peak and temp."""
    from repro_torch.core import decompose as dc
    from repro_torch.core import refactor as rf
    from repro_torch.core import refactor_fused as rff
    from repro_torch.tune.config import DEFAULT_CONFIG as cfg
    shape = (24, 33, 40)
    levels = dc.num_levels(shape)
    mag_bits = cfg.resolved_mag_bits()
    plan = rff.fused_encode_plan(
        shape, levels, cfg.design, mag_bits,
        tuple(rf._group_plane_split(mag_bits, cfg.group_size)), "torch")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=shape).astype(np.float32))
    got = {}
    for dev in ("cpu", "meta"):
        xd = x.to(dev)
        plan.run(xd)                   # the device's tables, cached once
        with OpAnalysis() as ana:
            plan.run(xd)
        got[dev] = ana.summary()
    assert got["cpu"] == got["meta"]
    assert got["cpu"]["hbm_bytes_per_device"] > 2 * x.numel() * 4
    assert got["cpu"]["temp_bytes"] > 0
