"""The SSM scans as operators (``repro_torch.kernels.scan``: RWKV6's wkv and
Mamba's selective scan, forward and backward) on the CPU, where each
operator runs its plain version; the CUDA kernels themselves are held
against these on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 20).

What is held:
* the plain reverse recurrences (``wkv6_bwd_ref``, ``mamba_scan_bwd_ref``,
  which mirror the kernels' math) against autograd through the loop
  (``ssm._scan``, chunked where it chunks) in float64, every input's
  gradient (``u``, ``A``, ``S0`` and ``h0`` too) within 1e-10 of its
  largest |value|, at 1, 63, 64, 128 and 200 steps, batch 2; the plain
  forwards' outputs and states bit-identical to the loop's; and a Mamba
  block of channels (the tensor-parallel cut over ``d_inner``) against
  the whole: its channels' gradients the whole's, its dB and dC partial
  sums adding up to the whole's;
* the differentiable scans (``wkv6``, ``mamba_scan``, a
  ``torch.autograd.Function`` over the operators) against autograd through
  the loop, and the layers through the operators against the reference
  (``repro.models.ssm``, ``jax.grad``);
* the fakes on ``meta``: every output's shape and dtype, the kept chunk
  states included;
* ``OpAnalysis``: the operators' FLOPs on ``meta``, forward and backward,
  equal the loop's on the CPU (``FlopCounterMode``'s count); a backward's
  declared workspace (``bitplane.WORKSPACE``) counted as live for the
  length of its call: a lone call's temp is its outputs plus it, and a
  mini SSM cell's temp rises by exactly what is declared where the call
  is the step's peak;
* ``mamba_apply`` and ``rwkv_time_mix_apply`` on ``meta`` dispatch to the
  operators (one each a pass) and never to the per-token steps;
* a mini SSM dry-run cell on a fake world finishes, with the FLOPs of the
  same step run through the CPU loop in a real gloo world.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import base as jcfg  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.kernels import bitplane as bp  # noqa: E402
from repro_torch.kernels import scan  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.op_analysis import OpAnalysis  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402

from _torch_dist_worker import run_world  # noqa: E402

torch.set_num_threads(1)

SEQS = (1, 63, 64, 128, 200)
CHUNK = 64
REF_TOL = 1e-10          # float64: the same sums in another order
B, H, D, N = 2, 2, 12, 5


def _inputs(kind, s, seed=0, dtype=np.float64, d=D, n=N):
    """A scan's inputs in their models' ranges: RWKV's decay in (0, 1)
    after the clamp, Mamba's A = -exp(.) and dt a softplus."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))
    if kind == "wkv6":
        r, k, v = (t(rng.normal(size=(B, s, H, 64))) for _ in range(3))
        w = t(np.exp(-np.exp(rng.uniform(-8, 1, size=(B, s, H, 64)))))
        return (r, k, v, w, t(rng.normal(size=(H, 64))),
                t(rng.normal(size=(B, H, 64, 64))))
    return (t(rng.normal(size=(B, s, d))),
            t(np.log1p(np.exp(rng.normal(size=(B, s, d))))),
            t(rng.normal(size=(B, s, n))), t(rng.normal(size=(B, s, n))),
            t(-np.exp(rng.normal(size=(d, n)))),
            t(rng.normal(size=(B, d, n))))


def _loop(kind, args):
    """The loop the CPU runs (``ssm._scan``): (outputs, final state)."""
    if kind == "wkv6":
        r, k, v, w, u, s0 = args
        S, out = SSM._scan(functools.partial(SSM._rwkv_step,
                                             u[None, :, :, None]),
                           s0, r, k, v, w)
        return out, S
    x, dt, bm, cm, a, h0 = args
    h, y = SSM._scan(functools.partial(SSM._mamba_step, a), h0, x, dt, bm,
                     cm)
    return y, h


FWD = {"wkv6": scan.wkv6_fwd_ref, "mamba": scan.mamba_scan_fwd_ref}
BWD = {"wkv6": scan.wkv6_bwd_ref, "mamba": scan.mamba_scan_bwd_ref}
DIFF = {"wkv6": scan.wkv6, "mamba": scan.mamba_scan}


def _cotangents(out, final, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=t.shape)).to(t.dtype)
                 for t in (out, final))


def _autograd(kind, args, cot):
    leaves = [a.clone().requires_grad_() for a in args]
    out, final = _loop(kind, leaves)
    loss = (out * cot[0]).sum() + (final * cot[1]).sum()
    return (out.detach(), final.detach(),
            torch.autograd.grad(loss, leaves))


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= tol * float(w.abs().max())


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("kind", ["wkv6", "mamba"])
def test_plain_backward_equals_autograd_through_the_loop(kind, s):
    args = _inputs(kind, s)
    out, final, states = FWD[kind](*args, CHUNK, True)
    cot = _cotangents(out, final)
    want_out, want_final, want = _autograd(kind, args, cot)
    assert torch.equal(out, want_out) and torch.equal(final, want_final)
    assert states.shape[1] == -(-s // CHUNK)
    assert torch.equal(states[:, 0], args[5])
    got = BWD[kind](*args[:5], states, *cot, CHUNK)
    assert len(got) == 6
    _close(got, want, REF_TOL)
    for g in got:
        assert bool((g != 0).any())


def test_plain_backward_on_a_tensor_parallel_channel_block():
    """Mamba's scan on the channels 5..11 of 12 (a rank's block of
    ``d_inner`` under ``tp``), B and C whole: the block's dx, d dt, dA and
    dh0 are the whole scan's on those channels; its dB and dC are the
    block's partial sums (``tp.summed``'s all-reduce adds the ranks'),
    which with the other block's add up to the whole scan's."""
    args = _inputs("mamba", 128)
    cot = _cotangents(*FWD["mamba"](*args, CHUNK, False)[:2])
    whole = _autograd("mamba", args, cot)[2]
    parts = []
    for lo, hi in ((0, 5), (5, 12)):
        x, dt, bm, cm, a, h0 = args
        blk = (x[..., lo:hi].contiguous(), dt[..., lo:hi].contiguous(), bm,
               cm, a[lo:hi].contiguous(), h0[:, lo:hi].contiguous())
        y, h, states = FWD["mamba"](*blk, CHUNK, True)
        got = BWD["mamba"](*blk[:5], states, cot[0][..., lo:hi].contiguous(),
                           cot[1][:, lo:hi].contiguous(), CHUNK)
        want = _autograd("mamba", blk, (cot[0][..., lo:hi],
                                         cot[1][:, lo:hi]))[2]
        _close(got, want, REF_TOL)
        _close((got[0], got[1]), (whole[0][..., lo:hi], whole[1][..., lo:hi]),
               REF_TOL)
        _close((got[4], got[5]), (whole[4][lo:hi], whole[5][:, lo:hi]),
               REF_TOL)
        parts.append(got)
    _close((parts[0][2] + parts[1][2], parts[0][3] + parts[1][3]),
           (whole[2], whole[3]), REF_TOL)


@pytest.mark.parametrize("s", [63, 128])
@pytest.mark.parametrize("kind", ["wkv6", "mamba"])
def test_differentiable_scan_equals_autograd_through_the_loop(kind, s):
    """The autograd Function over the operators (their plain versions on
    the CPU) against the loop, every input's gradient; it keeps the
    states entering each chunk and no per-step state."""
    args = _inputs(kind, s, seed=2)
    want_out, want_final, want = _autograd(kind, args, _cotangents(
        *FWD[kind](*args, CHUNK, False)[:2]))
    cot = _cotangents(want_out, want_final)
    leaves = [a.clone().requires_grad_() for a in args]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        out, final = DIFF[kind](*leaves, CHUNK)
    assert torch.equal(out.detach(), want_out)
    assert torch.equal(final.detach(), want_final)
    states = tuple(FWD[kind](*args, CHUNK, True)[2].shape)
    assert saved == [tuple(a.shape) for a in args[:5]] + [states]
    got = torch.autograd.grad((out * cot[0]).sum() + (final * cot[1]).sum(),
                              leaves)
    _close(got, want, REF_TOL)


def test_operators_reject_what_the_kernels_do_not_take():
    args = _inputs("wkv6", 8, dtype=np.float32)
    with pytest.raises(ValueError, match="chunk"):
        scan.wkv6_fwd(*args, 0, False)
    with pytest.raises(ValueError, match="chunk"):
        scan.wkv6_fwd(*args, 65, False)
    with pytest.raises(ValueError, match="shape"):
        scan.wkv6_fwd(*args[:4], args[4][:1], args[5], CHUNK, False)
    meta = [a.to("meta").double() for a in args]
    with pytest.raises(TypeError):
        scan.wkv6_fwd(*meta, CHUNK, False)
    margs = _inputs("mamba", 8, dtype=np.float32, n=33)
    with pytest.raises(ValueError, match="N in"):
        scan.mamba_scan_fwd(*margs, CHUNK, False)
    with pytest.raises(ValueError, match="contiguous"):
        scan.mamba_scan_fwd(margs[0].transpose(0, 1).contiguous()
                            .transpose(0, 1), *margs[1:], CHUNK, False)


# ----------------------------------------------------------------- meta --

@pytest.mark.parametrize("keep", [True, False])
@pytest.mark.parametrize("kind", ["wkv6", "mamba"])
def test_fakes_give_every_output_shape(kind, keep):
    s = 200
    args = [a.to("meta") for a in _inputs(kind, s, dtype=np.float32)]
    fwd = scan.wkv6_fwd if kind == "wkv6" else scan.mamba_scan_fwd
    bwd = scan.wkv6_bwd if kind == "wkv6" else scan.mamba_scan_bwd
    out, final, states = fwd(*args, CHUNK, keep)
    nc = -(-s // CHUNK) if keep else 0
    state = tuple(args[5].shape)
    assert out.shape == args[0].shape and final.shape == state
    assert states.shape == (B, nc) + state[1:]
    assert {t.device.type for t in (out, final, states)} == {"meta"}
    assert {t.dtype for t in (out, final, states)} == {torch.float32}
    if keep:
        grads = bwd(*args[:5], states, out, final, CHUNK)
        assert [g.shape for g in grads] == [a.shape for a in args]
        assert {g.dtype for g in grads} == {torch.float32}


def _analysed(fn):
    with OpAnalysis() as ana:
        fn()
    return ana.summary()


@pytest.mark.parametrize("s", [64, 100, 128])
@pytest.mark.parametrize("kind", ["wkv6", "mamba"])
def test_operator_flops_on_meta_equal_the_loop_s(kind, s):
    """Forward and backward apart: the operators on ``meta`` against the
    loop on the CPU (at 64 and 100 steps the loop does not chunk, at 128
    it recomputes each chunk in the backward)."""
    counts = {}
    for path in ("loop", "ops"):
        args = _inputs(kind, s, dtype=np.float32)
        if path == "ops":
            args = [a.to("meta") for a in args]
        leaves = [a.requires_grad_() for a in args]
        res = {}

        def fwd():
            res["y"] = (DIFF[kind](*leaves, CHUNK) if path == "ops"
                        else _loop(kind, leaves))
        f = _analysed(fwd)

        def bwd():
            torch.autograd.grad(res["y"][0].sum() + res["y"][1].sum(),
                                leaves)
        counts[path] = (f["flops_per_device"],
                        _analysed(bwd)["flops_per_device"], f)
    assert counts["ops"][:2] == counts["loop"][:2]
    assert counts["ops"][0] > 0
    fwd = counts["ops"][0]
    # chunked, the loop's backward recomputes its forward, less each
    # chunk's last y product (checkpoint stops at its last saved tensor)
    skipped = 2 * 2 * B * D * N if kind == "mamba" else 0
    assert counts["ops"][1] == (3 * fwd - skipped if s == 128 else 2 * fwd)
    ops = counts["ops"][2]["ops_by_name"]
    fwd_name = "wkv6_fwd" if kind == "wkv6" else "mamba_scan_fwd"
    assert ops[f"repro_torch.{fwd_name}.default"]["count"] == 1


def _layer(kind):
    ssm = cfgs.SSMConfig(kind="mamba" if kind == "mamba" else "rwkv6",
                         d_state=8, expand=2, dt_rank=8)
    cfg = cfgs.ModelConfig(name="t", family="ssm", n_layers=1, d_model=128,
                           n_heads=2, n_kv_heads=2, d_ff=256, vocab_size=64,
                           compute_dtype="float32", ssm=ssm)
    if kind == "mamba":
        return cfg, SSM.mamba_abstract, SSM.mamba_apply, JSSM.mamba_abstract, \
            JSSM.mamba_apply
    return (cfg, SSM.rwkv_time_mix_abstract, SSM.rwkv_time_mix_apply,
            JSSM.rwkv_time_mix_abstract, JSSM.rwkv_time_mix_apply)


@pytest.mark.parametrize("kind", ["wkv6", "mamba"])
def test_layers_on_meta_dispatch_to_the_operators(kind, monkeypatch):
    cfg, abstract, apply, _, _ = _layer(kind)

    def no_steps(*a):
        raise AssertionError("a per-token step ran on meta")
    monkeypatch.setattr(SSM, "_rwkv_step", no_steps)
    monkeypatch.setattr(SSM, "_mamba_step", no_steps)
    params = {k: torch.empty(v.shape, device="meta", requires_grad=True)
              for k, v in P.tree_shape_structs(abstract(cfg),
                                               "float32").items()}
    x = torch.empty((2, 256, cfg.d_model), device="meta", requires_grad=True)
    with OpAnalysis() as ana:
        y = apply(params, x, cfg)[0]
        torch.autograd.grad(y.sum(), [x] + list(params.values()))
    ops = ana.summary()["ops_by_name"]
    names = ("wkv6_fwd", "wkv6_bwd") if kind == "wkv6" else \
        ("mamba_scan_fwd", "mamba_scan_bwd")
    for name in names:
        assert ops[f"repro_torch.{name}.default"]["count"] == 1
    with torch.inference_mode():
        y, state = apply(params, x[:, :1], cfg)
    assert y.shape == (2, 1, cfg.d_model)


# ------------------------------------------------- against the reference --

@pytest.mark.parametrize("s", [64, 130])
@pytest.mark.parametrize("kind", ["wkv6", "mamba"])
def test_layers_through_the_operators_match_the_reference(kind, s,
                                                          monkeypatch):
    """The layer with its scan through the operators (their plain versions
    on the CPU: the layers' dispatch patched) against
    ``repro.models.ssm``'s: the output and the gradients of x and every
    leaf of ``sum(out * cot)`` (``jax.grad``), float32."""
    cfg, abstract, apply, jabstract, japply = _layer(kind)
    jc = jcfg.ModelConfig(**{**dataclasses.asdict(cfg), "ssm": jcfg.SSMConfig(
        **dataclasses.asdict(cfg.ssm))})
    jp = jax.tree.map(np.asarray, JP.tree_init(
        jabstract(jc), jax.random.PRNGKey(3), "float32"))
    rng = np.random.default_rng(3)
    jp = {k: (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
          for k, v in jp.items()}
    x = (0.5 * rng.normal(size=(2, s, cfg.d_model))).astype(np.float32)
    cot = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        y = japply(p, xx, jc)[0]
        return jnp.sum(y * cot), y
    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in
          P.params_from_reference(jp, "cpu").items()}
    tx = torch.from_numpy(x).requires_grad_()
    bp.reset_launches()
    monkeypatch.setattr(SSM, "_on_operators", lambda t: True)
    ty = apply(tp, tx, cfg)[0]
    tg = torch.autograd.grad((ty * torch.from_numpy(cot)).sum(),
                             [tx] + list(tp.values()))
    want = [np.asarray(jg[1])] + [np.asarray(jg[0][k]) for k in tp]
    _close([ty.detach().double()], [torch.from_numpy(np.array(jy))
                                    .double()], 1e-5)
    _close([g.double() for g in tg],
           [torch.from_numpy(np.array(w)).double() for w in want], 1e-4)
    assert sum(bp.launches().values()) == 0    # the CPU launches nothing


# ------------------------------------------------------------ the dry run --

MINI = [("rwkv6-3b", 2, 128), ("jamba-v0.1-52b", 2, 128)]


@pytest.fixture(scope="module")
def mini_cells(tmp_path_factory):
    """Each arch's smoke train step, 2 x 128 tokens (the scans chunked), on
    a fake (1, 2) ('data', 'model') world on ``meta`` (the operators) and
    on a real 2-rank gloo world through the CPU's loop."""
    tmp = tmp_path_factory.mktemp("ssm_dryrun")
    specs = {a: dryrun.cell_spec(a, "train", "pair", smoke=True,
                                 shape_dims=("train", s, b),
                                 mesh_dims=((1, 2), ("data", "model")))
             for a, b, s in MINI}
    fake = {a: dryrun.run_spec(spec, 600) for a, spec in specs.items()}
    loop = run_world(2, [("dryrun_real", (1, 2),
                          dict(spec=specs[a], scan_ops=False))
                         for a, _, _ in MINI], tmp)
    return fake, {a: loop[0][i] for i, (a, _, _) in enumerate(MINI)}


@pytest.mark.parametrize("arch", [a for a, _, _ in MINI])
def test_mini_ssm_dryrun_cell_flops_equal_the_loop_s(mini_cells, arch):
    fake, loop = mini_cells[0][arch], mini_cells[1][arch]
    assert fake["status"] == "ok", fake.get("traceback", fake)
    assert fake["flops_per_device"] == loop["flops_per_device"] > 0
    names = ("wkv6_fwd", "wkv6_bwd") if arch.startswith("rwkv") else \
        ("mamba_scan_fwd", "mamba_scan_bwd")
    ops = fake["ops_by_name"]
    for name in names:
        assert ops[f"repro_torch.{name}.default"]["count"] > 0
    assert not any(k.startswith("repro_torch.") for k in loop["ops_by_name"])
    # the fused scans move fewer bytes than the loop's eager steps
    assert fake["hbm_bytes_per_device"] < loop["hbm_bytes_per_device"]


# ------------------------------------------------ the backwards' workspace --

# rwkv6-3b's 40 heads, jamba-v0.1-52b's d_inner 8192 and d_state 16, 1 x 4096
FULL = {"wkv6": dict(h=40), "mamba": dict(d=8192, n=16)}
WS_OP = {"wkv6": torch.ops.repro_torch.wkv6_bwd.default,
         "mamba": torch.ops.repro_torch.mamba_scan_bwd.default}
BWD_OPS = {"wkv6": scan.wkv6_bwd, "mamba": scan.mamba_scan_bwd}


def _bwd_meta_args(kind, b=1, s=4096):
    """A backward's inputs at full width on ``meta`` (made before any
    analysis opens, so that they are its arguments)."""
    def m(*shape):
        return torch.empty(shape, device="meta")
    nc = -(-s // CHUNK)
    if kind == "wkv6":
        h = FULL[kind]["h"]
        x = m(b, s, h, 64)
        return (x, m(b, s, h, 64), m(b, s, h, 64), m(b, s, h, 64), m(h, 64),
                m(b, nc, h, 64, 64), m(b, s, h, 64), m(b, h, 64, 64))
    d, n = FULL[kind]["d"], FULL[kind]["n"]
    return (m(b, s, d), m(b, s, d), m(b, s, n), m(b, s, n), m(d, n),
            m(b, nc, d, n), m(b, s, d), m(b, d, n))


@pytest.mark.parametrize("kind", ["wkv6", "mamba"])
def test_a_lone_backward_s_temp_is_its_outputs_and_its_workspace(kind):
    """Under ``OpAnalysis`` on ``meta``, one backward call at its model's
    widths and 1 x 4096: temp bytes = its outputs + the workspace its
    launcher allocates (``*_bwd_workspace``, declared in
    ``bitplane.WORKSPACE``): wkv6's du of each batch row, Mamba's dB / dC
    partials of 128 clusters (2 x 32 MiB) and dA of each batch row."""
    args = _bwd_meta_args(kind)
    fn = bp.WORKSPACE[WS_OP[kind]]
    shapes = fn(*args, CHUNK)
    want = ({"du_part": (1, 40, 64)} if kind == "wkv6" else
            {"part_db": (1, 128, 4096, 16), "part_dc": (1, 128, 4096, 16),
             "part_da": (1, 8192, 16)})
    assert shapes == want
    ws = 4 * sum(int(np.prod(v)) for v in shapes.values())
    with OpAnalysis() as ana:
        grads = BWD_OPS[kind](*args, CHUNK)
    outs = sum(g.numel() * g.element_size() for g in grads)
    rec = ana.summary()
    assert rec["temp_bytes"] == outs + ws
    assert rec["peak_live_bytes"] == rec["base_bytes"] + outs + ws
    # nothing of the workspace outlives the call: a second call's peak is
    # the same, its outputs beside the first's
    with OpAnalysis() as ana:
        first = BWD_OPS[kind](*args, CHUNK)
        second = BWD_OPS[kind](*args, CHUNK)
    assert ana.summary()["temp_bytes"] == 2 * outs + ws
    del first, second


BIG = 1 << 28      # bytes: a declared buffer past any mini cell's peak


def _cell_temp(spec):
    """The mini cell's temp bytes, measured in this process as rank 0 of a
    fake world of two ranks on ``meta``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch import op_analysis
    op_analysis._INFO.clear()     # the operators' workspace is looked up anew
    dims, axes = spec["mesh_dims"]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(dims)))
    try:
        return dryrun.measure(spec, Mesh(tuple(dims), tuple(axes), "cpu"),
                              fake=True)["memory"]["temp_bytes"]
    finally:
        dist.destroy_process_group()
        op_analysis._INFO.clear()


@pytest.mark.parametrize("arch", [a for a, _, _ in MINI])
def test_a_mini_ssm_cell_s_temp_rises_by_the_declared_workspace(arch,
                                                                monkeypatch):
    """A mini SSM cell's step (its smoke train step, 2 x 128 tokens, a fake
    (1, 2) world), counted with the scan backward's workspace declared,
    without it, and with extra declared buffers of ``BIG`` and ``2 BIG``
    bytes.  At the smoke widths the call is not the step's peak, so the
    extra buffers put it there: the temp rises by exactly each declared
    byte (``2 BIG`` gives ``BIG`` more than ``BIG``), which gives what is
    live at the call; the real workspace's temp is then exactly the larger
    of the count without it and that live count plus the workspace."""
    kind = "wkv6" if arch.startswith("rwkv") else "mamba"
    op = WS_OP[kind]
    real = bp.WORKSPACE[op]
    _, b, s = next(m for m in MINI if m[0] == arch)
    spec = dryrun.cell_spec(arch, "train", "pair", smoke=True,
                            shape_dims=("train", s, b),
                            mesh_dims=((1, 2), ("data", "model")))
    seen = []

    def recorded(*args):
        shapes = real(*args)
        seen.append(4 * sum(int(np.prod(v)) for v in shapes.values()))
        return shapes
    monkeypatch.setitem(bp.WORKSPACE, op, recorded)
    with_ws = _cell_temp(spec)
    assert seen and len(set(seen)) == 1     # every call of the step alike
    ws = seen[0]
    monkeypatch.delitem(bp.WORKSPACE, op)
    without = _cell_temp(spec)
    temps = {}
    for extra in (BIG, 2 * BIG):
        monkeypatch.setitem(bp.WORKSPACE, op, lambda *a, e=extra: {
            **real(*a), "extra": (e // 4,)})
        temps[extra] = _cell_temp(spec)
    assert temps[2 * BIG] - temps[BIG] == BIG
    live = temps[BIG] - BIG - ws        # live at the call, its outputs too
    assert with_ws == max(without, live + ws)
    assert without < temps[BIG]


def test_importing_the_scan_operators_builds_nothing():
    assert not bp._libs or torch.cuda.is_available()
    assert set(scan.SYMBOLS) <= set(bp.launches())


def test_the_cpu_runs_the_loop_and_the_card_and_meta_the_operators():
    x = torch.zeros(1)
    assert not SSM._on_operators(x)
    assert SSM._on_operators(x.to("meta"))
