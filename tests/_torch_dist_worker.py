"""One rank of a world of processes for the port's multi-rank tests.

    python tests/_torch_dist_worker.py JOB

``run_world(n, jobs, tmp, device)`` starts the n ranks with ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and a free ``MASTER_PORT`` set (gloo on the
CPU, NCCL with one rank per card on ``cuda``), each rank runs every job of
the list in order, and their results come back as one list per rank.  A
job is ``(scenario, mesh shape, kwargs)``: the scenario is a function of
this module, called under a ``('data', 'model')`` mesh of that shape (or
none for ``None``) with the kwargs (tensors, numbers, strings) placed on
the device; it returns a dict of tensors, which come back on the CPU.

Imports no JAX: the card tests run these scenarios too.
"""
from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def unstack_fan_in(tree, stacked: bool = False):
    """A parameter tree (``Model.params``' nesting) with every stacked leaf
    of 3 or more dims (under ``blocks``) divided in place by the square
    root of its first per-layer dim; returns ``tree``.  ``tree_init``
    takes a stacked leaf's fan-in from its leading, repeat axis (the
    reference's rule), so at one repeat every stacked weight is drawn with
    a standard deviation of 1; divided so, the draw has the fan-in of the
    layer's own leaf.  Not the reference's init: for runs of a model at
    its published widths that must stay finite (jamba's 8-layer period
    drawn by the rule overflows float32 in its norms)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            unstack_fan_in(v, stacked or k == "blocks")
        elif stacked and v.dim() >= 3:
            with torch.no_grad():
                v.div_(v.shape[1] ** 0.5)
    return tree


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(n: int, jobs, tmp, device: str = "cpu", timeout: int = 600):
    """Run ``jobs`` on every rank of a world of ``n``; returns a list (by
    rank) of lists (by job) of result dicts."""
    job_file = os.path.join(str(tmp), f"world{n}_{os.getpid()}.pt")
    torch.save({"jobs": jobs, "device": device}, job_file)
    port = str(_free_port())
    env = dict(os.environ, WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=port, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job_file],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, o[-4000:]) for r, (p, o)
              in enumerate(zip(procs, outs)) if p.returncode != 0]
    if failed:
        raise AssertionError(f"ranks failed: {failed}")
    return [torch.load(f"{job_file}.{r}", weights_only=False)
            for r in range(n)]


# ------------------------------------------------------------- scenarios --

@contextlib.contextmanager
def _recording(module, name: str, log: list):
    """Record the arguments and result of ``module.name`` while active."""
    orig = getattr(module, name)

    def rec(*a, **kw):
        out = orig(*a, **kw)
        log.append((a, kw, out))
        return out
    setattr(module, name, rec)
    try:
        yield log
    finally:
        setattr(module, name, orig)


def _block(mesh, x, spec):
    """This rank's block of ``x``, a tensor of its own (the scenarios update
    caches in place, and a job's inputs may share storage)."""
    from repro_torch.distributed import sharding as shd
    return shd.local_shard(x, spec, mesh).clone(
        memory_format=torch.contiguous_format)


def compressed(mesh, x, planes):
    """``make_compressed_allreduce`` over 'data' on this rank's row block
    of ``x`` (n, N): the output, the residual, what each all-gather put on
    the wire (exponent, packed planes), and the wire bytes against a plain
    psum of the same block."""
    from repro_torch.distributed import grad_compress as gc
    from repro_torch.distributed import sharding as shd
    blk = _block(mesh, x, ("data", None))
    f = gc.make_compressed_allreduce(mesh, "data", planes)
    shd.WIRE.reset()
    with _recording(shd, "all_gather", []) as sent:
        out, res = f(blk)
    comp = shd.WIRE.snapshot()
    shd.WIRE.reset()
    with shd.use_mesh(mesh):
        plain = shd.psum(blk, "data") / mesh.size("data")
    plain_w = shd.WIRE.snapshot()
    e, packed = sent[0][0][0], sent[1][0][0]
    ef_q, _ = gc.ef_quantize(plain, torch.zeros_like(plain), planes)
    return {"out": out, "residual": res, "e": e, "packed": packed,
            "plain": plain, "ef_q": ef_q,
            "wire": torch.tensor([sum(v for k, v in comp.items()
                                      if k.endswith("_bytes")),
                                  plain_w["all_reduce_bytes"]])}


def seqshard(mesh, q, k_cache, v_cache, k_new, v_new, index, batch_axes,
             ks_cache=None, vs_cache=None, ks_new=None, vs_new=None):
    """``seqshard_decode_gqa`` (or ``_int8`` with the scales) on this rank's
    shards: caches (batch over ``batch_axes``, L over 'model'), q and the
    new entries over ``batch_axes``; and, on one device, the same call's
    plain counterpart (``decode_attention`` over the whole cache)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as L
    b_ax = tuple(batch_axes) or None
    cspec, sspec = (b_ax, "model", None, None), (b_ax, "model", None)
    qspec = (b_ax, None, None, None)
    args = [_block(mesh, q, qspec), _block(mesh, k_cache, cspec),
            _block(mesh, v_cache, cspec)]
    with shd.use_mesh(mesh):
        if ks_cache is None:
            out, kc, vc = L.seqshard_decode_gqa(
                *args, _block(mesh, k_new, qspec), _block(mesh, v_new, qspec),
                int(index))
            res = {"out": out, "k": kc, "v": vc}
        else:
            out, kc, vc, ksc, vsc = L.seqshard_decode_gqa_int8(
                *args, _block(mesh, ks_cache, sspec),
                _block(mesh, vs_cache, sspec), _block(mesh, k_new, qspec),
                _block(mesh, v_new, qspec), _block(mesh, ks_new, qspec[:3]),
                _block(mesh, vs_new, qspec[:3]), int(index))
            res = {"out": out, "k": kc, "v": vc, "ks": ksc, "vs": vsc}
    # one device: the plain decode over the whole updated cache
    i = int(index)
    k_all, v_all = k_cache.clone(), v_cache.clone()
    k_all[:, i], v_all[:, i] = k_new[:, 0], v_new[:, 0]
    scales = None
    if ks_cache is not None:
        ks_all, vs_all = ks_cache.clone(), vs_cache.clone()
        ks_all[:, i], vs_all[:, i] = ks_new[:, 0], vs_new[:, 0]
        scales = (ks_all, vs_all)
    res["one_device"] = _block(mesh, L.decode_attention(
        q, k_all, v_all, i + 1, kv_scales=scales), qspec)
    return res


def mla_seqshard(mesh, params, x, ckv, kr, index, cfg_kw):
    """``mla_apply``'s absorbed decode with ``seq_shard_decode`` on this
    rank's cache shards (L over 'model'), and on one device without."""
    import dataclasses as dc
    from repro_torch.configs.base import MLAConfig, ModelConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as L
    kw = dict(cfg_kw)
    kw["mla"] = MLAConfig(**kw["mla"])
    cfg = ModelConfig(**kw)
    i = int(index)
    pos = torch.full((x.shape[0], 1), i, dtype=torch.int32, device=x.device)
    cache = {"ckv": _block(mesh, ckv, (None, "model", None)),
             "kr": _block(mesh, kr, (None, "model", None))}
    with shd.use_mesh(mesh):
        y, cache = L.mla_apply(params, x, dc.replace(cfg, seq_shard_decode=True),
                               pos, cache=cache, cache_index=i)
    whole = {"ckv": ckv.clone(), "kr": kr.clone()}
    y1, whole = L.mla_apply(params, x, cfg, pos, cache=whole, cache_index=i)
    return {"y": y, "ckv": cache["ckv"], "kr": cache["kr"], "y_one": y1,
            "ckv_one": _block(mesh, whole["ckv"], (None, "model", None))}


def _moe_cfg(cfg_kw):
    from repro_torch.configs.base import ModelConfig, MoEConfig
    kw = dict(cfg_kw)
    kw["moe"] = MoEConfig(**kw["moe"])
    return ModelConfig(**kw)


def moe(mesh, params, x, cot, cfg_kw):
    """``moe_apply`` on this rank's shard of the batch (over the
    data-parallel axes): the output, the aux loss, each assignment's
    (slot, kept) as the dispatch saw them, and the gradient of
    ``sum(out * cot) + aux / n_dp`` summed over the data-parallel ranks
    (the reference's gradient of ``sum(out * cot) + aux``); and on one
    device the capacity dispatch of the whole batch."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe as M
    from repro_torch.train.step import value_and_grad
    cfg = _moe_cfg(cfg_kw)
    spec = (("data",), None, None)
    x_l, cot_l = _block(mesh, x, spec), _block(mesh, cot, spec)
    n_dp = mesh.size("data")
    seen = []

    def f(p):
        out, aux = M.moe_apply(p, x_l, cfg)
        seen.append((out.detach(), aux.detach()))
        return torch.sum(out * cot_l) + aux / n_dp
    with shd.use_mesh(mesh), _recording(M, "_shard_assignments", []) as asg:
        _, grads = value_and_grad(f, params)
        grads = {k: shd.psum(g, "data") for k, g in grads.items()
                 if not isinstance(g, dict)}
    out, aux = seen[0]
    slot, kept = asg[0][2]
    # one device: the capacity dispatch of this data-parallel shard's tokens
    # (the shard_map dispatch's capacity is the shard's)
    one, _ = M.moe_apply(params, x_l, cfg)
    res = {"out": out, "aux": aux, "slot": slot, "kept": kept,
           "one_device": one, **{f"grad.{k}": g for k, g in grads.items()}}
    if n_dp == 1:     # and its gradient, of the whole batch
        _, g1 = value_and_grad(lambda p: torch.sum(
            M.moe_apply(p, x, cfg)[0] * cot) + M.moe_apply(p, x, cfg)[1],
            params)
        res.update({f"grad_one.{k}": g1[k] for k in grads})
    return res


def train_step(mesh, arch, params, batch, batch_axes, n_micro=1,
               dispatch=None):
    """One ``make_train_step`` step under the mesh (the global batch given
    to every rank): the loss and the gradients it gave AdamW, and the new
    parameters; with ``mesh`` None, the same step on one device."""
    import dataclasses as dc
    from repro_torch.configs.base import smoke_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.policy import CellPolicy
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train import step as st
    cfg = smoke_config(arch)
    if dispatch:
        cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, dispatch=dispatch))
    dev = next(iter(tree_leaves(params))).device
    model = Model(cfg, params, device=dev)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    policy = CellPolicy(tuple(batch_axes), int(n_micro), "float32",
                        batch["labels"].shape[1])
    fn = st.make_train_step(model, opt_cfg, policy)
    opt = adamw.init(model.params, opt_cfg)
    with _recording(adamw, "update", []) as upd, (
            shd.use_mesh(mesh) if mesh is not None
            else contextlib.nullcontext()):
        p2, _, metrics = fn(model.params, opt, batch)
    grads = upd[0][0][0]
    out = {"loss": metrics["loss"].reshape(1),
           "grad_norm": metrics["grad_norm"].reshape(1)}
    for name, g in _named(grads):
        out[f"grad.{name}"] = g
    for name, p in _named(p2):
        out[f"param.{name}"] = p
    return out


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def ckpt_save(mesh, params, root):
    """Each rank's blocks of ``params`` under the model's specs, saved
    under the mesh with those specs."""
    from repro_torch.ckpt import manager as ck
    from repro_torch.distributed import sharding as shd
    _, named = _specs_of(mesh, params)
    local = _local_tree(params, named)
    with shd.use_mesh(mesh):
        ck.save(root, 1, local, device=_dev(params), shardings=named)
    return {}


def ckpt_load(mesh, params, root):
    """Each rank's blocks restored from ``root`` with ``load(shardings=)``,
    and the same blocks cut from the whole ``params``."""
    from repro_torch.ckpt import manager as ck
    from repro_torch.distributed import sharding as shd
    model, named = _specs_of(mesh, params)
    with shd.use_mesh(mesh):
        got, _ = ck.load(root, 1, model.shape_structs(), device=_dev(params),
                         shardings=named)
    want = _local_tree(params, named)
    out = {}
    for (name, g), (_, w) in zip(_named(got), _named(want)):
        out[f"got.{name}"], out[f"want.{name}"] = g, w
    return out


def _dev(tree):
    return next(t for _, t in _named(tree)).device


def _specs_of(mesh, params):
    from repro_torch.configs.base import smoke_config
    from repro_torch.launch.policy import CellPolicy
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.step import train_shardings
    model = Model(smoke_config("qwen2-7b"), params, device=_dev(params))
    named, _ = train_shardings(model, CellPolicy(("data",), 1, "float32", 1),
                               mesh, adamw.AdamWConfig())
    return model, named


def _local_tree(tree, named):
    from repro_torch.distributed import sharding as shd
    if isinstance(tree, dict):
        return {k: _local_tree(tree[k], named[k]) for k in tree}
    return shd.local_shard(tree, named.spec, named.mesh).contiguous()


# ------------------------------------------- sharded parameter storage --

def _whole_arange(tree, offset=0):
    """Each leaf of ``tree`` replaced by the int64 row-major indices of its
    elements (plus ``offset``): a block of it says where it was cut."""
    if isinstance(tree, dict):
        return {k: _whole_arange(v, offset) for k, v in tree.items()}
    return (torch.arange(tree.numel(), dtype=torch.int64, device=tree.device)
            .reshape(tree.shape) + offset)


def _fingerprint(block):
    """(first element, sum, shape...) of an index block."""
    first = block.reshape(-1)[0] if block.numel() else torch.tensor(-1)
    return torch.tensor([int(first), int(block.sum())] + list(block.shape))


def fsdp_placement(mesh, arch):
    """``shard_tree`` of an arch's SMOKE parameters and AdamW state under
    ``train_shardings``: each leaf's block of an index tensor (its first
    index, sum and shape), and the bytes this rank stores against each
    leaf's bytes over the product of its spec's axis sizes."""
    import math
    from repro_torch.configs.base import smoke_config
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.policy import CellPolicy
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.step import train_shardings
    dev = _mesh_device(mesh)
    model = Model(smoke_config(arch), device=dev, seed=0)
    opt_cfg = adamw.AdamWConfig()
    p_named, o_named = train_shardings(
        model, CellPolicy(("data",), 1, "float32", 16), mesh, opt_cfg)
    params = model.params
    opt = adamw.init(params, opt_cfg)
    stored = fsdp.stored_bytes(shd.shard_tree(params, p_named)) \
        + fsdp.stored_bytes(shd.shard_tree(opt, o_named))
    want = 0
    for t, n in zip(_named(params), _named(p_named)):
        cut = math.prod(mesh.shape[a] for e in n[1].spec
                        for a in mesh.axes(shd._dim_axes(e)))
        want += 3 * t[1].numel() * t[1].element_size() // cut
    want += opt.step.numel() * opt.step.element_size()
    idx = adamw.AdamWState(step=torch.zeros((), dtype=torch.int64),
                           m=_whole_arange(params),
                           v=_whole_arange(params, 7))
    pb = shd.shard_tree(_whole_arange(params), p_named)
    ob = shd.shard_tree(idx, o_named)
    out = {"stored": torch.tensor([stored, want])}
    for name, b in _named(pb):
        out[f"param.{name}"] = _fingerprint(b)
    for name, b in _named(ob.m):
        out[f"m.{name}"] = _fingerprint(b)
    for name, b in _named(ob.v):
        out[f"v.{name}"] = _fingerprint(b - 7)
    return out


def _mesh_device(mesh):
    return "cpu" if mesh.device_type == "cpu" else \
        f"cuda:{torch.cuda.current_device()}"


def _cfg_of(arch, overrides=None, dispatch=None):
    """``arch``'s SMOKE config with ``overrides`` (fields; ``moe`` and
    ``mla`` as dicts of their own fields) and the MoE ``dispatch``."""
    import dataclasses as dc
    from repro_torch.configs.base import smoke_config
    cfg = smoke_config(arch)
    kw = dict(overrides or {})
    for k in ("moe", "mla"):
        if k in kw:
            kw[k] = dc.replace(getattr(cfg, k), **kw[k])
    if dispatch:
        kw["moe"] = dc.replace(kw.get("moe", cfg.moe), dispatch=dispatch)
    return dc.replace(cfg, **kw)


def fsdp_train(mesh, arch, params, batch, batch_axes, n_micro=1,
               dispatch=None, gathered=False, overrides=None,
               float64=False):
    """One ``make_train_step`` step with ``shardings=`` on this rank's
    blocks, and the whole-tree step (no ``shardings``) under the same mesh
    cut to the same blocks: loss, grad norm, the gradient blocks handed to
    AdamW, the parameter blocks before and after, AdamW m and v, the bytes
    stored and ``WIRE``'s counts, and the norm of the sharded step's own
    gradient gathered whole; with ``gathered``, that gradient itself.
    ``overrides``: ``_cfg_of``'s.  ``float64``: the parameters and the
    compute in float64 (AdamW's state stays float32), so that a sum taken
    in another order rounds far below float32's ulp."""
    import dataclasses as dc
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.policy import CellPolicy
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_map
    from repro_torch.optim import adamw
    from repro_torch.train import step as st
    cfg = _cfg_of(arch, overrides, dispatch)
    if float64:
        cfg = dc.replace(cfg, param_dtype="float64", compute_dtype="float64")
        params = tree_map(lambda t: t.double(), params)
    model = Model(cfg, params, device=_dev(params))
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    policy = CellPolicy(tuple(batch_axes), int(n_micro), "float32",
                        batch["labels"].shape[1])
    named = st.train_shardings(model, policy, mesh, opt_cfg)
    opt = adamw.init(model.params, opt_cfg)
    with _recording(adamw, "update", []) as upd, shd.use_mesh(mesh):
        p1, o1, m1 = st.make_train_step(model, opt_cfg, policy)(
            model.params, opt, batch)
    g1 = upd[0][0][0]
    blocks = shd.shard_tree(model.params, named[0])
    oblocks = shd.shard_tree(opt, named[1])
    stored = fsdp.stored_bytes(blocks) + fsdp.stored_bytes(oblocks)
    fn = st.make_train_step(model, opt_cfg, policy, named)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t
    shd.WIRE.reset()
    with _recording(adamw, "update", []) as upd, \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        p2, o2, m2 = fn(blocks, oblocks, batch)
    wire = shd.WIRE.snapshot()
    g2 = upd[0][0][0]
    with shd.use_mesh(mesh):
        own = adamw.global_norm(shd.gather_tree(g2, named[0]))
    out = {"loss": torch.stack([m1["loss"], m2["loss"]]).reshape(2),
           "grad_norm": torch.stack([m1["grad_norm"], m2["grad_norm"]]),
           "own_norm": own.reshape(1),
           "stored": torch.tensor([stored]),
           "wire": torch.tensor([wire[k] for k in sorted(wire)]),
           "wire_keys": sorted(wire), "saved_shapes": saved}
    cut = lambda t, n: shd.local_shard(t, n.spec, n.mesh)  # noqa: E731
    for name, x in _named(blocks):
        out[f"start.{name}"] = x
    for tag, a, b in (("grad", g2, g1), ("param", p2, p1),
                      ("m", o2.m, o1.m), ("v", o2.v, o1.v)):
        for (name, x), (_, y), (_, n) in zip(_named(a), _named(b),
                                             _named(named[0])):
            out[f"{tag}.{name}"] = x
            out[f"whole_{tag}.{name}"] = cut(y, n)
    if gathered:
        for name, g in _named(shd.gather_tree(g2, named[0])):
            out[f"gathered.{name}"] = g
    return out


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize()


def _serve(model, params, prompts, n_new, max_len, mesh, policy, shardings,
           forced=None):
    """Greedy tokens and last-position logits of a prefill and ``n_new - 1``
    decode steps, under ``mesh`` with the caches cut by
    ``cache_shardings``, and the prefill's seconds and a decode step's ms;
    with ``forced`` (B, n_new), each step reads those tokens instead of
    its own (teacher forcing)."""
    import time
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import step as st
    prefill = st.make_prefill_step(model, shardings)
    decode = st.make_decode_step(model, shardings)
    with torch.inference_mode(), shd.use_mesh(mesh), \
            shd.use_batch_axes(policy.batch_axes):
        _sync(prompts)
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompts}, max_len)
        cache = shd.shard_tree(cache, st.cache_shardings(cache, policy,
                                                         mesh))
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        _sync(prompts)
        prefill_s = time.perf_counter() - t0
        toks, steps = [tok], [logits[:, -1]]
        t0 = time.perf_counter()
        for i in range(n_new - 1):
            feed = tok if forced is None else forced[:, i:i + 1]
            logits, cache = decode(params, cache, prompts.shape[1] + i,
                                   {"tokens": feed})
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            toks.append(tok)
            steps.append(logits[:, -1])
        _sync(prompts)
        ms = (time.perf_counter() - t0) * 1e3 / max(n_new - 1, 1)
    return torch.cat(toks, 1), torch.stack(steps, 1), prefill_s, ms


def fsdp_serve(mesh, arch, params, prompts, n_new, drop_fsdp=False,
               seq_shard=False, overrides=None):
    """Prefill and greedy decode from this rank's blocks under
    ``param_shardings(drop_fsdp)`` and from the whole tree, on the same
    mesh (with ``seq_shard``, the flash decode over a cache whose L axis
    is cut over 'model'): tokens and logits of both, the gathers' wire
    bytes, ``WIRE``'s counts and the bytes stored."""
    import dataclasses as dc
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.policy import CellPolicy
    from repro_torch.models.model import Model
    from repro_torch.train import step as st
    cfg = dc.replace(_cfg_of(arch, overrides),
                     seq_shard_decode=bool(seq_shard))
    model = Model(cfg, params, device=_dev(params))
    max_len = prompts.shape[1] + int(n_new)
    policy = CellPolicy((), 1, "float32", max_len, seq_shard=bool(seq_shard))
    named = st.param_shardings(model, mesh, bool(drop_fsdp))
    blocks = shd.shard_tree(model.params, named)
    whole = _serve(model, model.params, prompts, int(n_new), max_len, mesh,
                   policy, None)[:2]
    shd.WIRE.reset()
    got = _serve(model, blocks, prompts, int(n_new), max_len, mesh, policy,
                 named)[:2]
    wire = shd.WIRE.snapshot()
    return {"tokens": got[0], "logits": got[1], "whole_tokens": whole[0],
            "whole_logits": whole[1],
            "gather_bytes": torch.tensor([shd.WIRE.param_gather_bytes]),
            "wire": torch.tensor([wire[k] for k in sorted(wire)]),
            "wire_keys": sorted(wire),
            "stored": torch.tensor([fsdp.stored_bytes(blocks)])}


def fsdp_ckpt_order(mesh, params, root):
    """``ckpt.manager.save`` of this rank's blocks under the mesh, with the
    order of its gathers and writes recorded (1 + leaf index for a gather,
    -(1 + leaf index) for a write); rank 0 also saves the whole tree
    without a mesh into ``root``/plain."""
    import os
    from repro_torch.ckpt import manager as ck
    from repro_torch.distributed import sharding as shd
    _, named = _specs_of(mesh, params)
    local = _local_tree(params, named)
    names, _ = ck._flatten(local)
    log = []
    gather, write = shd.gather_shard, ck._write_leaf

    def g(x, *a, **kw):
        log.append(1 + len([e for e in log if e > 0]))
        return gather(x, *a, **kw)

    def w(tmp, name, *a, **kw):
        log.append(-(1 + names.index(name)))
        return write(tmp, name, *a, **kw)
    shd.gather_shard, ck._write_leaf = g, w
    try:
        with shd.use_mesh(mesh):
            ck.save(os.path.join(root, "mesh"), 1, local, device=_dev(params),
                    shardings=named)
    finally:
        shd.gather_shard, ck._write_leaf = gather, write
    if mesh.rank == 0:
        ck.save(os.path.join(root, "plain"), 1, params, device=_dev(params))
    return {"log": torch.tensor(log), "n_leaves": torch.tensor([len(names)])}


def _memory_at_peak(snap, base: int, top: int = 12):
    """The peak of allocated bytes over the allocation history of a
    ``torch.cuda.memory._snapshot()`` recorded from a moment when
    ``base`` bytes were allocated, and the allocations live at that peak,
    grouped by the innermost frame of ``repro_torch`` that made them:
    (peak bytes, [(bytes, count, where), ...] largest first).  A block
    counts as freed at ``free_requested``, where the allocator's
    ``allocated_bytes`` drops (its reuse may wait for another stream)."""
    trace = snap["device_traces"][torch.cuda.current_device()]
    cur, peak, at = base, base, -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            cur += e["size"]
        elif e["action"] == "free_requested":   # blocks from before too
            cur -= e["size"]
        if cur > peak:
            peak, at = cur, i
    live, groups, gone = {}, {}, 0
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_requested":
            if live.pop(e["addr"], None) is None:
                gone += e["size"]
    for e in live.values():
        frames = [f for f in e.get("frames", ())
                  if "repro_torch" in f["filename"]]
        where = (f"{os.path.basename(frames[0]['filename'])}:"
                 f"{frames[0]['line']} {frames[0]['name']}" if frames
                 else "(outside repro_torch)")
        b, c = groups.get(where, (0, 0))
        groups[where] = (b + e["size"], c + 1)
    rows = sorted(((b, c, w) for w, (b, c) in groups.items()), reverse=True)
    return peak, [(base - gone, 0, "(allocated before the step, still "
                                   "live)")] + rows[:top]


def _nudged(t, seed: int = 0):
    """``t`` rounded to bfloat16 with every value moved one bfloat16 ulp up
    or down at random (from ``seed``; zeros kept), in ``t``'s dtype: a
    rounding-sized change of an input, to measure how far rounding alone
    moves a model's outputs."""
    b = t.to(torch.bfloat16)
    gen = torch.Generator(device=t.device).manual_seed(seed)
    step = torch.randint(0, 2, b.shape, generator=gen, device=t.device,
                         dtype=torch.int16) * 2 - 1
    moved = (b.view(torch.int16) + step).view(torch.bfloat16)
    return torch.where(b == 0, b, moved).to(t.dtype)


def _write_snapshot(snap, path, limit=48 << 20):
    """``snap`` gzipped to ``path``, removed again if it is over ``limit``
    bytes (a note of its size is left beside it instead)."""
    import gzip
    import pickle
    with gzip.open(path + ".gz", "wb") as f:
        pickle.dump(snap, f)
    size = os.path.getsize(path + ".gz")
    if size > limit:
        os.remove(path + ".gz")
        with open(path + ".too_large.txt", "w") as f:
            f.write(f"the gzipped snapshot took {size} B\n")


def _all_reduce_ms(mesh, lead, widths, reps: int = 10):
    """The device time of one all-reduce over 'model' of a bfloat16
    (*lead, width) tensor for each of ``widths``, by CUDA events over
    ``reps`` calls after a warm-up: the collectives of the
    tensor-parallel step, timed alone."""
    from repro_torch.distributed import sharding as shd
    dev = _mesh_device(mesh)
    times = []
    for width in widths:
        x = torch.zeros(*lead, width, dtype=torch.bfloat16, device=dev)
        for _ in range(3):
            shd.psum(x, "model", mesh)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            shd.psum(x, "model", mesh)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return torch.tensor(times, dtype=torch.float64)


def fsdp_danube(mesh, layers, steps, global_batch, seq, one_card,
                snapshot=None, compute_dtype=None, arch="h2o-danube-3-4b",
                overrides=None, unstacked=False):
    """h2o-danube-3-4b (or ``arch``, its config's fields ``overrides``
    replaced, its stacked weights rescaled by ``unstack_fan_in``
    with ``unstacked``) at its published widths, cut to ``layers``, trained
    ``steps`` steps from this rank's blocks under ``train_shardings`` on
    ``mesh`` with phase 14's settings of ``chip_smoke.py`` (AdamW lr 3e-4,
    warmup 1, bf16 compute, remat, float32 parameters and state), the
    global batch ``global_batch`` x ``seq`` (the same batch every step) cut
    over 'data'.  Returns each step's loss, grad norm and wall, the
    collectives' wire bytes of a step, this rank's peak device memory over
    the steps and over the set-up before them, its stored bytes, and the whole state's bytes by count (parameters,
    gradients, AdamW m and v in float32).  With ``one_card``: step 1
    against the one-card whole-tree step over ``world`` microbatches (the
    ranks' shapes): the loss, each gradient block's largest difference and
    largest value, and whether the new parameter, m and v blocks are
    bit-identical.  Without it: the mean of the one-card forward losses of
    the batch's sequences (no_grad), and again with the embedding moved one
    bfloat16 ulp at random (``_nudged``: how far rounding alone moves that
    loss).  The last step
    runs with the allocator's history recorded: the peak it reconstructs
    and the allocations live there (``_memory_at_peak``), and with
    ``snapshot`` (a path) rank 0 writes the snapshot there as a pickle.
    Under a mesh where 'model' does not cut the batch (('data',) is the
    policy's batch axes) the step computes over 'model' on the blocks
    (``distributed/tp.py``); with 'model' of more than one rank, the time
    of one all-reduce over it of an activation and of a K (or V) alone
    (``_all_reduce_ms``).  ``compute_dtype``: in place of bfloat16."""
    import dataclasses as dc
    import time
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.policy import CellPolicy
    from repro_torch.models.model import Model, count_params
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    from repro_torch.train import step as st
    dev = _mesh_device(mesh)
    cfg = dc.replace(get_config(arch), n_layers=int(layers),
                     **(overrides or {}))
    if compute_dtype:
        cfg = dc.replace(cfg, compute_dtype=compute_dtype)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=1,
                                total_steps=int(steps))
    policy = CellPolicy(("data",), 1, "float32", int(seq))
    batch = loop.synthetic_data(cfg, int(global_batch), int(seq), seed=1,
                                device=dev)(0)
    n = mesh.size(("data",))
    model = Model(cfg, device=dev, seed=0)
    if unstacked:
        unstack_fan_in(model.params)
    named = st.train_shardings(model, policy, mesh, opt_cfg)
    out = {}
    if one_card:
        fn = st.make_train_step(model, opt_cfg, CellPolicy((), n, "float32",
                                                           int(seq)))
        opt = adamw.init(model.params, opt_cfg)
        with _recording(adamw, "update", []) as upd:
            p1, o1, m1 = fn(model.params, opt, batch)
        cut = lambda t, nm: shd.local_shard(t, nm.spec, nm.mesh)  # noqa
        want = {"grad": shd.map_named(cut, upd[0][0][0], named[0]),
                "param": shd.map_named(cut, p1, named[0]),
                "m": shd.map_named(cut, o1.m, named[0]),
                "v": shd.map_named(cut, o1.v, named[0])}
        del opt, upd
        out["one_card_loss"] = m1["loss"].reshape(1)
    else:
        def forward(tree):
            with torch.no_grad():
                return torch.stack([model.loss(tree, {
                    k: v[i:i + 1] for k, v in batch.items()}).double()
                    for i in range(int(global_batch))]).mean().reshape(1)
        out["forward_loss"] = forward(None)
        out["forward_loss_ulp"] = forward(dict(
            model.params, embed=_nudged(model.params["embed"])))
    blocks = shd.shard_tree(model.params, named[0])
    model = Model(cfg, blocks, device=dev)      # the whole tree is freed
    # the step reads the blocks it is given: the model's own parameters
    # would keep step 0's blocks alive through every step
    for p in model.parameters():
        p.data = p.data.new_empty(0)
    opt = adamw.init(blocks, opt_cfg)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn = st.make_train_step(model, opt_cfg, policy, named)
    losses, norms, walls, wire = [], [], [], []
    for s in range(int(steps)):
        last = s == int(steps) - 1
        shd.WIRE.reset()
        dist.barrier()
        torch.cuda.synchronize()
        if last:
            base = torch.cuda.memory_allocated()
            torch.cuda.memory._record_memory_history(
                max_entries=2_000_000, stacks="python")
        t0 = time.perf_counter()
        with _recording(adamw, "update", []) as upd:
            blocks, opt, m = fn(blocks, opt, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if last:
            snap = torch.cuda.memory._snapshot()
            torch.cuda.memory._record_memory_history(enabled=None)
            out["snapshot_peak"], out["snapshot_rows"] = _memory_at_peak(
                snap, base)
            if snapshot and mesh.rank == 0:
                _write_snapshot(snap, snapshot)
            del snap
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        w = shd.WIRE.snapshot()
        wire.append([w[k] for k in sorted(w)])
        if one_card and s == 0:
            got = {"grad": upd[0][0][0], "param": blocks, "m": opt.m,
                   "v": opt.v}
            rows = []
            for tag in ("grad", "param", "m", "v"):
                for (name, a), (_, b) in zip(_named(got[tag]),
                                             _named(want[tag])):
                    d = (a.double() - b.double()).abs().max().item()
                    rows.append([("grad", "param", "m", "v").index(tag), d,
                                 b.double().abs().max().item(),
                                 float(torch.equal(a.view(torch.int32),
                                                   b.view(torch.int32)))])
            out["compare"] = torch.tensor(rows, dtype=torch.float64)
            del want, got
        del upd
    if mesh.shape["model"] > 1:
        out["all_reduce_ms"] = _all_reduce_ms(
            mesh, (int(global_batch) // n, int(seq)),
            (cfg.d_model, cfg.n_kv_heads * cfg.head_dim))
    n_params = count_params(cfg)
    out.update({
        "loss": torch.tensor(losses, dtype=torch.float64),
        "grad_norm": torch.tensor(norms, dtype=torch.float64),
        "wall": torch.tensor(walls, dtype=torch.float64),
        "wire": torch.tensor(wire, dtype=torch.float64),
        "wire_keys": sorted(shd.WIRE.snapshot()),
        "peak": torch.tensor([torch.cuda.max_memory_allocated(), init_peak]),
        "stored": torch.tensor([fsdp.stored_bytes(blocks)
                                + fsdp.stored_bytes(opt)]),
        "whole_state": torch.tensor([4 * 4 * n_params, n_params])})
    return out


# ------------------------------------- tensor-parallel compute, 'model' --

def _layer_cfg(cfg_kw):
    from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                          SSMConfig)
    kw = dict(cfg_kw)
    for k, cls in (("moe", MoEConfig), ("mla", MLAConfig), ("ssm", SSMConfig)):
        if kw.get(k) is not None:
            kw[k] = cls(**kw[k])
    return ModelConfig(**kw)


def tp_layer(mesh, module, params, x, cot, cfg_kw, leave_only=False):
    """One layer ``module`` ('gqa', 'mla', 'mlp', 'moe', 'cmix' or
    'mamba') of the config ``cfg_kw`` under the mesh, its batch cut over
    'data' alone (of one rank), on the whole ``params`` and, under ``tp``,
    on this rank's blocks of the leaves its specs cut over 'model'
    (``local_shard``): both outputs, and the gradients of ``sum(out *
    cot)`` (plus the MoE's aux loss) with respect to ``x`` and every leaf,
    the blocks' beside the whole gradient's own block; ``WIRE``'s counts
    of the block run.  ``leave_only``: the block run with ``tp.summed``
    replaced by ``tp.leave`` (a sum all-reduced forward only, the fault
    the gradient test must catch)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tp as TP
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import ssm as SSM
    from repro_torch.models.params import tree_map, tree_partition_specs
    from repro_torch.train.step import value_and_grad
    cfg = _layer_cfg(cfg_kw)
    pos = torch.arange(x.shape[1], device=x.device)[None].expand(
        x.shape[0], -1)
    abstract, fn = {
        "gqa": (L.gqa_abstract,
                lambda p, h, tp: L.gqa_apply(p, h, cfg, pos, tp=tp)[0]),
        "mla": (L.mla_abstract,
                lambda p, h, tp: L.mla_apply(p, h, cfg, pos, tp=tp)[0]),
        "mlp": (L.mlp_abstract, lambda p, h, tp: L.mlp_apply(p, h, cfg, tp)),
        "moe": (MOE.moe_abstract, lambda p, h, tp: MOE.moe_apply(p, h, cfg,
                                                                  tp)),
        "cmix": (SSM.rwkv_channel_mix_abstract,
                 lambda p, h, tp: SSM.rwkv_channel_mix_apply(p, h, cfg,
                                                             tp=tp)[0]),
        "mamba": (SSM.mamba_abstract,
                  lambda p, h, tp: SSM.mamba_apply(p, h, cfg, tp=tp)[0]),
    }[module]
    with shd.use_mesh(mesh):
        named = tree_map(lambda sp: shd.Named(mesh, sp),
                         tree_partition_specs(abstract(cfg), drop_fsdp=True))
    blocks = shd.shard_tree(params, named)

    def run(p, tp):
        def loss(t):
            y = fn(t["p"], t["x"], tp)
            out.append(y)
            if isinstance(y, tuple):
                return torch.sum(y[0] * cot) + y[1]
            return torch.sum(y * cot)
        out = []
        with shd.use_mesh(mesh), shd.use_batch_axes(("data",)):
            _, g = value_and_grad(loss, {"p": p, "x": x})
        y = out[0]
        return (y[0] if isinstance(y, tuple) else y).detach(), g
    y_whole, g_whole = run(params, None)
    summed = TP.summed
    if leave_only:
        TP.summed = TP.leave
    shd.WIRE.reset()
    try:
        y_tp, g_tp = run(blocks, mesh)
    finally:
        TP.summed = summed
    wire = shd.WIRE.snapshot()
    res = {"out": y_tp, "whole_out": y_whole, "grad_x": g_tp["x"],
           "whole_grad_x": g_whole["x"],
           "wire": torch.tensor([wire[k] for k in sorted(wire)]),
           "wire_keys": sorted(wire)}
    cut = shd.map_named(lambda t, n: shd.local_shard(t, n.spec, n.mesh),
                        g_whole["p"], named)
    for (name, a), (_, b) in zip(_named(g_tp["p"]), _named(cut)):
        res[f"grad.{name}"], res[f"whole_grad.{name}"] = a, b
    return res


def tp_recut(mesh, w, cot):
    """``tp.recut`` of this rank's block (``local_shard`` over 'model' of
    dim 1) of the whole ``w`` (d, 2 x din), and the gradient that its
    backward hands the block for the cotangent ``cot`` (d, 2 x din, whole;
    this rank's channels of its ``x`` and ``z`` halves taken); and the
    same two from the whole leaves by slicing."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tp as TP
    block = shd.local_shard(w, (None, "model"), mesh).clone()
    block.requires_grad_(True)
    din = w.shape[1] // 2

    def mine(t):
        return torch.cat([TP.own(t[:, :din], 1, mesh),
                          TP.own(t[:, din:], 1, mesh)], 1)
    shd.WIRE.reset()
    got = TP.recut(block, mesh)
    (g,) = torch.autograd.grad(got, block, mine(cot))
    wire = shd.WIRE.snapshot()
    return {"got": got.detach(), "want": mine(w), "grad": g,
            "want_grad": shd.local_shard(cot, (None, "model"), mesh),
            "wire": torch.tensor([wire[k] for k in sorted(wire)]),
            "wire_keys": sorted(wire)}


def dryrun_real(mesh, spec, scan_ops=True):
    """``launch.dryrun.measure`` of the cell ``spec`` on this rank of a real
    world (the model's weights, real tensors), the counterpart of the dry
    run's fake world: argument bytes, temp bytes, FLOPs, HBM bytes and
    ``WIRE`` by kind with the largest calls.  With ``scan_ops`` the SSM
    scans and AdamW's update run as their operators (``kernels.scan``,
    ``kernels.optim``; their plain versions on the CPU), as the fake
    world's ``meta`` tensors run them; else as the CPU's loop and
    ``adamw._upd``."""
    from repro_torch.kernels import optim as kopt
    from repro_torch.launch import dryrun
    from repro_torch.models import ssm
    on_operators = ssm._on_operators, kopt._on_operators
    if scan_ops:
        ssm._on_operators = kopt._on_operators = lambda t: True
    try:
        rec = dryrun.measure(spec, mesh, fake=False)
    finally:
        ssm._on_operators, kopt._on_operators = on_operators
    return {k: rec[k] for k in ("memory", "flops_per_device", "flops_by_op",
                                "hbm_bytes_per_device", "ops_by_name",
                                "collectives",
                                "policy")}


def danube_serve(mesh, layers, batch, prompt, n_new, compute_dtype=None,
                 arch="h2o-danube-3-4b", overrides=None, unstacked=False):
    """h2o-danube-3-4b (or ``arch``, its config's fields ``overrides``
    replaced, its stacked weights rescaled by ``unstack_fan_in``
    with ``unstacked``) at its published widths cut to ``layers`` (and with
    ``compute_dtype``, else bfloat16), its weights (seed 0) held in the
    compute dtype, greedy-served (``batch`` prompts of ``prompt`` tokens,
    ``n_new`` new tokens) on this rank's card alone from the whole tree,
    and under the mesh from this rank's blocks under
    ``param_shardings(drop_fsdp=True)``, teacher-forced with the one-card
    tokens: the tokens and logits of both, the prefill seconds and decode
    ms/token of both, the peak device memory of the block run, the bytes a
    rank stores and ``WIRE`` by kind over the block run; and the one-card
    logits, teacher-forced alike, with the embedding moved one bfloat16
    ulp at random (``_nudged``: how far rounding alone moves them)."""
    import dataclasses as dc
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.driver import build_inputs
    from repro_torch.launch.policy import CellPolicy
    from repro_torch.models.model import Model
    from repro_torch.train import step as st
    dev = _mesh_device(mesh)
    cfg = dc.replace(get_config(arch), n_layers=int(layers),
                     **(overrides or {}))
    if compute_dtype:
        cfg = dc.replace(cfg, compute_dtype=compute_dtype)
    model = Model(cfg, device=dev, seed=0)
    if unstacked:
        unstack_fan_in(model.params)
    held = model.compute_params()
    model = Model(cfg, held, device=dev)
    prompts, _ = build_inputs(cfg, int(batch), int(prompt), device=dev)
    max_len = int(prompt) + int(n_new)
    policy = CellPolicy((), 1, "float32", max_len)
    one = _serve(model, held, prompts, int(n_new), max_len, mesh, policy,
                 None)
    ulp = _serve(model, dict(held, embed=_nudged(held["embed"])), prompts,
                 int(n_new), max_len, mesh, policy, None,
                 forced=one[0][:, :-1])
    named = st.param_shardings(model, mesh, drop_fsdp=True)
    blocks = shd.shard_tree(held, named)
    del model, held
    model = Model(cfg, blocks, device=dev)      # the whole tree is freed
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _serve(model, blocks, prompts, 2, max_len, mesh, policy, named)  # warm
    shd.WIRE.reset()
    got = _serve(model, blocks, prompts, int(n_new), max_len, mesh, policy,
                 named, forced=one[0][:, :-1])
    wire = shd.WIRE.snapshot()
    return {"tokens": got[0], "logits": got[1], "one_tokens": one[0],
            "one_logits": one[1], "ulp_logits": ulp[1],
            "times": torch.tensor([got[2], got[3], one[2], one[3]],
                                  dtype=torch.float64),
            "peak": torch.tensor([torch.cuda.max_memory_allocated()]),
            "stored": torch.tensor([fsdp.stored_bytes(blocks)]),
            "wire": torch.tensor([wire[k] for k in sorted(wire)]),
            "wire_keys": sorted(wire)}


# ------------------------------------------------------------------ rank --

def _place(v, dev):
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    if isinstance(v, dict):
        return {k: _place(x, dev) for k, x in v.items()}
    return v


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if isinstance(v, dict):
        return {k: _host(x) for k, x in v.items()}
    return v


def main(job_file: str) -> None:
    sys.path.insert(0, SRC)
    import torch.distributed as dist
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch.mesh import init_process_group
    torch.set_num_threads(1)
    job = torch.load(job_file, weights_only=False)
    dev = job["device"]
    rank, _ = init_process_group(dev)
    if dev == "cuda":
        dev = f"cuda:{torch.cuda.current_device()}"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    results = []
    try:
        for name, shape, kwargs in job["jobs"]:
            mesh = (None if shape is None
                    else Mesh(shape, ("data", "model"), job["device"]))
            out = globals()[name](mesh, **_place(kwargs, dev))
            results.append(_host(out))
        torch.save(results, f"{job_file}.{rank}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
