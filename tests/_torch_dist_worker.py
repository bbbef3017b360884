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
