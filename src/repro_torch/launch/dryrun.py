"""Multi-pod dry run: every (arch x shape x mesh) cell's step on a fake world.

A counterpart of ``repro.launch.dryrun`` (``run_cell``/``main``), with the
same command line, skip rules (``cell_supported``) and cells.  The
reference lowers and compiles each cell for 512 placeholder devices and
mines the compiled program; the port runs eagerly and compiles nothing, so
here each cell runs its step once, as rank 0 of a world of 256 or 512
ranks that exists only in this process: ``torch.distributed``'s ``fake``
backend (``FakeStore``: every collective returns at once, with nothing on
a wire), on ``meta`` tensors (shapes and dtypes, no storage and no
arithmetic; ``FakeTensorMode`` gives the same bytes, FLOPs and wire at 3-5
times the host time an operation, which the SSM scans' eager loops
multiply by their steps).  The mesh is
``launch.mesh.make_production_mesh``'s, the specs the card runs use
(``train_shardings``; ``param_shardings`` and ``cache_shardings`` for
serving), the step the port's own (``make_train_step``,
``make_prefill_step``, ``make_decode_step``, on the rank's blocks).  Per
cell:

  * the bytes of the rank's arguments: its blocks of the parameters, the
    AdamW state, the batch and the decode cache;
  * what the step dispatches, counted by ``launch.op_analysis.OpAnalysis``
    (the counterpart of the reference's ``HloAnalysis``): the FLOPs the
    rank runs (the matmuls, convolutions and attention products, the remat
    recompute included; ``FlopCounterMode``'s count), by operator; the HBM
    bytes its operators read and write (``hbm_bytes_per_device``: eager,
    unfused); the peak of the storages it holds above its arguments
    (``memory.temp_bytes``: activations, saved tensors, gradients, new
    state) and so ``memory.peak_bytes`` (arguments + temp), the bytes
    that must fit a card; its operators' counts and bytes;
  * the bytes the rank puts on the wire, by kind (``sharding.WIRE``, the
    ring model), and its largest calls (``collectives.top``);
  * the wall seconds of the run.

Nothing is compiled and, on ``meta``, nothing is allocated: the peak is
the count of the storages the step creates and frees.  A decode cell runs
one step at the cache's last position (a full cache).  Each cell runs in
a process of its own, under a wall limit (``--cell-timeout``): past it
the cell is recorded as ``timeout``, apart from failures.  Results go
to ``out/dryrun_torch/torch__<arch>__<shape>__<mesh>[__<opts>].json``
(not the reference's ``out/dryrun``, whose mere existence turns on the
reference's artifact tests).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh single|multi|both] [--opts moe_shard_map,tp_only_params,
      kv_int8,micro<N>] [--list] [--force] [--cell-timeout S]

Cells run at once, one process each, on half the host's cores.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch

# a directory of its own: ``tests/test_dryrun_artifacts.py`` checks the
# reference's artifacts whenever ``out/dryrun`` exists
OUT_DIR = Path(__file__).resolve().parents[3] / "out" / "dryrun_torch"
SRC = str(Path(__file__).resolve().parents[2])
PRODUCTION = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}
RESULT = "DRYRUN_RESULT "
CELL_TIMEOUT = 900.0


def cell_spec(arch: str, shape: str, mesh: str, opts=(), smoke=False,
              overrides=None, shape_dims=None, mesh_dims=None) -> Dict:
    """A cell as the dict that crosses into the cell's process: ``arch``'s
    config (``smoke``: its SMOKE config; ``overrides``: fields replaced,
    ``moe``/``mla``/``ssm`` as dicts of their own fields or ``None``),
    ``shape`` (a name of ``SHAPES``, or ``shape_dims`` = (kind, seq_len,
    global_batch)), ``mesh`` ('single' or 'multi', or ``mesh_dims`` =
    (shape, axis names)) and the switches ``opts``."""
    from repro_torch.configs.base import SHAPES
    if shape_dims is None:
        s = SHAPES[shape]
        shape_dims = (s.kind, s.seq_len, s.global_batch)
    dims, axes = mesh_dims or PRODUCTION[mesh]
    return {"arch": arch, "smoke": bool(smoke), "overrides": overrides or {},
            "shape": [shape, *shape_dims], "mesh": mesh,
            "mesh_dims": [list(dims), list(axes)], "opts": list(opts)}


def _config(spec):
    from repro_torch.configs.base import get_config, smoke_config
    cfg = (smoke_config if spec["smoke"] else get_config)(spec["arch"])
    over = dict(spec["overrides"])
    for k in ("moe", "mla", "ssm"):
        if isinstance(over.get(k), dict):
            over[k] = dataclasses.replace(getattr(cfg, k), **over[k])
    cfg = dataclasses.replace(cfg, **over)
    if "moe_shard_map" in spec["opts"] and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch="shard_map"))
    if "kv_int8" in spec["opts"]:
        cfg = dataclasses.replace(cfg, kv_cache_int8_scale=8.0)
    return cfg


def _materialize(tree, fake: bool, gen: Optional[torch.Generator],
                 device="cpu"):
    """A tree of ``meta`` tensors as tensors of the same shapes and dtypes:
    empty (on ``meta``: no storage) or, for a real run, drawn
    from ``gen`` (token ids below 2, floats normal) and put on ``device``."""
    def one(t):
        if fake or gen is None:
            return torch.zeros(t.shape, dtype=t.dtype, device=device)
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=gen).to(device, t.dtype)
        return torch.randint(0, 2, t.shape, generator=gen,
                             dtype=t.dtype).to(device)
    if isinstance(tree, dict):
        return {k: _materialize(v, fake, gen, device) for k, v in tree.items()}
    return one(tree)


def _local(batch, policy, mesh):
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import step as st
    return {k: shd.local_shard(v, st.batch_pspec(policy, v.dim()), mesh)
            for k, v in batch.items()}


def measure(spec: Dict, mesh, fake: bool = True, device="cpu",
            analysis: bool = True) -> Dict:
    """Run the cell's step once as this rank of ``mesh``'s world: on
    ``meta`` tensors with ``fake``, else on real tensors (the model's
    own weights, seed 0, and a batch drawn from seed 1) on ``device``.
    Returns the policy, the rank's argument bytes, what ``OpAnalysis``
    counted (FLOPs by operator, HBM bytes, temp and peak bytes, operators),
    ``WIRE`` by kind with the largest calls, and the run's wall.  Without
    ``analysis`` the step runs under no mode and only the wall and the
    argument bytes are recorded (the analysis's own cost, by difference)."""
    from repro_torch.configs.base import ShapeConfig, input_specs
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.launch.policy import cell_policy
    from repro_torch.models.model import Model, model_abstract
    from repro_torch.models.params import tree_map, tree_shape_structs
    from repro_torch.optim import adamw
    from repro_torch.train import step as st
    cfg = _config(spec)
    name, kind, seq, batch_size = spec["shape"]
    shape = ShapeConfig(name, seq, batch_size, kind)
    policy = cell_policy(cfg, shape, mesh)
    for o in spec["opts"]:
        if o.startswith("micro"):
            policy = dataclasses.replace(policy, n_micro=int(o[5:]))
    if kind == "decode":
        cfg = dataclasses.replace(cfg, seq_shard_decode=policy.seq_shard)
    drop_fsdp = "tp_only_params" in spec["opts"]
    gen = None if fake else torch.Generator().manual_seed(1)
    dev = "meta" if fake else device
    with torch.device("meta") if fake else contextlib.nullcontext():
        if fake:
            whole = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                             tree_shape_structs(model_abstract(cfg),
                                                cfg.param_dtype))
            model = Model(cfg, whole, device="meta")
        else:
            model = Model(cfg, device=device, seed=0)
            whole = model.params
        batch = _materialize(input_specs(cfg, shape), fake, gen, dev)
        args = {}
        if kind == "train":
            opt_cfg = adamw.AdamWConfig(state_dtype=policy.opt_state_dtype)
            named = st.train_shardings(model, policy, mesh, opt_cfg)
            blocks = shd.shard_tree(whole, named[0])
            # the whole tree is freed: the rank holds its blocks alone
            model = Model(cfg, blocks, device=dev)
            del whole
            opt = adamw.init(blocks, opt_cfg)
            args.update(params=blocks, opt_state=opt,
                        batch=_local(batch, policy, mesh))
            fn = st.make_train_step(model, opt_cfg, policy, named)

            def run():
                return fn(blocks, opt, batch)
        else:
            named = st.param_shardings(model, mesh, drop_fsdp)
            blocks = shd.shard_tree(whole, named)
            model = Model(cfg, blocks, device=dev)
            del whole
            local = _local(batch, policy, mesh)
            args.update(params=blocks, batch=local)
            if kind == "prefill":
                fn = st.make_prefill_step(model, named)

                def run():
                    return fn(blocks, local)
            else:
                cache = _materialize(model.init_cache_structs(
                    batch_size, policy.cache_len), True, None, dev)
                cache = shd.shard_tree(cache, st.cache_shardings(
                    cache, policy, mesh))
                args["cache"] = cache
                fn = st.make_decode_step(model, named)

                def run():
                    return fn(blocks, cache, policy.cache_len - 1, local)
        arg_bytes = {k: fsdp.stored_bytes(v) for k, v in args.items()}
        del args
        # garbage in a reference cycle waits for the collector: collect it,
        # so that the step starts with its arguments alone
        gc.collect()
        ana = OpAnalysis() if analysis else contextlib.nullcontext()
        card = torch.device(dev).type == "cuda"
        if card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            allocated = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        with shd.use_mesh(mesh), shd.use_batch_axes(policy.batch_axes), \
                torch.inference_mode(kind != "train"), ana:
            run()
        if card:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    argument_bytes = sum(arg_bytes.values())
    # on the card: what the allocator held when the step started and at
    # its peak (the prediction to hold them against: argument + temp bytes)
    measured = ({"allocated_at_start": allocated,
                 "max_allocated": torch.cuda.max_memory_allocated(dev)}
                if card else None)
    if not analysis:
        return {"memory": {"argument_bytes": argument_bytes,
                           "by_argument": arg_bytes}, "wall_s": wall}
    rec = ana.summary()
    return {
        "policy": {"batch_axes": list(policy.batch_axes),
                   "n_micro": policy.n_micro,
                   "opt_state_dtype": policy.opt_state_dtype,
                   "cache_len": policy.cache_len,
                   "seq_shard": policy.seq_shard, "notes": policy.notes},
        "memory": {"argument_bytes": argument_bytes,
                   "by_argument": arg_bytes,
                   "temp_bytes": rec["temp_bytes"],
                   "peak_bytes": argument_bytes + rec["temp_bytes"],
                   "device": measured,
                   "note": "argument bytes from the block specs; temp bytes "
                           "the peak of the storages the step's operators "
                           "create over those it starts with "
                           "(launch.op_analysis); no HLO: the port runs "
                           "eagerly and compiles nothing"},
        "flops_per_device": rec["flops_per_device"],
        "flops_by_op": rec["flops_by_op"],
        "hbm_bytes_per_device": rec["hbm_bytes_per_device"],
        "ops_by_name": rec["ops_by_name"],
        "collectives": {"wire_bytes_per_device":
                        rec["collective_wire_bytes_per_device"],
                        "by_kind": rec["collectives_by_kind"],
                        "top": rec["top_collectives"]},
        "wall_s": wall,
    }


def _cell_main(spec_json: str) -> None:
    """The cell's own process: a fake world of the mesh's ranks, this one
    rank 0, and the cell measured on it; prints the record as one line."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch.mesh import make_production_mesh
    spec = json.loads(spec_json)
    dims, axes = spec["mesh_dims"]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(dims))
    try:
        if (tuple(dims), tuple(axes)) == PRODUCTION.get(spec["mesh"]):
            mesh = make_production_mesh(spec["mesh"] == "multi",
                                        device="cpu")
        else:
            mesh = Mesh(dims, axes, "cpu")
        rec = measure(spec, mesh, fake=True,
                      analysis=spec.get("analysis", True))
    finally:
        dist.destroy_process_group()
    print(RESULT + json.dumps(rec), flush=True)


def run_spec(spec: Dict, timeout: float = CELL_TIMEOUT) -> Dict:
    """``spec``'s cell measured in a process of its own: the record's
    measured fields with ``status`` ``ok``, or ``fail`` with the error, or
    ``timeout`` past ``timeout`` seconds."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            "--cell", json.dumps(spec)], env=env,
                           capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"status": "timeout", "reason": f"past the cell's wall limit "
                f"of {timeout:g} s", "wall_s": time.perf_counter() - t0}
    for line in r.stdout.splitlines():
        if line.startswith(RESULT):
            return dict(json.loads(line[len(RESULT):]), status="ok")
    err = (r.stderr.strip().splitlines() or ["exit code %d" % r.returncode])
    return {"status": "fail", "error": err[-1],
            "traceback": r.stderr[-4000:],
            "wall_s": time.perf_counter() - t0}


def run_cell(arch: str, shape_name: str, mesh_kind: str, force: bool = False,
             opts: str = "", timeout: float = CELL_TIMEOUT) -> Dict:
    """opts: comma list of switches applied on top of the baseline config:
    moe_shard_map | tp_only_params | kv_int8 | micro<N>."""
    from repro_torch.configs.base import SHAPES, cell_supported, get_config
    opt_list = [o for o in opts.split(",") if o]
    tag = ("__" + "_".join(sorted(opt_list))) if opt_list else ""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out_path = OUT_DIR / f"torch__{arch}__{shape_name}__{mesh_kind}{tag}.json"
    if out_path.exists() and not force:
        res = json.loads(out_path.read_text())
        print(f"[cached] {arch} x {shape_name} x {mesh_kind}: {res['status']}")
        return res
    ok, why = cell_supported(get_config(arch), SHAPES[shape_name])
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "opts": opt_list, "status": "skip", "reason": why}
    if ok:
        rec.update(run_spec(cell_spec(arch, shape_name, mesh_kind, opt_list),
                            timeout))
    out_path.write_text(json.dumps(rec, indent=1))
    if rec["status"] == "ok":
        print(f"[ok]     {arch} x {shape_name} x {mesh_kind}: "
              f"{rec['wall_s']:.0f} s, args/dev "
              f"{rec['memory']['argument_bytes'] / 1e9:.2f} GB, flops/dev "
              f"{rec['flops_per_device']:.3g}, wire/dev "
              f"{rec['collectives']['wire_bytes_per_device']:.3g} B",
              flush=True)
    elif rec["status"] == "skip":
        print(f"[skip]   {arch} x {shape_name}: {why}", flush=True)
    else:
        print(f"[{rec['status']}] {arch} x {shape_name} x {mesh_kind}: "
              f"{rec.get('error', rec.get('reason', ''))[:300]}", flush=True)
    return rec


def main(argv=None) -> None:
    from repro_torch.configs.base import SHAPES, list_archs
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--opts", default="",
                    help="comma list: moe_shard_map,tp_only_params,kv_int8,"
                         "micro<N>")
    ap.add_argument("--cell-timeout", type=float, default=CELL_TIMEOUT,
                    help="a cell's wall limit in seconds")
    ap.add_argument("--cell", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cell is not None:
        _cell_main(args.cell)
        return
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.list:
        for a in archs:
            for s in shapes:
                print(a, s)
        return
    from concurrent.futures import ThreadPoolExecutor
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    workers = min(len(cells), max(1, (os.cpu_count() or 1) // 2))
    with ThreadPoolExecutor(max(workers, 1)) as ex:
        recs = list(ex.map(lambda c: run_cell(
            *c, force=args.force, opts=args.opts,
            timeout=args.cell_timeout), cells))
    counts = {k: sum(r["status"] == k for r in recs)
              for k in ("fail", "timeout")}
    print(f"dry-run complete; failures: {counts['fail']}, timeouts: "
          f"{counts['timeout']}")
    raise SystemExit(1 if counts["fail"] else 0)


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except Exception:  # noqa: BLE001
        traceback.print_exc()
        raise SystemExit(1)
