"""Progressive MDR checkpointing: atomic, async, precision-on-demand.

A port of ``repro.ckpt.manager``, with the same on-disk layout, so that a
checkpoint written by either package loads in the other:

    <dir>/step_<N>/
        <leafname>.mdr     IEEE-bitplane refactored tensor (or .raw)
        manifest.json      written LAST -> a checkpoint is valid iff
                           its manifest exists (atomic commit)

* resume:      load(..., rel_error=None) is BIT-EXACT (all planes)
* warm-start:  load(..., rel_error=1e-2) reads the sign/exponent + top
               mantissa plane groups only — a fraction of the bytes
* placement:   tensors are stored logically (whole); ``load`` puts each leaf
               on ``device``: one device, or a matching tree of devices.  A
               checkpoint written from the card loads on the CPU and the
               other way round.
* elastic:     under a mesh (``sharding.use_mesh``) ``save`` gathers the
               leaves that ``shardings`` says are cut one at a time, rank 0
               writes each before the next is gathered, and every rank
               waits for the manifest: the files are those of a save from
               one device, and no rank holds more than one whole leaf.
               ``load(..., shardings=)`` gives each rank its block of each
               leaf under any mesh.
* async:       snapshot-to-host happens on the caller thread;
               encode+write runs on a background thread.

A tree is nested dicts, lists, tuples and ``NamedTuple``s of tensors (numpy
arrays and Python or numpy scalars are leaves too), as in a ``state_dict``
or an ``optim.adamw.AdamWState``; ``None`` holds no leaf.  Leaves are named
and ordered as ``jax.tree_util`` flattens the same nesting: a dict's keys
SORTED, a ``NamedTuple``'s fields by name, a list's or tuple's items by
index, path parts joined by ``.``, a repeated sanitized name suffixed
``__N`` in that order.  Dtypes are written under
numpy's names (``float32``, ``bfloat16``, ``int64``, ...).  Leaves of a
codec dtype with at least 1024 elements are refactored
(``bitcast_codec``, on ``device``: ``None`` means ``cuda``); the others are
stored raw.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ckpt import bitcast_codec as bc
from repro_torch.core import lossless as ll
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.obs import trace as obs_trace

_SANITIZE = re.compile(r"[^\w.\-]+")


def _paths(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in jax's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _paths(tree[k],
                                                          prefix + (k,))]
    if _is_namedtuple(tree):
        return [pl for k, v in zip(tree._fields, tree)
                for pl in _paths(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in _paths(v,
                                                                prefix + (i,))]
    return [(prefix, tree)]


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _unflatten(like, leaves) -> Any:
    """``like``'s nesting with its leaves taken in order from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves) for v in like]
        if _is_namedtuple(like):
            return type(like)(*out)
        return tuple(out) if isinstance(like, tuple) else out
    return next(leaves)


def _leaf_name(path) -> str:
    return _SANITIZE.sub("_", ".".join(str(p) for p in path)) or "leaf"


def _flatten(tree) -> Tuple[List[str], List[Any]]:
    names, leaves = [], []
    seen: Dict[str, int] = {}
    for path, leaf in _paths(tree):
        n = _leaf_name(path)
        if n in seen:
            seen[n] += 1
            n = f"{n}__{seen[n]}"
        else:
            seen[n] = 0
        names.append(n)
        leaves.append(leaf)
    return names, leaves


def _host_tensor(leaf) -> torch.Tensor:
    """A leaf as a CPU tensor (numpy input of any dtype, ``ml_dtypes``
    bfloat16 included; Python and numpy scalars as numpy makes them)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return bc.as_tensor(np.asarray(leaf), "cpu")


def _snapshot(leaf) -> torch.Tensor:
    """A host copy of a leaf that later writes to the leaf do not reach."""
    t = _host_tensor(leaf)
    on_card = isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu"
    return t if on_card else t.clone()


def _raw_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _specs_for(like, shardings) -> List[Any]:
    """The ``sharding.Named`` of each leaf of ``like``, in ``_paths``
    order, from a matching tree; one ``Named`` holds for the whole subtree
    it stands in."""
    if isinstance(shardings, shd.Named):
        return [shardings] * len(_paths(like))
    if like is None:
        return []
    if isinstance(like, dict):
        return [s for k in sorted(like) for s in _specs_for(like[k],
                                                            shardings[k])]
    if _is_namedtuple(like):
        return [s for k, v in zip(like._fields, like)
                for s in _specs_for(v, getattr(shardings, k))]
    if isinstance(like, (list, tuple)):
        return [s for v, sv in zip(like, shardings)
                for s in _specs_for(v, sv)]
    return [shardings]


def save(ckpt_dir: str | Path, step: int, tree: Any,
         hybrid: ll.HybridConfig = ll.HybridConfig(),
         meta: Optional[Dict] = None, device: DeviceLike = None,
         shardings: Any = None) -> Path:
    """Synchronous atomic save; refactored leaves are encoded on
    ``device`` (``None`` means ``cuda``).  Under a mesh, ``shardings`` (a
    matching tree of ``sharding.Named``; ``None``: every leaf is whole on
    every rank) says how each rank's leaves are cut; leaf by leaf, every
    rank gathers it and rank 0 writes it and drops it before the next, and
    every rank returns once rank 0 has committed the manifest."""
    mesh = shd.get_current_mesh()
    dev = resolve_device(device)
    names, leaves = _flatten(tree)
    if mesh is None:
        write = True
    else:
        specs = ([None] * len(leaves) if shardings is None
                 else _specs_for(tree, shardings))
        write = mesh.rank == 0
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if write:
        _begin(ckpt_dir, tmp)
    manifest: Dict[str, Any] = {"step": step, "leaves": {}, "meta": meta or {},
                                "time": time.time()}
    for i, (name, leaf) in enumerate(zip(names, leaves)):
        if mesh is not None and specs[i] is not None:
            leaf = shd.gather_shard(leaf, specs[i].spec, specs[i].mesh)
        if write:
            manifest["leaves"][name] = _write_leaf(tmp, name, leaf, hybrid,
                                                   dev)
        del leaf
    if write:
        # commit: manifest last, then atomic rename
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    if mesh is not None:
        shd.barrier()
    return final


def _begin(ckpt_dir: Path, tmp: Path) -> None:
    """An empty ``tmp``; stale tmp dirs of other steps swept."""
    if tmp.exists():
        shutil.rmtree(tmp)
    # sweep stale tmp dirs from OTHER steps' crashed saves: a killed writer
    # leaves .tmp_step_M behind forever (only the same-step path above would
    # clean it), leaking a full checkpoint of disk per crash
    if ckpt_dir.exists():
        for stale in ckpt_dir.glob(".tmp_step_*"):
            if stale != tmp:
                shutil.rmtree(stale, ignore_errors=True)
    tmp.mkdir(parents=True)


def _write_leaf(tmp: Path, name: str, leaf, hybrid: ll.HybridConfig,
                dev: torch.device) -> Dict[str, Any]:
    """Encode (or take raw) and write one leaf; returns its manifest
    entry."""
    t = leaf if isinstance(leaf, torch.Tensor) else _host_tensor(leaf)
    dt = bc.dtype_name(t.dtype)
    nbytes = t.numel() * t.element_size()
    entry: Dict[str, Any] = {"dtype": dt, "shape": list(t.shape)}
    if dt in bc._FMT and t.numel() >= 1024:
        blob = bc.exact_to_bytes(bc.exact_refactor(t, hybrid=hybrid,
                                                   device=dev))
        entry["codec"] = "mdr"
        entry["file"] = f"{name}.mdr"
    else:
        blob = _raw_bytes(t.detach().cpu())
        entry["codec"] = "raw"
        entry["file"] = f"{name}.raw"
    entry["stored_bytes"] = len(blob)
    entry["raw_bytes"] = nbytes
    with obs_trace.span("ckpt.write", bytes=len(blob)):
        (tmp / entry["file"]).write_bytes(blob)
    return entry


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    best = None
    for d in ckpt_dir.iterdir():
        if d.name.startswith("step_") and (d / "manifest.json").exists():
            s = int(d.name.split("_")[1])
            best = s if best is None else max(best, s)
    return best


def _leaf_devices(device, n: int) -> List[DeviceLike]:
    """One device for every leaf, or the leaves of a matching device tree."""
    if device is None or isinstance(device, (str, torch.device)):
        return [device] * n
    _, devs = _flatten(device)
    if len(devs) != n:
        raise ValueError(f"the device tree has {len(devs)} leaves, the "
                         f"checkpoint structure {n}")
    return devs


def _from_raw(blob: bytes, dtype: str, shape) -> torch.Tensor:
    """A raw leaf's bytes as a CPU tensor of the manifest's dtype (numpy's
    names are torch's attribute names)."""
    dt = getattr(torch, dtype, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r} in the manifest")
    flat = torch.from_numpy(np.frombuffer(blob, np.uint8).copy())
    return flat.view(dt).reshape(shape)


def load(ckpt_dir: str | Path, step: int, like: Any,
         rel_error: Optional[float] = None,
         device: Any = None, shardings: Any = None) -> Tuple[Any, Dict]:
    """Load into the structure of ``like`` (a tree of tensors or arrays:
    only its nesting is read).  ``device`` places the leaves: one device, or
    a matching tree of devices; ``None`` means ``cuda``.  Refactored leaves
    are rebuilt on their device.  ``shardings`` (a matching tree of
    ``sharding.Named``) gives each rank its block of each leaf (an elastic
    restore: the checkpoint holds whole tensors, so any mesh reads it).
    Returns (tree, stats)."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    names, _ = _flatten(like)
    devs = [resolve_device(v) for v in _leaf_devices(device, len(names))]
    specs = ([None] * len(names) if shardings is None
             else _specs_for(like, shardings))
    out = []
    bytes_read = 0
    bytes_full = 0
    for name, dev, sh in zip(names, devs, specs):
        entry = manifest["leaves"][name]
        with obs_trace.span("ckpt.read", bytes=entry["stored_bytes"]):
            blob = (d / entry["file"]).read_bytes()
        if entry["codec"] == "mdr":
            r = bc.exact_from_bytes(blob)
            t, nb = bc.exact_retrieve(r, rel_error=rel_error, device=dev)
            bytes_read += nb
        else:
            t = _from_raw(blob, entry["dtype"], entry["shape"]).to(dev)
            bytes_read += len(blob)
        bytes_full += entry["stored_bytes"]
        if sh is not None:
            t = shd.local_shard(t, sh.spec, sh.mesh).clone()
        out.append(t)
    stats = {"bytes_read": bytes_read, "bytes_full": bytes_full,
             "step": manifest["step"], "read_fraction":
                 bytes_read / max(bytes_full, 1)}
    return _unflatten(like, iter(out)), stats


class AsyncCheckpointer:
    """Snapshot to host on the caller thread, encode+write in the
    background (encoded on ``device``: ``None`` means ``cuda``).  An error
    of the background save is raised again at the next ``wait`` (or
    ``save``)."""

    def __init__(self, ckpt_dir: str | Path, device: DeviceLike = None):
        self.ckpt_dir = Path(ckpt_dir)
        self.device = resolve_device(device)
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None):
        """Snapshot ``tree`` to the host (span ``ckpt.snapshot``), then
        encode and write it on a background thread (span ``ckpt.save``, in
        the caller's trace)."""
        self.wait()
        with obs_trace.span("ckpt.snapshot", step=step):
            host_tree = _unflatten(tree, iter([_snapshot(v)
                                               for _, v in _paths(tree)]))

        def work():
            try:
                with obs_trace.span("ckpt.save", step=step):
                    save(self.ckpt_dir, step, host_tree, meta=meta,
                         device=self.device)
            except BaseException as e:  # noqa: BLE001 - raised at wait()
                self.last_error = e

        self._thread = threading.Thread(target=obs_trace.wrap_for_thread(work),
                                        daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
