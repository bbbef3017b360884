"""Dispatched-op analysis: FLOPs, HBM bytes, live memory and collectives of
what eager torch actually runs.

The counterpart of ``repro.launch.hlo_analysis``.  The reference mines a
compiled XLA program's HLO (``HloAnalysis``); an eager runtime has no
compiled program, so here the counterpart counts the operators it
dispatches.  ``OpAnalysis`` is a ``TorchDispatchMode``: it sees every aten
operator that runs while it is entered, the backward's, every remat
recompute and every step of a loop included, so it is loop-aware by
construction (it needs no ``known_trip_count``), and it sees them on
``meta`` tensors (shapes, no storage, nothing executed) as on the card.

The rules:

* **FLOPs** come from ``torch.utils.flop_counter``'s registry, one formula
  an operator (the matmuls, convolutions and attention products), and an
  operator outside the registry that has a composite decomposition runs
  decomposed, as ``FlopCounterMode`` does, so the count equals
  ``FlopCounterMode``'s.  This mode is that counter folded into one: a
  second, nested mode would double the host time an operator costs, which
  is what makes the dry run's cells time out.
* **Bytes** (an HBM-traffic proxy): a view or alias operator (one whose
  outputs alias an input, by its schema or by its storage) counts 0.
  Every other operator counts the ``nbytes`` of its tensor inputs plus
  those of its outputs.  An in-place operator counts its mutated input
  once as read and once as written (an ``out=`` argument only as
  written).  An allocation (``empty`` and its kin) writes nothing and
  counts 0.  This is what eager torch moves through HBM, with no fusion.
  The reference leaves ``copy`` and ``transpose`` out because XLA elides
  loop-state copies; eager torch does not, so ``copy_`` counts here.  The
  hand-written kernels are operators of their own (``repro_torch::
  rb_encode`` and the rest, ``kernels/bitplane.py``), each counted as one
  operator at its operand and result bytes, launched on the card or
  faked on ``meta``.
* **Collectives** are read from ``sharding.WIRE``'s deltas over the
  window, which already apply the reference's ring model (all-gather
  ``out (n-1)/n``, all-reduce ``2 out (n-1)/n``, reduce-scatter
  ``out (n-1)``, all-to-all ``out (n-1)/n``), plus one record a call
  (``sharding.WIRE_LISTENERS``) for ``top_collectives``.  The ``c10d``
  operators themselves are run and not counted, nor are the tensor
  operators a backend builds a collective from (gloo's reduce-scatter,
  ``sharding.IN_BACKEND``), so no collective counts twice.
* **Peak live bytes**: every storage is tracked by identity (its
  ``StorageImpl``, not ``data_ptr()``, which is 0 on ``meta``) from the
  operator that creates it until it is freed (a weak reference on the
  storage).  A storage that an operator reads but no operator of the
  window created was alive on entry: those make the base.  ``temp_bytes``
  is the peak over the window less that base, ``peak_live_bytes`` the
  base plus it.  A workspace an operator allocates and frees inside
  itself is not seen, except a kernel operator's declared one
  (``kernels.bitplane.WORKSPACE``: the scan backwards' partials), which
  counts as live for the length of its call, beside its inputs and
  outputs, and not after it.

Usage::

    with OpAnalysis() as ana:
        step(params, batch)
    ana.summary()   # the reference's keys, plus peak/temp bytes and ops
"""
from __future__ import annotations

import dataclasses
import math
import threading
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import bitplane as _bp

TOP = 12  # the reference's length of ``top_collectives``

_aten = torch.ops.aten
# shape and layout queries: handed back to the dispatcher, as
# FlopCounterMode hands them
_QUERIES = frozenset({
    _aten.sym_is_contiguous.default, _aten.is_contiguous.default,
    _aten.is_contiguous.memory_format, _aten.is_strides_like_format.default,
    _aten.is_non_overlapping_and_dense.default, _aten.size.default,
    _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
    _aten.storage_offset.default, _aten.sym_storage_offset.default,
    _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
    torch.ops.prim.layout.default})
_ALLOC = frozenset({_aten.empty, _aten.empty_like, _aten.empty_strided,
                    _aten.new_empty, _aten.new_empty_strided})
_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd


@dataclasses.dataclass
class CollectiveRec:
    """One collective call, as ``repro.launch.hlo_analysis.CollectiveRec``
    has one instruction (``count`` is 1: every call is its own record)."""
    kind: str
    wire_bytes: float
    payload_bytes: int
    group_size: int
    count: float


@dataclasses.dataclass(frozen=True)
class _OpInfo:
    name: str                 # "aten.mm.default"
    packet: str               # "aten.mm", FlopCounterMode's key
    flop_fn: object           # the registry's formula, or None
    decompose: bool           # runs decomposed (outside the registry)
    counted: bool             # False: run, not counted (c10d, prim.device)
    view: bool                # its schema returns an alias of an input
    alloc: bool               # an allocation: it moves no byte
    mutable: bool             # it writes an input (in place or out=)
    out_args: frozenset       # names of ``out=`` arguments (written only)
    workspace: object         # its declared workspace's shapes, or None


_INFO: Dict[object, _OpInfo] = {}


def _info(func) -> _OpInfo:
    info = _INFO.get(func)
    if info is None:
        schema = func._schema
        packet = func._overloadpacket
        flop_fn = flop_registry.get(packet)
        counted = (func.namespace != "c10d"
                   and func is not torch.ops.prim.device.default)
        info = _OpInfo(
            name=str(func), packet=str(packet), flop_fn=flop_fn,
            decompose=(flop_fn is None and counted and (
                _COMPOSITE in func.py_kernels
                or torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), _COMPOSITE))),
            counted=counted,
            view=any(r.alias_info is not None and not r.alias_info.is_write
                     for r in schema.returns),
            mutable=schema.is_mutable,
            alloc=packet in _ALLOC,
            out_args=frozenset(a.name for a in schema.arguments
                               if a.is_out),
            workspace=_bp.WORKSPACE.get(func))
        _INFO[func] = info
    return info


def _flat(x, out: list) -> None:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            if isinstance(y, torch.Tensor):
                out.append(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _workspace_bytes(fn, args, kwargs) -> int:
    """The bytes of a kernel operator's declared workspace for ``args``:
    each buffer a shape (of its first input's dtype) or a (shape, dtype)
    pair."""
    total = 0
    for spec in fn(*args, **kwargs).values():
        shape, dtype = ((spec[0], spec[1]) if len(spec) == 2
                        and isinstance(spec[1], torch.dtype)
                        else (spec, args[0].dtype))
        total += math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    return total


class OpAnalysis(TorchDispatchMode):
    """Counts what runs while it is entered (see the module docstring);
    ``summary()`` reports it.  Not reentrant; one window an instance."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops: Dict[str, List[int]] = {}   # name -> [n, bytes, flops]
        self.flops_by_op: Dict[str, int] = {}
        self.collectives: List[CollectiveRec] = []
        self.wire_by_kind: Dict[str, Dict[str, float]] = {}
        # reentrant: a weak reference's callback may run on this thread
        # while it counts
        self._lock = threading.RLock()
        self._live: Dict[int, int] = {}       # created storages alive
        self._base: Dict[int, int] = {}       # storages alive on entry
        self._refs: Dict[int, weakref.ref] = {}
        self._live_bytes = 0                  # created, alive
        self._base_bytes = 0                  # alive on entry, ever seen
        self._base_freed = 0                  # of those, freed since
        self._peak_extra = 0                  # max of live - base freed
        self._wire0: Optional[Dict[str, int]] = None
        self._depth = 0

    # -------------------------------------------------------------- window --
    # the window opens and closes with the outermost ``with``; the mode is
    # also re-entered inside ``__torch_dispatch__`` to run a decomposition
    def __enter__(self):
        if self._depth == 0:
            self._wire0 = shd.WIRE.snapshot()
            shd.WIRE_LISTENERS.append(self._on_wire)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._depth -= 1
        if self._depth:
            return out
        shd.WIRE_LISTENERS.remove(self._on_wire)
        wire = shd.WIRE.snapshot()
        self.wire_by_kind = {
            k: {"count": wire[k] - self._wire0[k],
                "wire_bytes": wire[f"{k}_bytes"] - self._wire0[f"{k}_bytes"]}
            for k in wire if not k.endswith("_bytes")
            and wire[k] != self._wire0[k]}
        self._refs.clear()   # frees after the window are not this window's
        return out

    def _on_wire(self, kind: str, wire: int, payload: int, n: int) -> None:
        with self._lock:
            self.collectives.append(CollectiveRec(kind, float(wire), payload,
                                                  n, 1.0))

    # ------------------------------------------------------------- storage --
    def _freed(self, key: int, base: bool) -> None:
        with self._lock:
            self._refs.pop(key, None)
            if base:
                self._base_freed += self._base.pop(key, 0)
            else:
                self._live_bytes -= self._live.pop(key, 0)

    def _watch(self, key: int, storage, base: bool) -> None:
        self._refs[key] = weakref.ref(
            storage, lambda _, key=key, base=base: self._freed(key, base))

    # ------------------------------------------------------------ dispatch --
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return NotImplemented
        info = _info(func)
        if info.decompose:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if info.counted and not getattr(shd.IN_BACKEND, "depth", 0):
            self._count(info, out, args, kwargs)
        return out

    def _count(self, info: _OpInfo, out, args, kwargs) -> None:
        if info.view:                 # by its schema: no byte, no storage
            with self._lock:
                self._tally(info, 0, 0)
            return
        ins: list = []
        for a in args:
            _flat(a, ins)
        written: list = []
        for k, v in kwargs.items():
            _flat(v, written if k in info.out_args else ins)
        outs: list = []
        _flat(out, outs)
        flops = (info.flop_fn(*args, **kwargs, out_val=out)
                 if info.flop_fn is not None else 0)
        with self._lock:
            seen = set()
            for t in ins + written:
                s = t.untyped_storage()
                key = s._cdata
                seen.add(key)
                if key not in self._live and key not in self._base:
                    n = s.nbytes()
                    self._base[key] = n
                    self._base_bytes += n
                    self._watch(key, s, True)
            out_storages = [t.untyped_storage() for t in outs]
            if not info.mutable and any(s._cdata in seen
                                        for s in out_storages):
                self._tally(info, 0, flops)   # an alias by its storage
                return
            nbytes = 0 if info.alloc else (sum(_nbytes(t) for t in ins)
                                           + sum(_nbytes(t) for t in outs))
            for s in out_storages:
                key = s._cdata
                if key not in self._live and key not in self._base:
                    n = s.nbytes()
                    self._live[key] = n
                    self._live_bytes += n
                    self._watch(key, s, False)
            extra = self._live_bytes - self._base_freed
            if info.workspace is not None:   # live while the call runs
                extra += _workspace_bytes(info.workspace, args, kwargs)
            if extra > self._peak_extra:
                self._peak_extra = extra
            self._tally(info, nbytes, flops)

    def _tally(self, info: _OpInfo, nbytes: int, flops: int) -> None:
        rec = self.ops.get(info.name)
        if rec is None:
            rec = self.ops[info.name] = [0, 0, 0]
        rec[0] += 1
        rec[1] += nbytes
        rec[2] += flops
        self.bytes += nbytes
        if flops:
            self.flops += flops
            self.flops_by_op[info.packet] = (
                self.flops_by_op.get(info.packet, 0) + flops)

    # -------------------------------------------------------------- report --
    def summary(self) -> Dict:
        """The reference's ``HloAnalysis.summary()`` keys (collective kinds
        are ``WIRE``'s), plus ``peak_live_bytes``, ``temp_bytes``,
        ``base_bytes``, ``flops_by_op`` and ``ops_by_name`` (each operator's
        count, bytes and FLOPs)."""
        with self._lock:
            recs = list(self.collectives)
            ops = {k: {"count": v[0], "bytes": v[1], "flops": v[2]}
                   for k, v in sorted(self.ops.items())}
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.bytes,
            "collective_wire_bytes_per_device": sum(
                v["wire_bytes"] for v in self.wire_by_kind.values()),
            "collectives_by_kind": dict(self.wire_by_kind),
            "top_collectives": [dataclasses.asdict(c) for c in sorted(
                recs, key=lambda c: -c.wire_bytes)[:TOP]],
            "peak_live_bytes": self._base_bytes + self._peak_extra,
            "temp_bytes": self._peak_extra,
            "base_bytes": self._base_bytes,
            "flops_by_op": dict(self.flops_by_op),
            "ops_by_name": ops,
        }
