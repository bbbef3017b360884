"""Mesh context, sharding rules and the collectives over mesh axes.

A port of ``repro.distributed.sharding`` to PyTorch's multi-device idiom:
one process per rank, a ``torch.distributed.device_mesh.DeviceMesh`` with
the reference's axis names, and explicit collectives on the process group
of each mesh axis (NCCL on the card, gloo on the CPU).  Each ``shard_map``
body of the reference is the per-rank function that it already is, with
``jax.lax.psum`` / ``pmax`` / ``psum_scatter`` / ``all_gather`` /
``axis_index`` replaced by :func:`psum`, :func:`pmax`, :func:`psum_scatter`,
:func:`all_gather` and :func:`axis_index` below.

Physical mesh axes: ``('data', 'model')`` single-pod, ``('pod', 'data',
'model')`` multi-pod.  Data parallelism spans ('pod', 'data'); tensor and
expert parallelism span 'model'.  A spec is a plain tuple with one entry per
dim: ``None``, an axis name, or a tuple of axis names (the counterpart of
``PartitionSpec``).  A tensor on a rank is that rank's shard: it is whole
where its spec says ``None`` and cut along the axes a dim names.

Collectives take one axis or a tuple of axes (in mesh order); axes the mesh
does not have are dropped, as :func:`spec` drops them.  A tuple of axes is
one process group whose ranks are ordered major axis first, the order in
which ``jax.lax`` numbers the devices of a tuple of axes.  Every group is
built once, when the :class:`Mesh` is made, on every rank in the same
order (``dist.new_group`` is itself a collective).

``WIRE`` counts the collectives launched and the bytes each puts on the
wire, by kind, with the ring model of ``repro.launch.hlo_analysis`` (a
mesh axis of one rank counts one and moves nothing: an all-reduce or an
all-gather over it returns the tensor itself, with no copy and no call to
the backend): an all-gather moves
``out x (n-1)/n``, an all-reduce ``2 x out x (n-1)/n``, a reduce-scatter
``out x (n-1)`` and an all-to-all ``out x (n-1)/n`` (``out``: the bytes of
one rank's output).
The collectives of sharded parameter storage (``distributed/fsdp.py``)
count under kinds of their own: ``param_gather`` (a block gathered whole),
``grad_reduce_scatter`` and ``grad_all_reduce`` (a whole gradient reduced
to the block), and so do those of tensor-parallel compute over 'model'
(``distributed/tp.py``): ``tp_all_reduce`` (the forward of ``reduce_from``,
the backward of ``copy_to``, the vocabulary's max and sums) and
``tp_all_gather`` (logits, the seq-sharded decode's queries and Mamba's
decode state gathered whole) and ``tp_all_to_all`` (Mamba's ``in_proj``
re-cut to the rank's channels, and back in the backward), so that every
byte is counted once, under one kind.

:func:`shard_tree` and :func:`gather_tree` are the counterparts of
``jax.device_put(tree, shardings)`` and of reading such a tree back whole.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.obs.metrics import StatCounters

Axes = Union[None, str, Sequence[str]]
Spec = Tuple[Any, ...]


@dataclasses.dataclass
class WireCounters(StatCounters):
    """Collectives launched and the bytes they put on the wire, by kind."""
    all_gather: int = 0
    all_gather_bytes: int = 0
    all_reduce: int = 0
    all_reduce_bytes: int = 0
    reduce_scatter: int = 0
    reduce_scatter_bytes: int = 0
    param_gather: int = 0
    param_gather_bytes: int = 0
    grad_reduce_scatter: int = 0
    grad_reduce_scatter_bytes: int = 0
    grad_all_reduce: int = 0
    grad_all_reduce_bytes: int = 0
    tp_all_reduce: int = 0
    tp_all_reduce_bytes: int = 0
    tp_all_gather: int = 0
    tp_all_gather_bytes: int = 0
    tp_all_to_all: int = 0
    tp_all_to_all_bytes: int = 0


WIRE = WireCounters()


class Mesh:
    """A device mesh over every rank of the default process group.

    ``shape`` maps each axis name to its size (in mesh order, as a
    ``jax.sharding.Mesh``'s ``shape``); ``device_mesh`` is the
    ``DeviceMesh`` that lays the ranks out row-major; ``coordinate`` is this
    rank's index along each axis.  The world must have exactly as many
    ranks as the mesh has entries."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device_type: str):
        from torch.distributed.device_mesh import init_device_mesh
        shape, axis_names = tuple(shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} for axes {axis_names}")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                             f"the world has {world}")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.device_type = device_type
        self.device_mesh = init_device_mesh(device_type, shape,
                                            mesh_dim_names=axis_names)
        layout = self.device_mesh.mesh.numpy()
        self.rank = dist.get_rank()
        where = np.argwhere(layout == self.rank)[0]
        self.coordinate = dict(zip(axis_names, (int(c) for c in where)))
        # one group per tuple of axes (mesh order) and per coordinate of the
        # other axes; every rank creates every group, in the same order
        self._groups: Dict[Tuple[str, ...], Any] = {}
        dims = range(len(axis_names))
        for k in range(1, len(axis_names) + 1):
            for sub in itertools.combinations(dims, k):
                rest = [d for d in dims if d not in sub]
                moved = np.transpose(layout, rest + list(sub))
                lists = [[int(r) for r in g.reshape(-1)]
                         for g in moved.reshape(-1, math.prod(
                             shape[d] for d in sub))]
                mine, _ = dist.new_subgroups_by_enumeration(lists)
                self._groups[tuple(axis_names[d] for d in sub)] = mine

    def axes(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` as a tuple of this mesh's axes: names it lacks dropped,
        a string taken as one axis; the rest must be in mesh order."""
        if axes is None:
            return ()
        if isinstance(axes, str):
            axes = (axes,)
        kept = tuple(a for a in axes if a in self.shape)
        if list(kept) != sorted(kept, key=self.axis_names.index):
            raise ValueError(f"axes {kept} are not in mesh order "
                             f"{self.axis_names}")
        return kept

    def group(self, axes: Axes):
        return self._groups[self.axes(axes)]

    def size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def index(self, axes: Axes) -> int:
        """This rank's index along ``axes``, major axis first."""
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self.coordinate[a]
        return i

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"


class _State:
    """The current mesh and batch axes.  Process-wide, not thread-local: a
    process is one rank, and autograd runs a CUDA backward, where
    ``torch.utils.checkpoint`` recomputes a layer's forward, on a thread
    of its own, which must see the mesh the forward saw."""
    mesh: Optional[Mesh] = None
    batch_axes: Optional[Tuple[str, ...]] = None


_state = _State()


def set_current_mesh(mesh: Optional[Mesh]) -> None:
    _state.mesh = mesh


def get_current_mesh() -> Optional[Mesh]:
    return _state.mesh


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    prev = get_current_mesh()
    set_current_mesh(mesh)
    try:
        yield mesh
    finally:
        set_current_mesh(prev)


def _mesh(mesh: Optional[Mesh] = None) -> Mesh:
    mesh = mesh or get_current_mesh()
    if mesh is None:
        raise RuntimeError("no current mesh: run under sharding.use_mesh")
    return mesh


def batch_axes(mesh: Optional[Mesh] = None) -> Tuple[str, ...]:
    """The axes that cut the batch of the tensors a rank computes on: the
    innermost ``use_batch_axes``, else the data-parallel axes ('pod',
    'data'), of ``mesh`` (``None``: the current mesh); () without one."""
    mesh = mesh or get_current_mesh()
    if mesh is None:
        return ()
    axes = _state.batch_axes
    return mesh.axes(("pod", "data") if axes is None else axes)


@contextlib.contextmanager
def use_batch_axes(axes: Sequence[str]):
    """Declare that each rank's batch is its shard over ``axes`` (a train
    step's ``policy.batch_axes``), for the layers that mix tokens across
    the batch (the MoE's capacity and aux loss)."""
    prev = _state.batch_axes
    _state.batch_axes = tuple(axes)
    try:
        yield
    finally:
        _state.batch_axes = prev


def entry(axes: Sequence[str]):
    """A spec's entry for a tuple of axes: None for none, the name for
    one, the tuple for more (as a ``PartitionSpec`` normalizes it)."""
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _filter_axes(axes: Axes, mesh: Mesh):
    """Keep only axes present in the mesh, as a spec entry."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    return entry(a for a in axes if a in mesh.shape)


def spec(*dims) -> Spec:
    """A spec from logical per-dim axis requests, filtered by the current
    mesh.  Each dim is None, an axis name, or a tuple of axis names; 'dp'
    expands to ('pod', 'data').  Without a current mesh every dim is
    None."""
    mesh = get_current_mesh()
    out = []
    for d in dims:
        if d == "dp":
            d = ("pod", "data")
        out.append(None if mesh is None else _filter_axes(d, mesh))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Named:
    """A spec over a mesh: the counterpart of ``NamedSharding``."""
    mesh: Mesh
    spec: Spec


def named(pspec: Spec) -> Optional[Named]:
    mesh = get_current_mesh()
    if mesh is None:
        return None
    return Named(mesh, tuple(pspec))


def constraint(x: torch.Tensor, *dims) -> torch.Tensor:
    """The identity.  The reference constrains a global array's layout;
    under per-rank SPMD the tensor a rank holds already is its shard, so
    there is nothing to constrain."""
    return x


def axis_size(axes: Axes, mesh: Optional[Mesh] = None) -> int:
    return _mesh(mesh).size(axes)


def axis_index(axes: Axes, mesh: Optional[Mesh] = None) -> int:
    return _mesh(mesh).index(axes)


def dp_size(mesh: Optional[Mesh] = None) -> int:
    return _mesh(mesh).size(("pod", "data"))


def tp_size(mesh: Optional[Mesh] = None) -> int:
    return _mesh(mesh).shape.get("model", 1)


# ------------------------------------------------------------ collectives --

# torch 2.13 names them ``*_single`` and deprecates the ``*_tensor`` names,
# which older versions have alone
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# called as fn(kind, wire_bytes, payload_bytes, group_size) on every count
# (``launch.op_analysis`` keeps one record a call)
WIRE_LISTENERS: list = []
# ``depth`` > 0 while this thread is inside a call to the backend: a backend
# that builds a collective from tensor operators (gloo's reduce-scatter) runs
# them there, and ``launch.op_analysis`` counts the collective by ``WIRE``,
# not by those operators
IN_BACKEND = threading.local()


@contextlib.contextmanager
def _backend():
    IN_BACKEND.depth = getattr(IN_BACKEND, "depth", 0) + 1
    try:
        yield
    finally:
        IN_BACKEND.depth -= 1


def _count(kind: str, nbytes: int, payload: int = 0, n: int = 1) -> None:
    WIRE.add(**{kind: 1, f"{kind}_bytes": nbytes})
    for fn in tuple(WIRE_LISTENERS):
        fn(kind, nbytes, payload, n)


def _alone(mesh: Mesh, axes: Axes, kind: str) -> bool:
    """Whether ``axes`` hold one rank, so that a collective over them is
    ``x`` itself: no copy and no call to the backend, but counted (0
    bytes) when the mesh names them, so that ``WIRE`` shows the path."""
    if mesh.size(axes) > 1:
        return False
    if mesh.axes(axes):
        _count(kind, 0)
    return True


def _all_reduce(x: torch.Tensor, axes: Axes, op, mesh: Optional[Mesh],
                kind: str = "all_reduce") -> torch.Tensor:
    mesh = _mesh(mesh)
    if _alone(mesh, axes, kind):
        return x
    n = mesh.size(axes)
    out = x.contiguous().clone()
    with _backend():
        dist.all_reduce(out, op=op, group=mesh.group(axes))
    _count(kind, 2 * _nbytes(out) * (n - 1) // n, _nbytes(out), n)
    return out


def psum(x: torch.Tensor, axes: Axes, mesh: Optional[Mesh] = None,
         kind: str = "all_reduce") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, on each of them
    (counted in ``WIRE`` under ``kind``)."""
    return _all_reduce(x, axes, dist.ReduceOp.SUM, mesh, kind)


def pmax(x: torch.Tensor, axes: Axes, mesh: Optional[Mesh] = None,
         kind: str = "all_reduce") -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of ``axes``."""
    return _all_reduce(x, axes, dist.ReduceOp.MAX, mesh, kind)


def psum_scatter(x: torch.Tensor, axes: Axes, mesh: Optional[Mesh] = None,
                 kind: str = "reduce_scatter") -> torch.Tensor:
    """``x`` (n, ...) summed over the n ranks of ``axes``; this rank gets
    row ``axis_index(axes)`` of the sum, (...) (``jax.lax.psum_scatter``
    with ``scatter_dimension=0, tiled=False``)."""
    mesh = _mesh(mesh)
    n = mesh.size(axes)
    if x.shape[0] != n:
        raise ValueError(f"psum_scatter over {n} ranks of a leading dim "
                         f"{x.shape[0]}")
    x = x.contiguous()
    if not mesh.axes(axes):
        return x[0].clone()
    out = x.new_empty(x.shape[1:])
    with _backend():
        _reduce_scatter(out.view(-1), x.view(-1), group=mesh.group(axes))
    _count(kind, _nbytes(out) * (n - 1), _nbytes(out), n)
    return out


def all_gather(x: torch.Tensor, axes: Axes, mesh: Optional[Mesh] = None,
               kind: str = "all_gather") -> torch.Tensor:
    """Every rank's ``x`` over ``axes``, stacked: (n, *x.shape), row i from
    the rank at index i (``jax.lax.all_gather``, ``tiled=False``)."""
    mesh = _mesh(mesh)
    if _alone(mesh, axes, kind):
        return x[None]
    n = mesh.size(axes)
    x = x.contiguous()
    out = x.new_empty((n,) + tuple(x.shape))
    with _backend():
        _all_gather(out.view(-1), x.view(-1), group=mesh.group(axes))
    _count(kind, _nbytes(out) * (n - 1) // n, _nbytes(out), n)
    return out


def all_to_all(x: torch.Tensor, axes: Axes, send: Sequence[int],
               recv: Sequence[int], kind: str,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Rows of ``x`` (dim 0) exchanged over the ranks of ``axes``: the
    first ``send[0]`` rows go to the rank at index 0, the next ``send[1]``
    to index 1, and so on; this rank gets ``recv[j]`` rows from the rank at
    index j, concatenated in rank order (``all_to_all_single`` with split
    sizes; counted in ``WIRE`` under ``kind``)."""
    mesh = _mesh(mesh)
    if _alone(mesh, axes, kind):
        return x
    n = mesh.size(axes)
    x = x.contiguous()
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    with _backend():
        dist.all_to_all_single(out, x, list(recv), list(send),
                               group=mesh.group(axes))
    _count(kind, _nbytes(out) * (n - 1) // n, _nbytes(out), n)
    return out


def barrier() -> None:
    """Wait for every rank of the world."""
    if dist.get_world_size() > 1:
        dist.barrier()


# ----------------------------------------------------- shards of a tensor --

def _dim_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shard(x: torch.Tensor, pspec: Spec, mesh: Optional[Mesh] = None
                ) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``pspec``: each dim
    that names axes cut into equal blocks, the rank's by its index along
    them (the block that ``NamedSharding(mesh, pspec).devices_indices_map``
    gives the device at this rank's coordinates).  A view where the cut
    allows it.  A dim that does not divide raises, as ``NamedSharding``
    does; every leaf of every arch divides on the meshes the port runs
    (``tests/test_torch_fsdp.py`` checks each arch on (2, 2) and (4, 1))."""
    mesh = _mesh(mesh)
    if len(pspec) > x.dim():
        raise ValueError(f"spec {pspec} for a {x.dim()}-d tensor")
    for d, entry in enumerate(pspec):
        axes = mesh.axes(_dim_axes(entry))
        n = mesh.size(axes)
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"over {axes} ({n} ranks)")
        size = x.shape[d] // n
        x = x.narrow(d, mesh.index(axes) * size, size)
    return x


def gather_shard(x: torch.Tensor, pspec: Spec, mesh: Optional[Mesh] = None,
                 kind: str = "all_gather") -> torch.Tensor:
    """The inverse of :func:`local_shard`: the whole tensor, on every rank,
    from each rank's block (one all-gather per dim that is cut, counted in
    ``WIRE`` under ``kind``; ``x`` itself where nothing is)."""
    mesh = _mesh(mesh)
    for d, entry in reversed(list(enumerate(pspec))):
        axes = mesh.axes(_dim_axes(entry))
        n = mesh.size(axes)
        if n == 1:
            continue
        g = all_gather(x, axes, mesh, kind)              # (n, ..., s_d, ...)
        x = g.movedim(0, d).flatten(d, d + 1) if d else g.flatten(0, 1)
    return x


def _sub(named, key):
    """The part of a tree of ``Named`` under ``key`` (one ``Named`` holds
    for the whole subtree it stands in)."""
    if isinstance(named, Named):
        return named
    return getattr(named, key) if hasattr(named, "_fields") else named[key]


def map_named(fn, tree, named):
    """``fn(leaf, Named)`` over a tree of dicts, lists, tuples and
    ``NamedTuple``s and a matching tree of ``Named``; ``None`` stays
    ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_named(fn, v, _sub(named, k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_named(fn, v, _sub(named, f))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_named(fn, v, _sub(named, i))
                          for i, v in enumerate(tree))
    return fn(tree, named)


def shard_tree(tree, named):
    """Each rank's block of every leaf of the whole ``tree``, by the
    matching tree of ``Named``: a tensor of its own, holding exactly the
    bytes its spec assigns (the counterpart of ``jax.device_put(tree,
    shardings)``)."""
    return map_named(lambda x, n: local_shard(x, n.spec, n.mesh).clone(
        memory_format=torch.contiguous_format), tree, named)


def gather_tree(blocks, named):
    """The whole tree, on every rank, from each rank's ``blocks`` (the
    inverse of :func:`shard_tree`)."""
    return map_named(lambda x, n: gather_shard(x, n.spec, n.mesh), blocks,
                      named)


# --------------------------------------------- differentiable collectives --
# A rank's gradient is the gradient of its own loss.  Where the ranks of an
# axis compute one loss together (the axis does not cut the batch), a region
# that each of them computes in part -- its experts, say -- is entered
# through ``copy_to`` and left through ``reduce_from`` (Megatron's "f" and
# "g"), so that every rank of the axis ends with the whole gradient of that
# loss, as the reference's shard_map gives.  Where the axis cuts the batch,
# each rank has a loss of its own: ``gather_to`` and ``scatter_from`` move
# its tokens into and out of a region over the axis, and each is the
# other's adjoint.  ``torch.distributed.nn.functional.all_reduce`` is not
# used: its backward all-reduces a cotangent that every rank already holds
# whole, which gives the gradient n times.

class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, kind):
        return psum(x, axes, mesh, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, kind):
        ctx.axes, ctx.mesh, ctx.kind = axes, mesh, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.axes, ctx.mesh, ctx.kind), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return all_gather(x, axes, mesh).reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        n = ctx.mesh.size(ctx.axes)
        return (psum_scatter(g.reshape((n, -1) + tuple(g.shape[1:])),
                             ctx.axes, ctx.mesh), None, None)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        n = mesh.size(axes)
        return psum_scatter(x.reshape((n, -1) + tuple(x.shape[1:])), axes,
                            mesh)

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g, ctx.axes, ctx.mesh)
                .reshape((-1,) + tuple(g.shape[1:])), None, None)


class _GatherGrad(torch.autograd.Function):
    """``x``'s block along dim 0 at this rank's index over ``axes``; the
    backward gathers every rank's block gradient, so that each rank holds
    the whole gradient of the tensor it cut."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        n = mesh.size(axes)
        size = x.shape[0] // n
        return x.narrow(0, mesh.index(axes) * size, size)

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g, ctx.axes, ctx.mesh)
                .reshape((-1,) + tuple(g.shape[1:])), None, None)


class _GatherDim(torch.autograd.Function):
    """Every rank's ``x`` over ``axes`` concatenated along ``dim``; the
    backward takes this rank's block of the cotangent, which every rank of
    ``axes`` holds whole (they compute one loss)."""

    @staticmethod
    def forward(ctx, x, axes, mesh, dim, kind):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        g = all_gather(x, axes, mesh, kind)                  # (n, ...)
        return g.movedim(0, dim).flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        n = ctx.mesh.size(ctx.axes)
        size = g.shape[ctx.dim] // n
        return (g.narrow(ctx.dim, ctx.mesh.index(ctx.axes) * size, size),
                None, None, None, None)


def reduce_from(x: torch.Tensor, axes: Axes, mesh: Optional[Mesh] = None,
                kind: str = "all_reduce") -> torch.Tensor:
    """psum forward, identity backward (Megatron's "g")."""
    return _Reduce.apply(x, axes, _mesh(mesh), kind)


def copy_to(x: torch.Tensor, axes: Axes, mesh: Optional[Mesh] = None,
            kind: str = "all_reduce") -> torch.Tensor:
    """Identity forward, psum backward (Megatron's "f")."""
    return _Copy.apply(x, axes, _mesh(mesh), kind)


def gather_from(x: torch.Tensor, axes: Axes, dim: int,
                mesh: Optional[Mesh] = None, kind: str = "all_gather"
                ) -> torch.Tensor:
    """Every rank's ``x`` over ``axes`` concatenated along ``dim`` (all
    ranks of ``axes`` computing one loss); the backward keeps the rank's
    block of the gradient."""
    dim = dim % x.dim()
    return _GatherDim.apply(x, axes, _mesh(mesh), dim, kind)


def gather_to(x: torch.Tensor, axes: Axes, mesh: Optional[Mesh] = None
              ) -> torch.Tensor:
    """Every rank's ``x`` over ``axes`` concatenated along dim 0; the
    backward sums the gradients and scatters the rank's block back."""
    return _Gather.apply(x, axes, _mesh(mesh))


def scatter_from(x: torch.Tensor, axes: Axes, mesh: Optional[Mesh] = None
                 ) -> torch.Tensor:
    """``x`` summed over ``axes`` and cut along dim 0, this rank's block;
    the backward gathers the blocks' gradients."""
    return _Scatter.apply(x, axes, _mesh(mesh))


def block_with_whole_grad(x: torch.Tensor, axes: Axes,
                          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's block of ``x`` along dim 0 over ``axes``, with the whole
    gradient of ``x`` on every rank of ``axes`` in the backward."""
    mesh = _mesh(mesh)
    if x.shape[0] % mesh.size(axes):
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over "
                         f"{mesh.axes(axes)}")
    return _GatherGrad.apply(x, axes, mesh)
