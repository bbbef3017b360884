"""Chunked dataset writer: arrays -> refactor pipeline -> addressable store.

A port of ``repro.store.writer``: the same segment bytes, offsets, CRCs and
manifest (segment file names carry a random generation token in both).
Chunks are refactored on ``device`` (``None`` means ``cuda``) or on the
devices of ``mesh`` (``core.sharded``).

``DatasetWriter`` drives ``core.refactor.refactor_array`` through the
``ChunkedRefactorPipeline`` (copy/compute/serialize overlap) with a custom
sink that appends each chunk's segments to the variable's segment file and
records their byte ranges — so writing a larger-than-memory array streams
chunk by chunk and never holds more than the pipeline's queue depth.

The manifest is written atomically (tmp + rename) on ``finalize()``/context
exit, so a crashed write never leaves a store that parses but dangles.
"""
from __future__ import annotations

import json
import logging
import os
from typing import List, Optional

import numpy as np

from repro_torch import tune as tn
from repro_torch.core import decompose as dc
from repro_torch.core import lossless as ll
from repro_torch.core import pipeline as pl
from repro_torch.core import refactor as rf
from repro_torch.core import sharded as shd
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.store import layout as lo
from repro_torch.tune.config import REFERENCE_BACKENDS

logger = logging.getLogger("repro_torch.store")

# the port's backend names -> the reference's, for manifests: the inverse of
# REFERENCE_BACKENDS, where "jnp" (not "pallas_interpret") names the plain
# version
_MANIFEST_BACKENDS = {port: ref for ref, port in REFERENCE_BACKENDS.items()
                      if ref != "pallas_interpret"}


def plan_json(config: tn.RefactorConfig) -> dict:
    """A variable's manifest ``plan``: ``config.to_json()`` with the backend
    in the reference's spelling (``cuda`` -> ``pallas``, ``torch`` ->
    ``jnp``), so a port-written manifest matches the reference's key for key
    and the reference decodes it; ``RefactorConfig.from_json`` maps it back.
    """
    plan = config.to_json()
    plan["backend"] = _MANIFEST_BACKENDS[plan["backend"]]
    return plan


class _SegmentFileWriter:
    """Appending writer for one variable's segment file."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(path, "wb")
        self._off = 0

    def write(self, blob: bytes) -> int:
        off = self._off
        self._f.write(blob)
        self._off += len(blob)
        return off

    def close(self) -> None:
        self._f.flush()
        self._f.close()


class DatasetWriter:
    """Write variables into a progressive store directory.

        with DatasetWriter("/data/run42", chunk_elems=1 << 20) as w:
            w.write("vx", vx)
            w.write("vy", vy)
        store = DatasetStore.open("/data/run42")

    One variable = one segment file; chunks, pieces and plane groups land at
    recorded offsets.  ``levels=None`` picks the decomposition depth from the
    (flattened) chunk length per variable.
    """

    def __init__(self, root: str, chunk_elems: int = 1 << 20,
                 levels: Optional[int] = None,
                 design: Optional[str] = None,
                 mag_bits: Optional[int] = None,
                 hybrid: Optional[ll.HybridConfig] = None,
                 pipelined: bool = True, backend: Optional[str] = None,
                 fused: bool = True, dispatch_ahead: Optional[int] = None,
                 mesh: shd.MeshLike = None,
                 config: Optional[tn.RefactorConfig] = None,
                 use_tune_cache: bool = True,
                 checksums: bool = True,
                 device: DeviceLike = None):
        self.root = root
        self.device = resolve_device(device)
        self.chunk_elems = int(chunk_elems)
        self.levels = levels
        # knob resolution happens per write() in ChunkedRefactorPipeline
        # (explicit kwargs > config= > cached autotuned winner > defaults);
        # the writer just forwards, then records the pipeline's EFFECTIVE
        # config as the variable's manifest ``plan`` so readers replay it.
        self.design = design
        self.mag_bits = mag_bits
        self.hybrid = hybrid
        self.pipelined = pipelined
        self.backend = backend
        # fused one-dispatch write engine + per-device in-flight encode
        # depth: the pipelined write keeps dispatch_ahead chunks queued per
        # mesh device and drains whole windows through one batched finish
        # (see core.refactor_fused.finish_encode_many)
        self.fused = fused
        self.dispatch_ahead = dispatch_ahead
        self.config = config
        self.use_tune_cache = use_tune_cache
        # per-(chunk, piece, group) CRCs in the manifest; False writes a
        # pre-integrity store (old readers are unaffected either way)
        self.checksums = checksums
        # mesh-sharded write (core.sharded): chunks round-robin across the
        # mesh's devices; the chunk -> shard map is recorded per variable in
        # the manifest.  Payload bytes are placement-independent (the
        # single-device-oracle guarantee).
        self.mesh = shd.resolve_mesh(mesh, self.device)
        self._finalized = False
        self._written: set = set()
        os.makedirs(root, exist_ok=True)
        # start from the committed manifest (if any), so writing into an
        # existing store adds/replaces variables instead of dropping the rest
        committed = os.path.join(root, lo.MANIFEST_NAME)
        if os.path.exists(committed):
            with open(committed) as f:
                self.manifest = lo.Manifest.from_json(json.load(f))
        else:
            self.manifest = lo.Manifest()

    # ------------------------------------------------------------- writing --
    def write(self, name: str, x: np.ndarray) -> lo.VariableEntry:
        if self._finalized:
            raise RuntimeError("writer already finalized")
        if not name or "/" in name or name.startswith("."):
            raise ValueError(f"invalid variable name {name!r}")
        # duplicate names within one writer session are an error (a second
        # write would silently replace the first's manifest entry and orphan
        # its segments); a name only present in the COMMITTED manifest is a
        # REWRITE — the new generation replaces it when finalize() commits
        if name in self._written:
            raise ValueError(f"variable {name!r} already written")
        x = np.asarray(x, dtype=np.float32)
        shape = tuple(int(s) for s in x.shape)
        # NB: ascontiguousarray promotes 0-d to 1-d, hence shape captured first
        flat = np.ascontiguousarray(x).reshape(-1)
        levels = self.levels
        if levels is None:
            levels = dc.num_levels((min(self.chunk_elems, max(flat.size, 1)),))
        chunks: List[lo.ChunkEntry] = []
        # per-write generation token: rewriting an existing store never
        # truncates a file the currently-committed manifest addresses
        seg_key = lo.segment_key(name, generation=os.urandom(4).hex())
        seg_writer = _SegmentFileWriter(lo.segment_path(self.root, seg_key))

        def sink(ci: int, refd: rf.Refactored) -> bytes:
            # chunks reach the sink in index order (pipeline contract), so
            # append order == chunk order and offsets are deterministic.
            chunks.append(lo.chunk_entry_from_refactored(
                refd, seg_writer.write, checksums=self.checksums))
            return b""  # the pipeline's blob list is unused on this path

        pipe = pl.ChunkedRefactorPipeline(
            chunk_elems=self.chunk_elems, pipelined=self.pipelined,
            levels=levels, design=self.design, hybrid=self.hybrid,
            backend=self.backend, mag_bits=self.mag_bits, sink=sink,
            fused=self.fused, dispatch_ahead=self.dispatch_ahead,
            mesh=self.mesh, config=self.config,
            use_tune_cache=self.use_tune_cache, device=self.device)
        try:
            with obs_trace.span("store.write", var=name):
                pipe.refactor(flat, name=name)
        finally:
            seg_writer.close()

        # manifest fields record the EFFECTIVE knobs the pipeline resolved
        # (legacy kwargs > config= > tune cache > defaults), and ``plan``
        # captures the full config so readers replay the tuned plan
        entry = lo.VariableEntry(
            name=name, shape=shape, levels=levels,
            design=pipe.design,
            mag_bits=pipe.config.resolved_mag_bits(),
            group_size=pipe.hybrid.group_size, chunk_elems=self.chunk_elems,
            segment_file=seg_key,
            amax=float(np.abs(x).max()) if x.size else 0.0,
            range=float(x.max() - x.min()) if x.size else 0.0,
            chunks=chunks,
            shards=(pipe.chunk_shards(len(chunks))
                    if self.mesh is not None else None),
            plan=plan_json(pipe.config))
        self.manifest.variables[name] = entry
        self._written.add(name)
        # compression accounting: raw input bytes vs bytes landed in the
        # segment file (payloads + per-group headers).  ratio >= 1 is a win.
        raw, stored = int(flat.nbytes), int(entry.stored_bytes)
        m = obs_metrics.REGISTRY.get()
        m.inc("store.bytes_raw", raw, var=name)
        m.inc("store.bytes_stored", stored, var=name)
        if stored:
            m.gauge("store.compression_ratio", raw / stored, var=name)
        if stored > raw:
            logger.warning(
                "store write of %r EXPANDED the data: stored %d bytes for "
                "%d raw bytes (ratio %.3f < 1.0) — the lossless stage is "
                "losing to the bitplane/group framing on this input", name,
                stored, raw, raw / max(stored, 1))
        return entry

    # ----------------------------------------------------------- finalize --
    def finalize(self) -> str:
        if self._finalized:
            return os.path.join(self.root, lo.MANIFEST_NAME)
        path = os.path.join(self.root, lo.MANIFEST_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.manifest.to_json(), f)
        os.replace(tmp, path)
        self._finalized = True
        return path

    def __enter__(self) -> "DatasetWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.finalize()
