"""On-disk dataset layout: one JSON manifest + per-variable segment files.

A port of ``repro.store.layout``: the same format string, manifest keys and
segment framing, so a store written by either package opens in the other.

Directory structure::

    <root>/
      manifest.json            # everything but payload bytes (see Manifest)
      segments/<var>.seg       # concatenated ll.Segment.to_bytes() blobs

The manifest records, per variable, per chunk, per piece: the error-model
parameters (element count, alignment exponent, recomposition weight) and the
byte range + lossless method of every merged plane group (and of the sign
segment).  A reader therefore plans greedy rate allocation and issues exact
byte-range reads without ever deserializing segments it does not need —
the unit of I/O is one (chunk, piece, group) range, the same granularity as
MDR's incremental retrieval.

``chunk_refactored`` materializes a payload-free ``core.refactor.Refactored``
(stub segments carry ``meta["stored_bytes"]``) that plugs straight into
``core.retrieve.ProgressiveReader`` with a store-backed ``SegmentSource``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

from repro_torch.core import lossless as ll
from repro_torch.core import refactor as rf
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.store import backend as bk
from repro_torch.store import reliability as rl

MANIFEST_NAME = "manifest.json"
SEGMENT_DIR = "segments"
FORMAT = "repro.store/v1"


@dataclasses.dataclass(frozen=True)
class GroupRef:
    """Byte-range address of one stored segment.

    ``crc`` is the CRC-32 of the stored blob (``reliability.checksum``),
    recorded at write time and verified on every backend read — so a flipped
    byte anywhere in the range surfaces as a typed ``CorruptSegmentError``
    at the exact (chunk, piece, group) that rotted, instead of as a decode
    crash or (for dc/store-raw payloads, which have no framing of their own)
    silently wrong data.  Compatibility mirrors ``shards``/``plan``: absent
    (None, pre-checksum stores) means unchecked; serialized as an optional
    4th list element that pre-checksum readers never look at."""
    offset: int
    size: int
    method: str
    crc: Optional[int] = None

    def to_json(self) -> List:
        if self.crc is None:
            return [self.offset, self.size, self.method]
        return [self.offset, self.size, self.method, self.crc]

    @staticmethod
    def from_json(j: List) -> "GroupRef":
        crc = int(j[3]) if len(j) > 3 and j[3] is not None else None
        return GroupRef(int(j[0]), int(j[1]), str(j[2]), crc)


@dataclasses.dataclass
class PieceEntry:
    n: int                       # elements in the piece
    exponent: int                # alignment exponent (error model)
    weight: float                # recomposition weight (error model)
    n_words: int                 # uint32 words per plane
    group_planes: List[int]      # planes per merged group, MSB first
    sign: GroupRef
    groups: List[GroupRef]

    def to_json(self) -> Dict:
        return {"n": self.n, "exponent": self.exponent, "weight": self.weight,
                "n_words": self.n_words, "group_planes": self.group_planes,
                "sign": self.sign.to_json(),
                "groups": [g.to_json() for g in self.groups]}

    @staticmethod
    def from_json(j: Dict) -> "PieceEntry":
        return PieceEntry(
            n=int(j["n"]), exponent=int(j["exponent"]),
            weight=float(j["weight"]), n_words=int(j["n_words"]),
            group_planes=[int(g) for g in j["group_planes"]],
            sign=GroupRef.from_json(j["sign"]),
            groups=[GroupRef.from_json(g) for g in j["groups"]])


@dataclasses.dataclass
class ChunkEntry:
    n_elements: int
    amax: float                  # chunk max |x| (error model)
    range: float                 # chunk value range (relative tolerances)
    pieces: List[PieceEntry]

    @property
    def stored_bytes(self) -> int:
        return sum(p.sign.size + sum(g.size for g in p.groups)
                   for p in self.pieces)

    def to_json(self) -> Dict:
        return {"n_elements": self.n_elements, "amax": self.amax,
                "range": self.range,
                "pieces": [p.to_json() for p in self.pieces]}

    @staticmethod
    def from_json(j: Dict) -> "ChunkEntry":
        return ChunkEntry(
            n_elements=int(j["n_elements"]), amax=float(j["amax"]),
            range=float(j["range"]),
            pieces=[PieceEntry.from_json(p) for p in j["pieces"]])


@dataclasses.dataclass
class VariableEntry:
    name: str
    shape: Tuple[int, ...]
    levels: int
    design: str
    mag_bits: int
    group_size: int
    chunk_elems: int
    segment_file: str            # key relative to the store root
    amax: float                  # global max |x| over the variable
    range: float                 # global max(x) - min(x)
    chunks: List[ChunkEntry]
    # chunk -> shard ordinal of the mesh the variable was written on
    # (core.sharded round-robin).  Purely a placement HINT for readers —
    # payload bytes are placement-independent (single-device-oracle
    # guarantee), and absent (None) means single-device.  Readers take it
    # modulo their own mesh size, so N-device stores read fine on M devices.
    shards: Optional[List[int]] = None
    # the effective RefactorConfig the variable was WRITTEN with
    # (RefactorConfig.to_json(), backend in the reference's spelling, see
    # store.writer.plan_json): readers replay the tuned plan — decode
    # backend, overlap depth — instead of re-guessing defaults.  Absent
    # (None) on stores written before autotuning existed; the authoritative
    # quality fields (design/mag_bits/group_size) above stay where they
    # always were, the plan only adds the perf knobs.
    plan: Optional[Dict] = None

    @property
    def n_elements(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n

    @property
    def stored_bytes(self) -> int:
        return sum(c.stored_bytes for c in self.chunks)

    def to_json(self) -> Dict:
        out = {"name": self.name, "shape": list(self.shape),
               "levels": self.levels, "design": self.design,
               "mag_bits": self.mag_bits, "group_size": self.group_size,
               "chunk_elems": self.chunk_elems,
               "segment_file": self.segment_file,
               "amax": self.amax, "range": self.range,
               "chunks": [c.to_json() for c in self.chunks]}
        if self.shards is not None:
            out["shards"] = list(self.shards)
        if self.plan is not None:
            out["plan"] = dict(self.plan)
        return out

    @staticmethod
    def from_json(j: Dict) -> "VariableEntry":
        # unknown keys in j are ignored (forward compatibility: stores
        # written by newer code must stay readable), and optional keys
        # (shards, plan) may be absent (backward compatibility: pre-shards /
        # pre-plan stores load and serve)
        shards = j.get("shards")
        plan = j.get("plan")
        return VariableEntry(
            name=str(j["name"]), shape=tuple(int(s) for s in j["shape"]),
            levels=int(j["levels"]), design=str(j["design"]),
            mag_bits=int(j["mag_bits"]), group_size=int(j["group_size"]),
            chunk_elems=int(j["chunk_elems"]),
            segment_file=str(j["segment_file"]),
            amax=float(j["amax"]), range=float(j["range"]),
            chunks=[ChunkEntry.from_json(c) for c in j["chunks"]],
            shards=None if shards is None else [int(s) for s in shards],
            plan=None if plan is None else dict(plan))


@dataclasses.dataclass
class Manifest:
    variables: Dict[str, VariableEntry] = dataclasses.field(default_factory=dict)

    @property
    def stored_bytes(self) -> int:
        return sum(v.stored_bytes for v in self.variables.values())

    def to_json(self, integrity: bool = True) -> Dict:
        """``integrity=True`` (what the writer commits) adds a ``"crc32"``
        key over the canonical serialization of ``variables`` — a flipped
        byte anywhere in the manifest body then fails ``from_json`` with a
        typed error instead of silently rewriting offsets, sizes, or error-
        model metadata.  Old readers ignore the unknown key (forward
        compatible); manifests without it load unchecked (backward
        compatible), same rules as ``shards``/``plan``."""
        vars_json = {k: v.to_json() for k, v in self.variables.items()}
        out = {"format": FORMAT, "variables": vars_json}
        if integrity:
            out["crc32"] = rl.manifest_body_checksum(vars_json)
        return out

    @staticmethod
    def from_json(j: Dict) -> "Manifest":
        if j.get("format") != FORMAT:
            raise ValueError(f"unsupported store format: {j.get('format')!r}")
        vars_json = j.get("variables", {})
        if "crc32" in j:
            got = rl.manifest_body_checksum(vars_json)
            if got != (int(j["crc32"]) & 0xFFFFFFFF):
                raise rl.CorruptSegmentError(
                    f"manifest integrity check failed: stored "
                    f"crc32=0x{int(j['crc32']) & 0xFFFFFFFF:08x}, computed "
                    f"0x{got:08x} over the variables body")
        return Manifest({k: VariableEntry.from_json(v)
                         for k, v in vars_json.items()})


# --------------------------------------------------------------- chunk meta --

def chunk_entry_from_refactored(refd: rf.Refactored, write,
                                checksums: bool = True) -> ChunkEntry:
    """Serialize one chunk's segments through ``write(blob) -> offset`` (an
    appending writer returning the blob's start offset) and build its entry.

    Uses the canonical ``rf.iter_segments`` stream order, so offsets address
    the same bytes ``refactored_to_bytes`` would have produced segment-wise.
    ``checksums=True`` records each blob's CRC-32 on its ``GroupRef`` so
    readers verify every byte-range read (see ``repro_torch.store.reliability``).
    """
    meta = rf.refactored_meta(refd)
    refs: List[List[Optional[GroupRef]]] = [
        [None] * (1 + len(p.groups)) for p in refd.pieces]
    for pi, kind, gi, seg in rf.iter_segments(refd):
        blob = seg.to_bytes()
        off = write(blob)
        slot = 0 if kind == "sign" else 1 + gi
        refs[pi][slot] = GroupRef(off, len(blob), seg.method,
                                  rl.checksum(blob) if checksums else None)
    pieces = []
    for pi, pm in enumerate(meta["pieces"]):
        pieces.append(PieceEntry(
            n=pm["n"], exponent=pm["exponent"], weight=pm["weight"],
            n_words=pm["n_words"], group_planes=pm["group_planes"],
            sign=refs[pi][0], groups=refs[pi][1:]))
    return ChunkEntry(n_elements=refd.n_elements, amax=refd.data_amax,
                      range=refd.data_range, pieces=pieces)


def _stub(ref_: GroupRef, n_planes: int, n_words: int) -> ll.Segment:
    return ll.Segment(ref_.method, 0, payload={},
                      meta={"stored_bytes": ref_.size, "n_planes": n_planes,
                            "n_words": n_words})


def chunk_refactored(var: VariableEntry, ci: int) -> rf.Refactored:
    """Payload-free ``Refactored`` for chunk ``ci`` (planner-ready stubs)."""
    ch = var.chunks[ci]
    meta = {
        "name": f"{var.name}.{ci}", "shape": [ch.n_elements],
        "levels": var.levels, "design": var.design,
        "mag_bits": var.mag_bits, "group_size": var.group_size,
        "amax": ch.amax, "range": ch.range,
        "pieces": [p.to_json() for p in ch.pieces],
    }

    def segments(pi: int, kind: str, gi: int) -> ll.Segment:
        p = ch.pieces[pi]
        if kind == "sign":
            return _stub(p.sign, 1, p.n_words)
        return _stub(p.groups[gi], p.group_planes[gi], p.n_words)

    return rf.refactored_from_meta(meta, segments)


# -------------------------------------------------------------------- store --

class DatasetStore:
    """Read-side handle on a stored dataset: manifest + byte-range reads.

    ``backend`` is any ``repro_torch.store.backend.FetchBackend``; by default
    a ``LocalFileBackend`` rooted at the store directory wrapped in a
    ``CachingBackend`` (LRU segment cache + async prefetch queue).  When the
    ``REPRO_CHAOS`` env var is set (the CI chaos job), the default file
    backend is additionally wrapped in a seeded ``FaultInjectionBackend`` +
    ``RetryingBackend`` — so ordinary test suites exercise the whole read
    stack under injected faults with zero test changes.

    ``verify=True`` (default) checks the recorded CRC-32 of every segment
    read (``GroupRef.crc``); pre-checksum stores carry no CRCs and read
    unchecked, exactly as before.

    ``device`` is where services opened on this store decode by default
    (``None`` means ``cuda``, see ``repro_torch.device``); the store itself
    only moves bytes on the host."""

    def __init__(self, manifest: Manifest, backend: bk.FetchBackend,
                 verify: bool = True, device: DeviceLike = None):
        self.manifest = manifest
        self.backend = backend
        self.verify = verify
        self.device = resolve_device(device)

    @classmethod
    def open(cls, root: str, backend: Optional[bk.FetchBackend] = None,
             cache_bytes: int = 64 << 20,
             prefetch_workers: int = 2, verify: bool = True,
             device: DeviceLike = None) -> "DatasetStore":
        device = resolve_device(device)  # raise before any thread starts
        if backend is None:
            backend = bk.CachingBackend(
                rl.chaos_from_env(bk.LocalFileBackend(root)),
                capacity_bytes=cache_bytes,
                workers=prefetch_workers)
        raw = backend.read(MANIFEST_NAME, 0, backend.size(MANIFEST_NAME))
        return cls(Manifest.from_json(json.loads(raw.decode())), backend,
                   verify=verify, device=device)

    @property
    def variables(self) -> List[str]:
        return list(self.manifest.variables)

    def variable(self, name: str) -> VariableEntry:
        return self.manifest.variables[name]

    @property
    def stored_bytes(self) -> int:
        return self.manifest.stored_bytes

    # -- raw segment access -------------------------------------------------
    def read_segment(self, var: str, ref_: GroupRef) -> ll.Segment:
        v = self.manifest.variables[var]
        blob = self.backend.read(v.segment_file, ref_.offset, ref_.size)
        if len(blob) != ref_.size:
            raise rl.TruncatedReadError(
                f"backend returned {len(blob)} bytes for "
                f"{v.segment_file}@{ref_.offset}+{ref_.size}")
        if self.verify and ref_.crc is not None:
            rl.verify_checksum(
                blob, ref_.crc,
                context=f"{v.segment_file}@{ref_.offset}+{ref_.size}")
        return ll.Segment.from_bytes(blob)

    def prefetch_segment(self, var: str, ref_: GroupRef) -> None:
        v = self.manifest.variables[var]
        self.backend.prefetch(v.segment_file, ref_.offset, ref_.size)

    def stats(self) -> Optional[bk.BackendStats]:
        return getattr(self.backend, "stats", None)

    def close(self) -> None:
        self.backend.close()

    def __enter__(self) -> "DatasetStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def segment_key(var: str, generation: Optional[str] = None) -> str:
    """Backend key (store-root-relative path) of a variable's segment file.

    Writers pass a per-write ``generation`` token so rewriting a variable in
    an existing store never touches bytes an older manifest addresses: the
    old manifest keeps pointing at the old file until the new manifest is
    atomically renamed into place (crash -> old store still consistent;
    leftover orphan generations are harmless)."""
    gen = f"-{generation}" if generation else ""
    return f"{SEGMENT_DIR}/{var}{gen}.seg"


def segment_path(root: str, key_or_var: str) -> str:
    """Absolute path for a backend key (or bare variable name)."""
    if "/" not in key_or_var:
        key_or_var = segment_key(key_or_var)
    return os.path.join(root, *key_or_var.split("/"))
