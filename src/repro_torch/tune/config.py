"""RefactorConfig — the single source of truth for every tuning knob.

A port of ``repro.tune.config``: one frozen, hashable, JSON-round-trippable
dataclass collecting the kernel knobs, the encode-chain knobs, the lossless
bucket policy and the pipeline knobs.  Consuming layers accept ``config=``
alongside their legacy kwargs; explicit legacy kwargs override the
corresponding config fields (``as_config`` normalizes both spellings into
one config).

Backends are the port's: ``auto`` (the CUDA kernel for CUDA tensors, the
plain torch version for CPU tensors), ``cuda`` and ``torch``.  A config
written by the reference package loads through ``from_json``, which maps its
backend values (``pallas`` -> ``cuda``, ``jnp``/``pallas_interpret`` ->
``torch``) and ignores unknown keys.

This module stays import-light (torch only inside methods that need it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

BACKENDS = ("auto", "cuda", "torch")

# backend values of the reference package -> the port's
REFERENCE_BACKENDS = {"auto": "auto", "pallas": "cuda", "jnp": "torch",
                      "pallas_interpret": "torch"}


@dataclasses.dataclass(frozen=True)
class RefactorConfig:
    """One tuned plan for the whole refactor chain.

    Fields with ``None`` defer to the consuming layer's default (``mag_bits``
    -> ``align.DEFAULT_MAG_BITS``, ``chunk_elems`` -> the pipeline's 1<<20,
    ``mesh_devices`` -> single-device)."""

    # --- kernel knobs (kernels/bitplane.py via kernels/ops.py); the CUDA
    # kernels have one blocking and one transpose, so tiles_per_block and
    # unroll are carried for the reference's configs and select nothing ---
    design: str = "register_block"
    tiles_per_block: int = 8
    unroll: str = "butterfly"
    # --- encode-chain knobs (core/refactor_fused.py, core/align.py) ---
    mag_bits: Optional[int] = None
    # --- lossless bucket policy (core/lossless.py, core/lossless_batch.py) ---
    group_size: int = 4
    size_threshold: int = 4096
    cr_threshold: float = 1.0
    # --- pipeline / mesh knobs: carried so that configs round-trip through
    # JSON unchanged; nothing in the port reads them until the pipeline
    # slice ---
    dispatch_ahead: int = 2
    depth: int = 2
    chunk_elems: Optional[int] = None
    mesh_devices: Optional[int] = None
    # --- backend selection (kernels/ops._use_kernel) ---
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} (expected "
                             f"one of {BACKENDS})")

    # ------------------------------------------------------------- derived --
    def resolved_mag_bits(self) -> int:
        if self.mag_bits is not None:
            return self.mag_bits
        from repro_torch.core import align as al  # local: keep import-light
        return al.DEFAULT_MAG_BITS

    def hybrid(self, force: Optional[str] = None):
        """The lossless engine's ``HybridConfig`` view of this config."""
        from repro_torch.core import lossless as ll  # local: import-light
        return ll.HybridConfig(group_size=self.group_size,
                               size_threshold=self.size_threshold,
                               cr_threshold=self.cr_threshold,
                               force=force)

    # ---------------------------------------------------------------- json --
    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, j: Dict[str, Any]) -> "RefactorConfig":
        """Build from a JSON dict, ignoring unknown keys (manifests written
        by future versions must stay readable) and mapping the reference
        package's backend values onto the port's."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in j.items() if k in names}
        if "backend" in kw:
            b = kw["backend"]
            if b not in REFERENCE_BACKENDS and b not in BACKENDS:
                raise ValueError(f"unknown backend {b!r}")
            kw["backend"] = REFERENCE_BACKENDS.get(b, b)
        return cls(**kw)


DEFAULT_CONFIG = RefactorConfig()


def as_config(config: Optional[RefactorConfig] = None, *,
              design: Optional[str] = None,
              mag_bits: Optional[int] = None,
              hybrid=None,
              backend: Optional[str] = None) -> RefactorConfig:
    """Normalize a ``config=`` argument plus legacy loose kwargs into ONE
    effective ``RefactorConfig``.

    Explicit (non-None) legacy kwargs override the base config's fields —
    the most local spelling wins.  ``hybrid.force`` is intentionally NOT part
    of the config (it is a benchmark/debug override, not a tunable); callers
    that honor it pass it back through ``cfg.hybrid(force=...)``."""
    base = config if config is not None else DEFAULT_CONFIG
    upd: Dict[str, Any] = {}
    if design is not None:
        upd["design"] = design
    if mag_bits is not None:
        upd["mag_bits"] = mag_bits
    if hybrid is not None:
        upd["group_size"] = hybrid.group_size
        upd["size_threshold"] = hybrid.size_threshold
        upd["cr_threshold"] = hybrid.cr_threshold
    if backend is not None:
        upd["backend"] = backend
    return dataclasses.replace(base, **upd) if upd else base
