"""Per-(arch x shape) execution policy: the knobs a train or serve step
reads (batch sharding axes, microbatch count, optimizer-state dtype,
decode-cache length).

A port of ``repro.launch.policy``'s ``CellPolicy`` and ``tp_friendly``.
``cell_policy`` resolves a policy from a device mesh and waits, with
``launch/mesh.py``, for the mesh-bound paths; on one card a caller builds
the policy it needs (``CellPolicy((), n_micro, "float32", seq_len)``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class CellPolicy:
    batch_axes: Tuple[str, ...]     # mesh axes sharding the batch dim
    n_micro: int                    # gradient-accumulation steps (train)
    opt_state_dtype: str
    cache_len: int                  # decode cache length (window for SWA)
    seq_shard: bool = False         # decode KV cache sharded over 'model'
    notes: str = ""


def tp_friendly(cfg: ModelConfig) -> bool:
    """Attention heads divide the 16-way model axis."""
    return cfg.n_heads % 16 == 0
