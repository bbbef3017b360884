"""Per-(arch x shape x mesh) execution policy: the knobs a train or serve
step reads (batch sharding axes, microbatch count, optimizer-state dtype,
decode-cache length, seq-sharded decode).

A port of ``repro.launch.policy``.  ``cell_policy`` reads only a mesh's
``axis_names`` and its ``shape`` mapping (axis -> size), so it takes a
``sharding.Mesh`` or any stand-in with those two (the production meshes'
policies are evaluated without their 256 or 512 ranks).

TP-friendliness: archs whose head count divides the 16-way model axis shard
attention heads over 'model'; qwen2 (28H) and rwkv6 (40H) keep attention
head-local and instead fold the model axis into data parallelism when the
global batch allows.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig


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


def _axes_product(mesh_axes, axes: Tuple[str, ...]) -> int:
    sizes = dict(mesh_axes)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def cell_policy(cfg: ModelConfig, shape: ShapeConfig, mesh) -> CellPolicy:
    mesh_axes = tuple((a, mesh.shape[a]) for a in mesh.axis_names)
    dp_axes: Tuple[str, ...] = tuple(a for a in ("pod", "data")
                                     if a in mesh.axis_names)
    batch_axes = dp_axes
    # non-TP archs: absorb the model axis into data parallelism if divisible
    if not tp_friendly(cfg):
        cand = dp_axes + ("model",)
        if shape.global_batch % _axes_product(mesh_axes, cand) == 0:
            batch_axes = cand
    # inputs must shard evenly: trim axes until the batch divides
    while batch_axes and shape.global_batch % _axes_product(mesh_axes,
                                                            batch_axes):
        batch_axes = batch_axes[:-1]

    dp = _axes_product(mesh_axes, batch_axes)
    per_dev_seqs = max(shape.global_batch // dp, 1)

    # microbatching: target ~1 sequence per device per microbatch for >=50B
    # models at 4k, more for small models
    big = cfg.param_count() >= 5e10 if cfg.n_layers else False
    target = 1 if big else max(1, 8192 // max(shape.seq_len, 1))
    n_micro = (max(per_dev_seqs // max(target, 1), 1)
               if shape.kind == "train" else 1)

    opt_dtype = ("bfloat16" if (cfg.n_layers and cfg.param_count() >= 5e10)
                 else "float32")

    cache_len = shape.seq_len
    if cfg.attn_window and shape.kind == "decode":
        cache_len = min(cfg.attn_window, shape.seq_len)

    # flash-decoding: shard big attention caches over 'model' on the L axis
    has_attn_cache = not (cfg.ssm and cfg.ssm.kind == "rwkv6")
    seq_shard = (shape.kind == "decode" and has_attn_cache
                 and cache_len > 8192 and "model" in mesh.axis_names
                 and cache_len % mesh.shape.get("model", 1) == 0)

    notes = ""
    if not tp_friendly(cfg):
        notes = ("attention head-local (H % 16 != 0); model axis folded into "
                 f"DP where divisible (batch_axes={batch_axes})")
    return CellPolicy(batch_axes=batch_axes, n_micro=n_micro,
                      opt_state_dtype=opt_dtype, cache_len=cache_len,
                      seq_shard=seq_shard, notes=notes)
