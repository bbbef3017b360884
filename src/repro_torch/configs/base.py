"""Config system: model/shape/run configs + the arch registry.

A port of ``repro.configs.base`` as plain dataclasses with equal values.
Every assigned architecture registers a full-size ``ModelConfig`` (exact
public-literature dimensions) plus a ``smoke_config`` reduction used by CPU
tests.  ``input_specs`` gives the inputs of a step as ``meta`` tensors,
the counterpart of the reference's ``ShapeDtypeStruct`` stand-ins.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    n_shared: int = 0             # shared (always-on) experts
    first_dense: int = 0          # leading dense layers (deepseek)
    layer_period: int = 1         # MoE every k-th layer (jamba: 2)
    capacity_factor: float = 1.0
    aux_loss_weight: float = 0.001
    # EP dispatch: 'gspmd' lets the partitioner handle the capacity-buffer
    # scatter (baseline; materializes the buffer via all-reduce); 'shard_map'
    # builds each model-shard's local expert buffer manually (beyond-paper
    # §Perf optimization; no dispatch collective, combine = one psum).
    dispatch: str = "gspmd"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str                     # 'rwkv6' | 'mamba'
    d_state: int = 16             # mamba state / rwkv head dim
    expand: int = 2               # mamba inner expansion
    dt_rank: int = 0              # mamba delta rank (0 -> d_model//16)
    conv_width: int = 4
    attn_period: int = 0          # jamba: attention layer every k layers
    attn_offset: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0               # 0 -> d_model // n_heads
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    qkv_bias: bool = False
    attn_window: int = 0          # 0 = full attention; >0 = SWA
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    parallel_block: bool = False  # cohere: attn and mlp in parallel
    encoder_only: bool = False    # hubert: bidirectional, no decode
    external_embed: bool = False  # audio/vlm: frontend supplies embeddings
    cross_attn_period: int = 0    # vlm: cross-attn every k-th layer
    n_vision_tokens: int = 0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    mtp_depth: int = 0            # deepseek-v3 multi-token prediction heads
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # decode-time runtime knobs (set by launch/policy per cell)
    seq_shard_decode: bool = False
    decode_batch_axes: Tuple[str, ...] = ("pod", "data")
    # HP-MDR on the KV cache: store K/V as int8 fixed point aligned at a
    # static exponent (the paper's alignment trick on serving state) ->
    # halves the decode memory term vs bf16.  0 = off; else the alignment
    # scale (values clipped to [-scale, scale]).
    kv_cache_int8_scale: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Total parameters (analytic)."""
        from repro_torch.models.model import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params
        return count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Per-(arch x shape) execution knobs."""
    microbatch: int = 0           # 0 -> auto (per-device batch 1)
    opt_state_dtype: str = "float32"
    remat_policy: str = "full"    # full | dots | none
    grad_compress_planes: int = 0 # 0 = off; else top-P plane-groups
    seq_shard_decode: bool = False


ARCH_REGISTRY: Dict[str, str] = {
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube_3_4b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "llama-3.2-vision-90b": "repro_torch.configs.llama32_vision_90b",
    "hpmdr-field": "repro_torch.configs.hpmdr_field",  # the paper's own workload
}


def list_archs() -> List[str]:
    return [a for a in ARCH_REGISTRY if a != "hpmdr-field"]


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(ARCH_REGISTRY[arch])
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(ARCH_REGISTRY[arch])
    return mod.SMOKE


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Skip rules from DESIGN.md §7."""
    if cfg.encoder_only and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k":
        subquadratic = (cfg.ssm is not None) or cfg.attn_window > 0
        if not subquadratic:
            return False, "pure full-attention arch skips long_500k"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dp: int = 1) -> Dict[str, torch.Tensor]:
    """``meta`` tensors standing in for every input of a step: the
    reference's keys, shapes and dtypes."""
    b, s = shape.global_batch, shape.seq_len

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    specs: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        if cfg.external_embed:
            specs["embeds"] = sds((b, s, cfg.d_model), torch.bfloat16)
        else:
            specs["tokens"] = sds((b, s), torch.int32)
        specs["labels"] = sds((b, s), torch.int32)
    elif shape.kind == "prefill":
        if cfg.external_embed:
            specs["embeds"] = sds((b, s, cfg.d_model), torch.bfloat16)
        else:
            specs["tokens"] = sds((b, s), torch.int32)
    else:  # decode: one new token against a seq_len-deep cache
        specs["tokens"] = sds((b, 1), torch.int32)
    if cfg.cross_attn_period:
        specs["vision_states"] = sds((b, cfg.n_vision_tokens, cfg.d_model),
                                     torch.bfloat16)
    return specs
