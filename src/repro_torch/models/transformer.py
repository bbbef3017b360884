"""Layer-stack composition: pattern-based blocks repeated over depth.

A port of ``repro.models.transformer``.  Architectures are a list of *stack
groups*; each group repeats a pattern of sub-layers with stacked parameters
(a leading ``repeats`` axis on every leaf, as in the reference), and
``stack_apply`` loops over that axis in Python:

  uniform        N x [attn/ssm + mlp]                (most archs)
  first_dense    K x dense-FFN block, (N-K) x MoE    (deepseek v2/v3)
  jamba          (N/8) x [8-layer period: 1 attn + 7 mamba, MoE every 2nd]
  vision_cross   (N/5) x [4 self-attn + 1 gated cross-attn]

Caches are stacked the same way.  Prefill builds them; decode updates the
stacked cache in place; the forward and the loss build none.  With
``cfg.remat``, and when autograd records, each repeat runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` around its
scan step): the backward pass keeps only each repeat's input and
recomputes the rest.  A stacked leaf is ``unbind``-ed once per group, so
the backward pass stacks the repeats' gradients once instead of adding a
full-size gradient per repeat.

With ``shardings`` (each stacked leaf's ``sharding.Named``) the tree holds
each rank's blocks, and repeat ``r``'s block of a leaf is ``block[r]``
(a stacked spec's leading entry is ``None``); ``_repeat_apply`` gathers a
repeat's leaves whole (``distributed.fsdp.gather_param``) inside the
function that ``checkpoint`` wraps, so that under remat no gathered weight
outlives its repeat and the backward gathers again.  Where 'model' does
not cut the batch (``distributed.tp.context``) the leaves that the specs
cut over 'model' are gathered over their other axes only and the layers
compute on the blocks (``tp`` below); RWKV's time mix gathers its own
whole over 'model' (``distributed.tp.whole``).  Mamba returns its rank's
channels of the decode state, gathered whole here only where a cache
keeps it (a prefill that builds the caches, a decode step).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp as TP
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.params import PSpec, tree_map


# --------------------------------------------------------- block templates --

def _norm_spec(cfg: ModelConfig) -> PSpec:
    return PSpec((cfg.d_model,), (None,), init="ones")


def block_abstract(cfg: ModelConfig, kind: str) -> Dict:
    """Parameter tree for one block of the given kind."""
    p: Dict[str, Any] = {"norm1": _norm_spec(cfg)}
    if kind == "attn":
        p["attn"] = L.mla_abstract(cfg) if cfg.mla else L.gqa_abstract(cfg)
        if not cfg.parallel_block:
            p["norm2"] = _norm_spec(cfg)
        p["mlp"] = L.mlp_abstract(cfg)
    elif kind == "attn_moe":
        p["attn"] = L.mla_abstract(cfg) if cfg.mla else L.gqa_abstract(cfg)
        p["norm2"] = _norm_spec(cfg)
        p["moe"] = MOE.moe_abstract(cfg)
    elif kind == "rwkv":
        p["tmix"] = SSM.rwkv_time_mix_abstract(cfg)
        p["norm2"] = _norm_spec(cfg)
        p["cmix"] = SSM.rwkv_channel_mix_abstract(cfg)
    elif kind == "mamba":
        p["mamba"] = SSM.mamba_abstract(cfg)
        p["norm2"] = _norm_spec(cfg)
        p["mlp"] = L.mlp_abstract(cfg)
    elif kind == "mamba_moe":
        p["mamba"] = SSM.mamba_abstract(cfg)
        p["norm2"] = _norm_spec(cfg)
        p["moe"] = MOE.moe_abstract(cfg)
    elif kind == "cross":
        p["attn"] = L.gqa_abstract(cfg)
        p["norm2"] = _norm_spec(cfg)
        p["mlp"] = L.mlp_abstract(cfg)
        p["gate_attn"] = PSpec((1,), (None,), init="zeros")
        p["gate_mlp"] = PSpec((1,), (None,), init="zeros")
    else:
        raise ValueError(kind)
    return p


def block_apply(p, x: torch.Tensor, cfg: ModelConfig, kind: str,
                positions: torch.Tensor, *,
                cache: Optional[Dict] = None,
                cache_index: Optional[int] = None,
                vision_states: Optional[torch.Tensor] = None, tp=None
                ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (x, new_cache, aux_loss).  ``tp``: the leaves that the
    specs cut over 'model' are this rank's blocks."""
    aux = torch.zeros((), device=x.device)
    nrm = functools.partial(L.norm, kind=cfg.norm)

    if kind in ("attn", "attn_moe"):
        h = nrm(x, p["norm1"])
        attn = L.mla_apply if cfg.mla else L.gqa_apply
        a, new_cache = attn(p["attn"], h, cfg, positions, cache=cache,
                            cache_index=cache_index, tp=tp)
        if cfg.parallel_block and kind == "attn":
            x = x + a + L.mlp_apply(p["mlp"], h, cfg, tp)
        else:
            x = x + a
            h2 = nrm(x, p["norm2"])
            if kind == "attn_moe":
                mo, aux = MOE.moe_apply(p["moe"], h2, cfg, tp)
                x = x + mo
            else:
                x = x + L.mlp_apply(p["mlp"], h2, cfg, tp)
    elif kind == "rwkv":
        h = nrm(x, p["norm1"])
        a, tstate = SSM.rwkv_time_mix_apply(
            p["tmix"], h, cfg, state=cache.get("tmix") if cache else None,
            tp=tp)
        x = x + a
        h2 = nrm(x, p["norm2"])
        c, cstate = SSM.rwkv_channel_mix_apply(
            p["cmix"], h2, cfg, state=cache.get("cmix") if cache else None,
            tp=tp)
        x = x + c
        new_cache = {"tmix": tstate, "cmix": cstate}
    elif kind in ("mamba", "mamba_moe"):
        h = nrm(x, p["norm1"])
        a, mstate = SSM.mamba_apply(
            p["mamba"], h, cfg, state=cache.get("mamba") if cache else None,
            tp=tp)
        x = x + a
        h2 = nrm(x, p["norm2"])
        if kind == "mamba_moe":
            mo, aux = MOE.moe_apply(p["moe"], h2, cfg, tp)
            x = x + mo
        else:
            x = x + L.mlp_apply(p["mlp"], h2, cfg, tp)
        new_cache = {"mamba": mstate}
    elif kind == "cross":
        h = nrm(x, p["norm1"])
        a, _ = L.gqa_apply(p["attn"], h, cfg, positions,
                           kv_override=(vision_states,), causal=False, tp=tp)
        x = x + torch.tanh(p["gate_attn"].to(x.dtype)) * a
        h2 = nrm(x, p["norm2"])
        x = x + torch.tanh(p["gate_mlp"].to(x.dtype)) * L.mlp_apply(
            p["mlp"], h2, cfg, tp)
        new_cache = {}  # vision KV is recomputed (stub frontend, tiny)
    else:
        raise ValueError(kind)
    return x, new_cache, aux


# ------------------------------------------------------------ stack groups --

@dataclasses.dataclass(frozen=True)
class StackGroup:
    name: str
    repeats: int                 # length of the stacked axis
    kinds: Tuple[str, ...]       # sub-layer kinds within one repeat


def stack_plan(cfg: ModelConfig) -> List[StackGroup]:
    n = cfg.n_layers
    if cfg.ssm and cfg.ssm.kind == "rwkv6":
        return [StackGroup("rwkv", n, ("rwkv",))]
    if cfg.ssm and cfg.ssm.kind == "mamba":       # jamba hybrid
        period = cfg.ssm.attn_period
        kinds = []
        for i in range(period):
            mixer = "attn" if i == cfg.ssm.attn_offset else "mamba"
            use_moe = cfg.moe is not None and (i % cfg.moe.layer_period
                                               == cfg.moe.layer_period - 1)
            if mixer == "attn":
                kinds.append("attn_moe" if use_moe else "attn")
            else:
                kinds.append("mamba_moe" if use_moe else "mamba")
        return [StackGroup("hybrid", n // period, tuple(kinds))]
    if cfg.cross_attn_period:
        per = cfg.cross_attn_period
        kinds = tuple(["attn"] * (per - 1) + ["cross"])
        return [StackGroup("vision", n // per, kinds)]
    if cfg.moe is not None:
        fd = cfg.moe.first_dense
        groups = []
        if fd:
            groups.append(StackGroup("dense", fd, ("attn",)))
        groups.append(StackGroup("moe", n - fd, ("attn_moe",)))
        return groups
    return [StackGroup("dense", n, ("attn",))]


def stack_abstract(cfg: ModelConfig) -> Dict[str, Any]:
    """Stacked (leading repeat axis) parameter tree for all groups."""
    out: Dict[str, Any] = {}
    for g in stack_plan(cfg):
        step = {f"sub{i}_{kind}": block_abstract(cfg, kind)
                for i, kind in enumerate(g.kinds)}

        def add_axis(ps: PSpec, g=g) -> PSpec:
            return PSpec((g.repeats,) + ps.shape, (None,) + ps.axes,
                         init=ps.init, scale=ps.scale, dtype=ps.dtype)
        out[g.name] = tree_map(add_axis, step)
    return out


def _stack(trees: List[Dict]) -> Dict:
    """Per-repeat cache trees -> one tree with a leading repeat axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _store(dst: Dict, src: Dict) -> None:
    """Write a layer's new cache into its slice of the stacked cache (the
    attention caches were updated in place already)."""
    def put(d, s):
        if s is not d:
            d.copy_(s)
    tree_map(put, dst, src)


def _whole_states(new_c: Dict, tp) -> Dict:
    """A repeat's new caches with each Mamba state gathered whole over
    'model' (``cache_shardings`` keeps them whole; under ``tp`` the layer
    returns its rank's channels)."""
    if tp is None:
        return new_c
    for c in new_c.values():
        if "mamba" in c:
            m = c["mamba"]
            c["mamba"] = {"conv": TP.gather(m["conv"], -1, tp),
                          "ssm": TP.gather(m["ssm"], 1, tp)}
    return new_c


def _repeat_apply(g: StackGroup, cfg: ModelConfig, positions, cache_index,
                  vision_states, named, tp, h: torch.Tensor, p_layer: Dict,
                  c_layer: Optional[Dict]):
    """One repeat of a group's pattern: (h, the last sub-layer's aux, the
    repeat's new caches); ``p_layer`` holds blocks of ``named``'s specs
    (``None``: whole leaves), gathered here over every axis they name (the
    layers compute on what ``tp`` leaves cut: ``tp.compute_named``)."""
    p_layer = fsdp.gather_params(p_layer, named)
    new_c = {}
    for i, kind in enumerate(g.kinds):
        key = f"sub{i}_{kind}"
        sub_c = c_layer[key] if c_layer is not None else None
        h, nc, aux = block_apply(p_layer[key], h, cfg, kind, positions,
                                 cache=sub_c, cache_index=cache_index,
                                 vision_states=vision_states, tp=tp)
        new_c[key] = nc if nc is not None else {}
    return h, aux, new_c


def stack_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *,
                caches: Optional[Dict] = None,
                cache_index: Optional[int] = None,
                vision_states: Optional[torch.Tensor] = None,
                build_caches: bool = False,
                shardings: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """Run all stack groups.  Returns (x, caches, total_aux): the caches
    built by a prefill (``build_caches``), the ``caches`` given, updated in
    place by a decode step, or ``{}`` (the forward and the loss).
    ``shardings``: each stacked leaf's ``sharding.Named`` when ``params``
    holds blocks."""
    tp = TP.context(shardings)
    total_aux = torch.zeros((), device=x.device)
    new_caches: Dict[str, Any] = {}
    remat = (cfg.remat and caches is None and not build_caches
             and torch.is_grad_enabled())

    for g in stack_plan(cfg):
        gc = caches.get(g.name) if caches is not None else None
        layers = tree_map(lambda t: t.unbind(0), params[g.name])
        named = None if shardings is None else TP.compute_named(tree_map(
            lambda n: shd.Named(n.mesh, n.spec[1:]), shardings[g.name]), tp)
        run = functools.partial(_repeat_apply, g, cfg, positions,
                                cache_index, vision_states, named, tp)
        built = []
        for r in range(g.repeats):
            p_layer = tree_map(lambda ts: ts[r], layers)
            c_layer = tree_map(lambda t: t[r], gc) if gc is not None else None
            if remat:
                x, aux, _ = checkpoint(run, x, p_layer, None,
                                       use_reentrant=False)
            else:
                x, aux, new_c = run(x, p_layer, c_layer)
                if c_layer is not None:
                    _store(c_layer, _whole_states(new_c, tp))
                elif build_caches:
                    built.append(_whole_states(new_c, tp))
            # the reference's scan carries only the last sub-layer's aux
            # of each repeat (jamba's period of 8 adds one of its 4 MoE
            # layers' aux); kept so that the loss matches it
            total_aux = total_aux + aux
        if build_caches:
            new_caches[g.name] = _stack(built)
    return x, (new_caches if caches is None else caches), total_aux


def stack_cache_abstract(cfg: ModelConfig, batch: int, max_len: int
                         ) -> Dict[str, Any]:
    """The decode cache's tree (stacked per group) as ``meta`` tensors:
    shapes and dtypes, no storage."""
    cdt = L.compute_dtype(cfg)

    def sds(shape, dtype=cdt):
        return torch.empty(shape, dtype=dtype, device="meta")
    out: Dict[str, Any] = {}
    for g in stack_plan(cfg):
        step: Dict[str, Any] = {}
        r = g.repeats
        for i, kind in enumerate(g.kinds):
            key = f"sub{i}_{kind}"
            if kind in ("attn", "attn_moe"):
                if cfg.mla:
                    m = cfg.mla
                    step[key] = {
                        "ckv": sds((r, batch, max_len, m.kv_lora_rank)),
                        "kr": sds((r, batch, max_len, m.qk_rope_dim))}
                else:
                    shape = (r, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
                    kv_dt = torch.int8 if cfg.kv_cache_int8_scale else cdt
                    step[key] = {"k": sds(shape, kv_dt),
                                 "v": sds(shape, kv_dt)}
                    if cfg.kv_cache_int8_scale:  # per-(token, head) scales
                        for sk in ("ks", "vs"):
                            step[key][sk] = sds(shape[:-1], torch.bfloat16)
            elif kind == "rwkv":
                h = cfg.d_model // SSM.RWKV_HEAD_DIM
                hd = SSM.RWKV_HEAD_DIM
                step[key] = {
                    "tmix": {"shift": sds((r, batch, cfg.d_model)),
                             "wkv": sds((r, batch, h, hd, hd),
                                        torch.float32)},
                    "cmix": {"shift": sds((r, batch, cfg.d_model))}}
            elif kind in ("mamba", "mamba_moe"):
                din = cfg.ssm.expand * cfg.d_model
                step[key] = {"mamba": {
                    "conv": sds((r, batch, cfg.ssm.conv_width - 1, din)),
                    "ssm": sds((r, batch, din, cfg.ssm.d_state),
                               torch.float32)}}
            else:  # cross
                step[key] = {}
        out[g.name] = step
    return out
