"""Model facade: abstract params, init, loss, prefill, decode.

A port of ``repro.models.model``.  One ``nn.Module`` serves every
architecture; behaviour is driven by ``ModelConfig`` (``stack_plan`` picks
the block pattern).  The module holds the parameters as the reference's
tree: each ``state_dict()`` key is the reference's flattened tree path
(``blocks.dense.sub0_attn.attn.wq`` holds the stacked (L, D, H, dh)
tensor), so a tree saved by either package's ``ckpt.manager`` loads into
the other.  ``params`` gives that tree as nested dicts of the module's
parameters; every method takes a tree (``None``: the module's own), as the
reference's pure functions do, so a serving loop can pass the copy that
``compute_params`` holds in the compute dtype.  The reference's sharding
constraints are identities under per-rank SPMD (``sharding.constraint``)
and are left out.

Every method also takes ``shardings``, the tree's ``sharding.Named`` by
leaf, when the tree holds each rank's blocks (``sharding.shard_tree``):
the stack gathers one repeat at a time (``transformer.stack_apply``), and
``embed``, ``final_norm``, ``head`` and ``mtp`` are gathered where they are
read; a tied (or MTP-read) embedding is gathered once for all its uses.
Where 'model' does not cut the batch (``distributed.tp.context``) and the
specs cut the vocabulary over it, the embedding and the head stay this
rank's blocks of the vocabulary: the embedding looks up the rank's tokens
and sums over 'model', the head gives the rank's block of the logits, the
loss is a vocabulary-parallel cross-entropy (``tp.vocab_logsumexp``,
``tp.vocab_gold``), and ``forward``, ``prefill`` and ``decode_step``
return the logits gathered whole.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import fsdp
from repro_torch.distributed import tp as TP
from repro_torch.models import transformer as T
from repro_torch.models.layers import compute_dtype, einsum, norm
from repro_torch.models.params import (PSpec, tree_init, tree_map,
                                       tree_param_count, tree_partition_specs,
                                       tree_shape_structs)

# leaves the layers read in float32 (norm weights, the router, RWKV's decay
# and bonus, Mamba's A and skip); every other leaf is read through
# ``.to(compute_dtype)`` and so may be held in the compute dtype
FLOAT32_LEAVES = frozenset({
    "norm1", "norm2", "final_norm", "norm", "q_norm", "kv_norm", "router",
    "w0", "decay_a", "decay_b", "u", "ln_w", "a_log", "d_skip"})


def model_abstract(cfg: ModelConfig) -> Dict[str, Any]:
    p: Dict[str, Any] = {}
    vtp = "tp" if cfg.vocab_size % 16 == 0 else None  # hubert: V=504 replicated
    if not cfg.external_embed:
        p["embed"] = PSpec((cfg.vocab_size, cfg.d_model), (vtp, "fsdp"))
    p["blocks"] = T.stack_abstract(cfg)
    p["final_norm"] = PSpec((cfg.d_model,), (None,), init="ones")
    if not cfg.tie_embeddings:
        p["head"] = PSpec((cfg.d_model, cfg.vocab_size), ("fsdp", vtp))
    if cfg.mtp_depth:
        p["mtp"] = {
            "proj": PSpec((2 * cfg.d_model, cfg.d_model), ("fsdp", None)),
            "block": T.block_abstract(cfg, "attn"),
            "norm": PSpec((cfg.d_model,), (None,), init="ones"),
        }
    return p


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    from repro_torch.models.moe import moe_abstract
    total = tree_param_count(model_abstract(cfg))
    if active_only and cfg.moe is not None:
        m = cfg.moe
        expert_p = tree_param_count(
            {k: v for k, v in moe_abstract(cfg).items()
             if k in ("w1", "w2", "w3")})
        n_moe_layers = (cfg.n_layers - m.first_dense) // m.layer_period
        inactive = expert_p * n_moe_layers * (1 - m.top_k / m.n_experts)
        total -= int(inactive)
    return total


def _register(mod: nn.Module, tree: Dict[str, Any]) -> None:
    """A parameter tree into ``mod`` under the tree's own names: sub-dicts
    become child modules and tensors parameters."""
    for k, v in tree.items():
        if isinstance(v, dict):
            child = nn.Module()
            _register(child, v)
            mod.add_module(k, child)
        else:
            mod.register_parameter(k, nn.Parameter(v, requires_grad=False))


def _as_tree(mod: nn.Module) -> Dict[str, Any]:
    out: Dict[str, Any] = dict(mod._parameters)
    for k, child in mod._modules.items():
        out[k] = _as_tree(child)
    return out


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


class Model(nn.Module):
    """The model for ``cfg`` on ``device`` (``None`` means ``cuda``), its
    parameters ``tree_init``'s draw from a generator seeded with ``seed``,
    or the tree ``params`` (same names, shapes and dtypes, e.g. from
    ``params_from_reference``) placed on the device."""

    def __init__(self, cfg: ModelConfig, params: Optional[Dict] = None, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = tree_init(model_abstract(cfg), gen, cfg.param_dtype,
                               dev)
        else:
            params = tree_map(lambda t: t.to(dev), params)
        _register(self, params)

    # ---------------------------------------------------------------- setup --
    def abstract_params(self):
        return model_abstract(self.cfg)

    def partition_specs(self, drop_fsdp: bool = False):
        """Each leaf's spec over the current mesh."""
        return tree_partition_specs(self.abstract_params(), drop_fsdp)

    def shape_structs(self):
        """Each leaf as a ``meta`` tensor of its shape and dtype."""
        return tree_shape_structs(self.abstract_params(),
                                  self.cfg.param_dtype)

    @property
    def params(self) -> Dict[str, Any]:
        """The parameter tree: nested dicts of this module's parameters."""
        return _as_tree(self)

    def compute_params(self, params: Optional[Dict] = None) -> Dict[str, Any]:
        """A copy of the tree held in the compute dtype, for serving: every
        leaf the layers read through ``.to(compute_dtype)`` cast once, the
        float32-read leaves (``FLOAT32_LEAVES``) as they are.  It gives the
        bits of the tree it copies and spares each call the cast (qwen2-7b:
        15.2 GB of bfloat16 beside 30.5 GB of float32).  A tree of blocks
        gives its blocks cast: the cast is elementwise."""
        cdt = compute_dtype(self.cfg)

        def cast(tree):
            return {k: cast(v) if isinstance(v, dict)
                    else v if k in FLOAT32_LEAVES else v.to(cdt)
                    for k, v in tree.items()}
        return cast(self.params if params is None else params)

    def _tree(self, params):
        return self.params if params is None else params

    def _vocab_tp(self, shardings):
        """``tp.context(shardings)`` where the specs cut the vocabulary
        over 'model', else ``None``."""
        tp = TP.context(shardings)
        key = "embed" if self.cfg.tie_embeddings else "head"
        return tp if tp is not None and TP.cuts(shardings[key]) else None

    def _shared(self, params, shardings, vt, mtp: bool = False):
        """``params`` and ``shardings`` with the embedding gathered once
        (over every axis but the vocabulary's 'model' under ``vt``) when
        more than one site reads it (tied to the head, or read again by
        the MTP loss)."""
        if shardings is None or "embed" not in params or not (
                self.cfg.tie_embeddings or mtp):
            return params, shardings
        return (dict(params, embed=self._read(params, shardings, "embed",
                                              vt)),
                dict(shardings, embed=None))

    @staticmethod
    def _sub(shardings, key):
        return None if shardings is None else shardings[key]

    def _read(self, params, shardings, key, vt=None):
        """Leaf ``key`` gathered from its block under ``shardings``: whole,
        or this rank's block of the vocabulary under ``vt``."""
        return fsdp.gather_param(params[key], TP.compute_named(
            self._sub(shardings, key), vt))

    # ------------------------------------------------------------- forward --
    def _embed(self, params, tokens=None, embeds=None, shardings=None,
               vt=None) -> torch.Tensor:
        cdt = compute_dtype(self.cfg)
        if embeds is not None:
            return embeds.to(cdt)
        table = self._read(params, shardings, "embed", vt)
        if vt is not None:
            return TP.vocab_embed(table, tokens, vt, cdt)
        # gather, then cast: the bits of casting the table first
        return table[tokens].to(cdt)

    def _head_weight(self, params, shardings=None, vt=None) -> torch.Tensor:
        cdt = compute_dtype(self.cfg)
        if self.cfg.tie_embeddings:
            return self._read(params, shardings, "embed", vt).to(cdt).T
        return self._read(params, shardings, "head", vt).to(cdt)

    def _logits(self, params, x, shardings, vt, whole: bool
                ) -> torch.Tensor:
        """float32 logits of ``x`` by the head: this rank's block of the
        vocabulary under ``vt``, gathered whole with ``whole``."""
        logits = einsum("bsd,dv->bsv", TP.enter(x, vt),
                        self._head_weight(params, shardings, vt)).float()
        return TP.gather(logits, -1, vt) if whole else logits

    def _head(self, params, x: torch.Tensor, shardings=None, vt=None,
              whole: bool = True) -> torch.Tensor:
        x = norm(x, self._read(params, shardings, "final_norm"), self.cfg.norm)
        return self._logits(params, x, shardings, vt, whole)

    def forward(self, params=None, tokens=None, embeds=None,
                vision_states=None, positions=None, shardings=None
                ) -> torch.Tensor:
        """Full-sequence forward -> float32 logits (B,S,V)."""
        vt = self._vocab_tp(shardings)
        params, shardings = self._shared(self._tree(params), shardings, vt)
        x = self._embed(params, tokens, embeds, shardings, vt)
        b, s, _ = x.shape
        if positions is None:
            positions = _positions(b, s, x.device)
        x, _, _ = T.stack_apply(params["blocks"], x, self.cfg, positions,
                                vision_states=vision_states,
                                shardings=self._sub(shardings, "blocks"))
        return self._head(params, x, shardings, vt)

    # ---------------------------------------------------------------- loss --
    def loss(self, params, batch: Dict[str, torch.Tensor], shardings=None
             ) -> torch.Tensor:
        """Cross-entropy + MoE aux (+ 0.1 x the MTP loss), differentiable
        with respect to the leaves of ``params`` (``train.step``'s
        ``value_and_grad`` takes its gradient)."""
        cfg = self.cfg
        mtp = bool(cfg.mtp_depth and "tokens" in batch)
        vt = self._vocab_tp(shardings)
        params, shardings = self._shared(self._tree(params), shardings, vt,
                                         mtp)
        x = self._embed(params, batch.get("tokens"), batch.get("embeds"),
                        shardings, vt)
        b, s, _ = x.shape
        positions = _positions(b, s, x.device)
        h, _, aux = T.stack_apply(params["blocks"], x, cfg, positions,
                                  vision_states=batch.get("vision_states"),
                                  shardings=self._sub(shardings, "blocks"))
        logits = self._head(params, h, shardings, vt, whole=False)
        loss = _xent(logits, batch["labels"], vt) + aux
        if mtp:
            loss = loss + 0.1 * self._mtp_loss(params, h, batch, positions,
                                               shardings, vt)
        return loss

    def _mtp_loss(self, params, h, batch, positions, shardings=None,
                  vt=None) -> torch.Tensor:
        """DeepSeek-V3 multi-token prediction: one extra depth, predicts t+2."""
        cfg = self.cfg
        cdt = compute_dtype(cfg)
        tp = TP.context(shardings)
        mtp = fsdp.gather_params(params["mtp"], TP.compute_named(
            self._sub(shardings, "mtp"), tp))
        tokens, labels = batch["tokens"], batch["labels"]
        # combine hidden state at t with embedding of token t+1
        nxt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
        z = torch.cat([h, self._embed(params, nxt, shardings=shardings,
                                      vt=vt)], dim=-1)
        z = einsum("bsd,dk->bsk", z, mtp["proj"].to(cdt))
        z, _, _ = T.block_apply(mtp["block"], z, cfg, "attn", positions,
                                tp=tp)
        z = norm(z, mtp["norm"], cfg.norm)
        logits2 = self._logits(params, z, shardings, vt, whole=False)
        lab2 = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
        return _xent(logits2, lab2, vt)

    # -------------------------------------------------------------- serving --
    def prefill(self, params=None, tokens=None, embeds=None,
                vision_states=None, max_len: Optional[int] = None,
                shardings=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Run the prompt; returns (last-position logits, decode cache)."""
        vt = self._vocab_tp(shardings)
        params, shardings = self._shared(self._tree(params), shardings, vt)
        x = self._embed(params, tokens, embeds, shardings, vt)
        b, s, _ = x.shape
        h, caches, _ = T.stack_apply(params["blocks"], x, self.cfg,
                                     _positions(b, s, x.device),
                                     vision_states=vision_states,
                                     build_caches=True,
                                     shardings=self._sub(shardings, "blocks"))
        logits = self._head(params, h[:, -1:, :], shardings, vt)
        if max_len is not None and max_len > s:
            caches = _pad_caches(caches, max_len, seq_axis=2)
        return logits, caches

    def init_cache_structs(self, batch: int, max_len: int):
        """The decode cache's shapes and dtypes as ``meta`` tensors."""
        return T.stack_cache_abstract(self.cfg, batch, max_len)

    def decode_step(self, params, cache, index: int, tokens: torch.Tensor,
                    vision_states=None, shardings=None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One-token decode: tokens (B,1) at position ``index``.  The cache
        is updated in place and returned."""
        vt = self._vocab_tp(shardings)
        params, shardings = self._shared(self._tree(params), shardings, vt)
        index = int(index)
        x = self._embed(params, tokens, shardings=shardings, vt=vt)
        b = x.shape[0]
        positions = torch.full((b, 1), index, dtype=torch.int32,
                               device=x.device)
        h, new_cache, _ = T.stack_apply(params["blocks"], x, self.cfg,
                                        positions, caches=cache,
                                        cache_index=index,
                                        vision_states=vision_states,
                                        shardings=self._sub(shardings,
                                                            "blocks"))
        return self._head(params, h, shardings, vt), new_cache


def _xent(logits: torch.Tensor, labels: torch.Tensor, vt=None
          ) -> torch.Tensor:
    """Mean cross-entropy; under ``vt`` ``logits`` is this rank's block of
    the vocabulary."""
    if vt is not None:
        lse = TP.vocab_logsumexp(logits, vt)
        gold = TP.vocab_gold(logits, labels, vt)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


_SEQ_CACHE_KEYS = ("k", "v", "ckv", "kr", "ks", "vs")  # caches with a seq axis


def _pad_caches(caches, max_len: int, seq_axis: int):
    """Zero-pad the sequence axis of every cache leaf that has one."""
    def pad(tree):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict):
                out[k] = pad(x)
            elif k in _SEQ_CACHE_KEYS and x.shape[seq_axis] < max_len:
                shape = list(x.shape)
                shape[seq_axis] = max_len - x.shape[seq_axis]
                out[k] = torch.cat([x, x.new_zeros(shape)], dim=seq_axis)
            else:
                out[k] = x
        return out
    return pad(caches)
