"""Mixture-of-Experts FFN: token-choice top-k routing and capacity-based
sort-and-scatter dispatch.

A port of ``repro.models.moe``.  Dispatch scatters the kept assignments into
an (E, C, D) capacity buffer, the experts run as batched matmuls, and the
combine scatter-adds the results back to token order.  Tokens overflowing
an expert's capacity ``C = ceil(T*k/E * cap_factor)`` are dropped (they pass
through the residual).  On one device the reference takes this path (its
``_moe_apply_gspmd``); its ``shard_map`` dispatch runs only under a mesh
with a model axis and waits for the mesh-bound paths.

Ties: ``jax.lax.top_k`` puts the lower expert index first among equal
probabilities and ``_rank_in_expert`` ranks with a stable sort, so both are
stable sorts here and capacity drops fall on the reference's tokens.  The
combine sums a token's k contributions in assignment order, from zero, on
every device: the bits of the CPU's ``index_add_``, where the card's
``index_add_`` adds them in whatever order its atomics land, so that two
runs on the card (a resumed training run and an uncrashed one) agree bit
for bit.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import (compute_dtype, einsum, mlp_abstract,
                                       mlp_apply, silu)
from repro_torch.models.params import PSpec


def moe_abstract(cfg: ModelConfig) -> Dict[str, PSpec]:
    m: MoEConfig = cfg.moe
    d, fe = cfg.d_model, m.d_expert
    p: Dict[str, PSpec] = {
        "router": PSpec((d, m.n_experts), (None, None), dtype="float32"),
        "w1": PSpec((m.n_experts, d, fe), ("tp", "fsdp", None)),
        "w3": PSpec((m.n_experts, d, fe), ("tp", "fsdp", None)),
        "w2": PSpec((m.n_experts, fe, d), ("tp", None, "fsdp")),
    }
    if m.n_shared:
        p["shared"] = mlp_abstract(cfg, d_ff=m.n_shared * fe)
    return p


def _capacity(tokens: int, m: MoEConfig) -> int:
    c = int(tokens * m.top_k / m.n_experts * m.capacity_factor)
    return max((c + 7) // 8 * 8, 8)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, the lower index first among ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_probs(p, xs: torch.Tensor) -> torch.Tensor:
    logits = einsum("td,de->te", xs.float(), p["router"])
    return torch.softmax(logits, dim=-1)


def _normalized_top_k(probs: torch.Tensor, k: int):
    top_w, top_e = _top_k(probs, k)                            # (T,k)
    return top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9), top_e


def _routing(p, xs: torch.Tensor, m: MoEConfig):
    probs = _router_probs(p, xs)
    top_w, top_e = _normalized_top_k(probs, m.top_k)
    e = m.n_experts
    one_hot = torch.nn.functional.one_hot(top_e, e).float()
    frac_assign = one_hot.sum(dim=1).mean(dim=0) / m.top_k
    frac_prob = probs.mean(dim=0)
    aux = e * torch.sum(frac_assign * frac_prob) * m.aux_loss_weight
    return top_w, top_e, aux


def _rank_in_expert(e_flat: torch.Tensor, tk: int) -> torch.Tensor:
    """Each assignment's rank among the assignments to its expert, in
    assignment order (a stable sort)."""
    order = torch.sort(e_flat, stable=True).indices
    sorted_e = e_flat[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_sorted = torch.arange(tk, device=e_flat.device) - first
    out = torch.zeros(tk, dtype=torch.int64, device=e_flat.device)
    out[order] = pos_sorted
    return out


def _expert_ffn(buf, p, cdt):
    g = einsum("ecd,edf->ecf", buf, p["w1"].to(cdt))
    u = einsum("ecd,edf->ecf", buf, p["w3"].to(cdt))
    return einsum("ecf,efd->ecd", silu(g) * u, p["w2"].to(cdt))


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (out, aux_loss): the capacity dispatch, the
    reference's path without a mesh."""
    return _moe_apply_gspmd(p, x, cfg)


def _moe_apply_gspmd(p, x: torch.Tensor, cfg: ModelConfig):
    m: MoEConfig = cfg.moe
    cdt = compute_dtype(cfg)
    b, s, d = x.shape
    t = b * s
    k = m.top_k
    e = m.n_experts
    cap = _capacity(t, m)
    xs = x.reshape(t, d)
    top_w, top_e, aux = _routing(p, xs, m)

    e_flat = top_e.reshape(-1)                                  # (T*k,)
    w_flat = top_w.reshape(-1)
    tok_flat = torch.arange(t, device=x.device).repeat_interleave(k)
    pos = _rank_in_expert(e_flat, t * k)
    keep = pos < cap
    slot = torch.where(keep, e_flat * cap + pos, e * cap)       # row e*cap: dropped

    buf = torch.zeros((e * cap + 1, d), dtype=cdt, device=x.device)
    buf.index_add_(0, slot, xs[tok_flat].to(cdt) * keep[:, None].to(cdt))
    y = _expert_ffn(buf[:-1].reshape(e, cap, d), p, cdt).reshape(e * cap, d)

    gathered = y[torch.clamp(slot, 0, e * cap - 1)]
    w_keep = (w_flat * keep).to(cdt)[:, None]
    contrib = (gathered * w_keep).reshape(t, k, d)   # token-major, as tok_flat
    out = torch.zeros((t, d), dtype=cdt, device=x.device)
    for j in range(k):
        out = out + contrib[:, j]

    if m.n_shared:
        out = out + mlp_apply(p["shared"], x, cfg).reshape(t, d)
    return out.reshape(b, s, d), aux


def moe_reference(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Dense oracle: every token through its top-k experts, no capacity.
    Used by tests to validate the dispatch path."""
    m = cfg.moe
    cdt = compute_dtype(cfg)
    b, s, d = x.shape
    xs = x.reshape(-1, d)
    top_w, top_e = _normalized_top_k(_router_probs(p, xs), m.top_k)
    out = torch.zeros(xs.shape, dtype=cdt, device=x.device)
    tok = torch.arange(xs.shape[0], device=x.device)
    for j in range(m.top_k):
        # compute every expert on every token, select (oracle only; O(E*T))
        g = einsum("td,edf->etf", xs.to(cdt), p["w1"].to(cdt))
        u = einsum("td,edf->etf", xs.to(cdt), p["w3"].to(cdt))
        y = einsum("etf,efd->etd", silu(g) * u, p["w2"].to(cdt))
        out = out + y[top_e[:, j], tok] * top_w[:, j:j + 1].to(cdt)
    if m.n_shared:
        out = out + mlp_apply(p["shared"], x, cfg).reshape(-1, d)
    return out.reshape(b, s, d)
