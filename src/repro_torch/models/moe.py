"""Mixture-of-Experts FFN: token-choice top-k routing, capacity-based
sort-and-scatter dispatch, expert parallelism over the 'model' mesh axis.

A port of ``repro.models.moe``.  Dispatch scatters the kept assignments into
an (E, C, D) capacity buffer, the experts run as batched matmuls, and the
combine scatter-adds the results back to token order.  Tokens overflowing
an expert's capacity ``C = ceil(T*k/E * cap_factor)`` are dropped (they pass
through the residual).

Under a mesh each rank holds its shard of the batch (``sharding.batch_axes``)
and the reference's semantics are those of its global arrays: the routing,
the aux loss and the capacity dispatch see every token of the global batch,
so a rank gathers the tokens over the batch axes first (``gather_to``) and
keeps its own rows of the output.  With ``dispatch="shard_map"`` and a model
axis that divides the experts, each model rank builds only its local (E/tp,
C_l, D) buffer for the tokens of its data-parallel shard, with the capacity
``C_l`` of that shard's token count, from its experts' slice of the weights;
the combine is one model-axis psum (``reduce_from``, or ``scatter_from``
when the model axis also cuts the batch).

Given ``tp`` (``distributed.tp.context``: a step on blocks where 'model'
does not cut the batch), ``p``'s experts are this rank's block of them, as
stored: the capacity dispatch computes those experts' rows of the (E, C,
D) buffer from the routing that every rank computes alike, entering the
tokens and the routing weights through ``tp.enter``, and the combine
leaves through ``tp.leave``; the ``shard_map`` dispatch takes the block
as it is instead of cutting a gathered whole leaf.

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
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp as TP
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
    # a comparison, not ``F.one_hot``: that reads the indices' range back
    # to the host on a real device (a sync) and takes another path on meta
    one_hot = (top_e.unsqueeze(-1)
               == torch.arange(e, device=top_e.device)).float()
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


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, tp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D), this rank's shard of the batch under a mesh -> (out,
    aux_loss); ``tp``: the experts are this rank's block."""
    m: MoEConfig = cfg.moe
    mesh = shd.get_current_mesh()
    n = mesh.shape.get("model", 1) if mesh is not None else 1
    if m.dispatch == "shard_map" and n > 1 and m.n_experts % n == 0:
        return _moe_apply_shard_map(p, x, cfg, mesh, n, tp)
    return _moe_apply_gspmd(p, x, cfg, tp)


def _global_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(T, D) tokens of the global batch, and the first row of this rank's
    own, gathered over the batch axes of the current mesh."""
    xs = x.reshape(-1, x.shape[-1])
    axes = shd.batch_axes()
    if not axes:
        return xs, 0
    return shd.gather_to(xs, axes), shd.axis_index(axes) * xs.shape[0]


def _shard_assignments(top_e: torch.Tensor, cap: int, lo: int,
                       e_local: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot, local) of each assignment (token-major): ``local`` if it is
    kept (its rank in its expert below ``cap``) and its expert is one of
    [lo, lo + e_local); ``slot`` its row in the (e_local * cap) buffer, or
    the drop row ``e_local * cap``."""
    e_flat = top_e.reshape(-1)                                  # (T*k,)
    pos = _rank_in_expert(e_flat, e_flat.numel())
    local = (pos < cap) & (e_flat >= lo) & (e_flat < lo + e_local)
    slot = torch.where(local, (e_flat - lo) * cap + pos, e_local * cap)
    return slot, local


def _dispatch(xs, top_w, top_e, w, cfg: ModelConfig, cap: int, lo: int,
              e_local: int) -> torch.Tensor:
    """The capacity dispatch of (T, D) tokens to experts [lo, lo +
    e_local) (weights ``w``: those experts' w1, w3, w2), their FFNs, and
    the combine: (T, D), each token's kept contributions added in
    assignment order."""
    cdt = compute_dtype(cfg)
    t, d = xs.shape
    k = top_e.shape[-1]
    slot, local = _shard_assignments(top_e, cap, lo, e_local)
    tok_flat = torch.arange(t, device=xs.device).repeat_interleave(k)
    rows = e_local * cap
    buf = torch.zeros((rows + 1, d), dtype=cdt, device=xs.device)
    buf.index_add_(0, slot, xs[tok_flat].to(cdt) * local[:, None].to(cdt))
    y = _expert_ffn(buf[:-1].reshape(e_local, cap, d), w, cdt).reshape(rows,
                                                                        d)
    gathered = y[torch.clamp(slot, 0, rows - 1)]
    w_keep = (top_w.reshape(-1) * local).to(cdt)[:, None]
    contrib = (gathered * w_keep).reshape(t, k, d)   # token-major, as tok_flat
    out = torch.zeros((t, d), dtype=cdt, device=xs.device)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def _moe_apply_gspmd(p, x: torch.Tensor, cfg: ModelConfig, tp=None):
    """The capacity dispatch over the global batch (the reference's path
    without a shard_map dispatch); under ``tp`` each rank's experts."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    xs, lo = _global_tokens(x)
    top_w, top_e, aux = _routing(p, xs, m)
    e_local = p["w1"].shape[0]
    e_lo = 0 if tp is None else TP.lo(tp, e_local)
    out = _dispatch(TP.enter(xs, tp), TP.enter(top_w, tp), top_e, p, cfg,
                    _capacity(xs.shape[0], m), e_lo, e_local
                    ).narrow(0, lo, b * s)
    out = TP.leave(out, tp)
    if m.n_shared:
        out = out + mlp_apply(p["shared"], x, cfg, tp).reshape(b * s, d)
    return out.reshape(b, s, d), aux


def _moe_apply_shard_map(p, x: torch.Tensor, cfg: ModelConfig, mesh,
                         n: int, tp=None):
    """EP-as-TP manual dispatch: each model rank builds only its local
    (E/n, C_l, D) buffer from the tokens of its data-parallel shard (no
    dispatch collective); the combine is a single (T_l, D) psum over
    'model'.  Routing and the aux loss see the global batch.  ``tp``: the
    experts are this rank's block, as stored."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    e_local = m.n_experts // n
    batch = shd.batch_axes()
    dp = mesh.axes(("pod", "data"))
    fold = "model" in batch            # the model axis also cuts the batch
    if batch != dp + (("model",) if fold else ()):
        raise ValueError(f"the shard_map dispatch needs the batch cut over "
                         f"the data-parallel axes {dp}, alone or then "
                         f"'model'; it is cut over {batch}")
    xs, _ = _global_tokens(x)
    top_w, top_e, aux = _routing(p, xs, m)
    # this data-parallel shard's tokens (the reference's in_specs P(dp))
    t_l = xs.shape[0] // mesh.size(dp)
    r0 = mesh.index(dp) * t_l
    xs_l, tw_l, te_l = (t.narrow(0, r0, t_l) for t in (xs, top_w, top_e))
    lo = mesh.index("model") * e_local
    kind = "all_reduce" if tp is None else TP.REDUCE
    if fold:
        # every rank has a loss of its own: the gradients of the weights'
        # blocks are summed with the rest over the batch axes
        w = {n: p[n].narrow(0, lo, e_local) for n in ("w1", "w3", "w2")}
    elif tp is not None:
        # the blocks as stored: the entered tokens and routing give each
        # its whole gradient
        xs_l, tw_l = TP.enter(xs_l, tp), TP.enter(tw_l, tp)
        w = {n: p[n] for n in ("w1", "w3", "w2")}
    else:
        # the model axis computes one loss: each rank's partial gradient of
        # its tokens and routing is summed over the axis, and each weight's
        # gradient gathered whole
        xs_l = shd.copy_to(xs_l, "model", mesh)
        tw_l = shd.copy_to(tw_l, "model", mesh)
        w = {n: shd.block_with_whole_grad(p[n], "model", mesh)
             for n in ("w1", "w3", "w2")}
    # per-DP-shard capacity (local tokens)
    out_l = _dispatch(xs_l, tw_l, te_l, w, cfg, _capacity(t_l, m), lo,
                      e_local)
    if fold:
        out = shd.scatter_from(out_l, "model", mesh)
    else:
        out = shd.reduce_from(out_l, "model", mesh, kind)
    if m.n_shared:
        out = out + mlp_apply(p["shared"], x, cfg, tp).reshape(b * s, d)
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
