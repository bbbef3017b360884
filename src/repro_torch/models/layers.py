"""Shared transformer layers: norms, RoPE, flash-style chunked attention
(causal / bidirectional / sliding-window / cross), GQA, MLA, gated MLP and
the exponent-aligned int8 KV cache.

A port of ``repro.models.layers`` in torch ops.  Attention is blockwise
(running log-sum-exp over KV chunks) with the reference's chunking, masks
and ``-1e30`` fill; both products of a block accumulate in float32, and the
probabilities are cast to V's dtype before the PV product, as the
reference's ``preferred_element_type=float32`` einsums do.  No library
attention call is used: the reference's numbers come from this softmax.

Weights are cast to the compute dtype where they are read (``.to(cdt)``,
the reference's ``.astype(cdt)``), which is a no-op on a copy already held
in that dtype (``Model.compute_params``).  Decode updates the cache passed
in, in place, and returns it; a cache index outside the cache raises
``IndexError`` (the reference's ``dynamic_update_slice`` would clamp it
and overwrite the last slot).  The seq-sharded flash decode
(``seqshard_decode_gqa*``, taken under ``cfg.seq_shard_decode``) runs on
each rank of the current mesh over its shard of the cache's L axis, cut
over 'model', and combines the shards' partial softmaxes with one
``pmax`` and two ``psum``s over 'model'.

Given ``tp`` (``distributed.tp.context``: a step on blocks where 'model'
does not cut the batch), the layers compute on this rank's blocks of the
leaves the reference's specs cut over 'model', as GSPMD does: GQA's query
heads and MLA's up-projections column-parallel and their output heads
row-parallel, the MLP's ``w1``/``w3`` column- and ``w2`` row-parallel.
GQA's ``wk``/``wv`` are whole (the reference's spec); each rank computes
every kv head, so that the cache holds them all alike on every rank, and
reads those of its q heads through ``tp.enter``, which sums their
gradients over 'model'.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, MLAConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp as TP
from repro_torch.models.params import DTYPES, PSpec


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` on operands promoted to their common dtype, as
    ``jnp.einsum`` promotes (bfloat16 with float32 gives float32)."""
    dt = functools.reduce(torch.promote_types, [o.dtype for o in ops])
    return torch.einsum(eq, *[o.to(dt) for o in ops])


class _Logistic(torch.autograd.Function):
    """The sigmoid's value as XLA expands it, its gradient as JAX's
    ``logistic`` rule, ``g * (s * (1 - s))``: autograd through the
    expansion would give ``0 * exp(-x) = 0 * inf = NaN`` where ``exp(-x)``
    overflows."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA expands it: ``1 / (1 + exp(-x))``, each op
    rounded to x's dtype (``torch.sigmoid`` rounds once, which differs in
    about a third of bfloat16 values), differentiable as JAX's."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Logistic.apply(x)
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


# ------------------------------------------------------------------- norms --

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x - torch.mean(x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def norm(x: torch.Tensor, w: torch.Tensor, kind: str) -> torch.Tensor:
    return rmsnorm(x, w) if kind == "rmsnorm" else layernorm(x, w)


# -------------------------------------------------------------------- RoPE --

def rope_freqs(dh: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, dh, 2, dtype=np.float64) / dh))


def _rope_freqs_on(dh: int, theta: float, device) -> torch.Tensor:
    """``rope_freqs`` in float64 on ``device``, rounded to float32: a copy
    from the host would wait for the card's queue on every call."""
    exps = torch.arange(0, dh, 2, dtype=torch.float64, device=device) / dh
    return (1.0 / (theta ** exps)).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, dh) rotated pairwise; positions: (..., S) int."""
    dh = x.shape[-1]
    freqs = _rope_freqs_on(dh, theta, x.device)
    ang = positions[..., :, None, None].float() * freqs
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    out = torch.stack([y1, y2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# -------------------------------------------------- blockwise attention -----

def _attn_block(q, k, v, scale, mask):
    """One (q_chunk x kv_chunk) block: returns (scores_max, exp_sum, pv),
    both products accumulated in float32."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    s = torch.where(mask, s, -1e30)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return m, l, pv


def _merge(run, blk):
    """Fold one block's (m, l, pv) into the running (m, l, acc)."""
    m_run, l_run, acc = run
    m, l, pv = blk
    m_new = torch.maximum(m_run, m)
    corr_old = torch.exp(m_run - m_new)
    corr_new = torch.exp(m - m_new)
    l_new = l_run * corr_old + l * corr_new
    # m, l: (b, hkv, g, q); acc, pv: (b, q, hkv, g, dv)
    acc_new = (acc * corr_old.permute(0, 3, 1, 2)[..., None]
               + pv * corr_new.permute(0, 3, 1, 2)[..., None])
    return m_new, l_new, acc_new


def _run_init(b, hkv, g, qc, dv, device):
    return (torch.full((b, hkv, g, qc), -torch.inf, device=device),
            torch.zeros((b, hkv, g, qc), device=device),
            torch.zeros((b, qc, hkv, g, dv), device=device))


def _finish(l, acc, dtype):
    l_b = l.permute(0, 3, 1, 2)[..., None]
    return (acc / torch.clamp_min(l_b, 1e-30)).to(dtype)


def _pad_seq(t: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad axis 1 by ``n``."""
    if n == 0:
        return t
    pad = t.new_zeros((t.shape[0], n) + tuple(t.shape[2:]))
    return torch.cat([t, pad], dim=1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0,
                    q_chunk: int = 1024, kv_chunk: int = 1024
                    ) -> torch.Tensor:
    """Blockwise attention.

    q: (B, Sq, H, dh); k, v: (B, Skv, Hkv, dh) with H % Hkv == 0 (GQA).
    ``q_offset`` is the absolute position of q[0] relative to k[0];
    window > 0 = sliding window.  Each query chunk visits only the KV
    chunks its causal and window limits reach.  Returns (B, Sq, H, dv).
    """
    b, sq, h, dh = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    g = h // hkv
    scale = dh ** -0.5
    qg = q.reshape(b, sq, hkv, g, dh)
    dev = q.device

    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    skv_pad = -(-skv // kv_chunk) * kv_chunk
    k = _pad_seq(k, skv_pad - skv)
    v = _pad_seq(v, skv_pad - skv)
    outs = []
    for q0 in range(0, sq, q_chunk):
        qc = min(q_chunk, sq - q0)
        qblk = qg[:, q0:q0 + qc]
        q_pos_hi = q_offset + q0 + qc - 1
        kv_hi = min(q_pos_hi + 1, skv) if causal else skv
        kv_lo = max(0, q_offset + q0 - window + 1) if window > 0 else 0
        c_lo = kv_lo // kv_chunk
        c_hi = -(-kv_hi // kv_chunk)
        q_pos = q_offset + q0 + torch.arange(qc, device=dev)
        run = _run_init(b, hkv, g, qc, dv, dev)
        for ci in range(c_lo, c_lo + max(c_hi - c_lo, 1)):
            k0 = ci * kv_chunk
            kv_pos = k0 + torch.arange(kv_chunk, device=dev)
            mask = (kv_pos < skv)[None, :].expand(qc, kv_chunk)
            if causal:
                mask = mask & (q_pos[:, None] >= kv_pos[None, :])
            if window > 0:
                mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
            run = _merge(run, _attn_block(
                qblk, k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk], scale,
                mask[None, None, None]))
        outs.append(_finish(run[1], run[2], q.dtype))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.reshape(b, sq, h, dv)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *,
                     window: int = 0, kv_chunk: int = 2048,
                     scale: Optional[float] = None, kv_scales=None,
                     return_lse: bool = False):
    """Single-position decode: q (B,1,H,dh) vs cache (B,L,Hkv,dh).

    ``cache_len`` = number of valid cache positions; SWA attends only to the
    last ``window`` of them.  One pass over the cache with a running LSE;
    an int8 cache (``kv_scales`` = its per-(token, head) scales) is
    dequantized chunk by chunk.  ``return_lse`` gives the raw (acc, m, l)
    for a cross-shard combine (flash-decoding).
    """
    b, _, h, dh = q.shape
    _, L, hkv, _ = k_cache.shape
    dv = v_cache.shape[-1]
    g = h // hkv
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(b, 1, hkv, g, dh)
    kv_chunk = min(kv_chunk, L)
    n_kv = -(-L // kv_chunk)
    pad = n_kv * kv_chunk - L
    k_cache, v_cache = _pad_seq(k_cache, pad), _pad_seq(v_cache, pad)
    if kv_scales is not None:
        kv_scales = tuple(_pad_seq(s, pad) for s in kv_scales)
    run = _run_init(b, hkv, g, 1, dv, q.device)
    for ci in range(n_kv):
        k0 = ci * kv_chunk
        kblk = k_cache[:, k0:k0 + kv_chunk]
        vblk = v_cache[:, k0:k0 + kv_chunk]
        if kv_scales is not None:
            kblk = kv_dequantize(kblk, kv_scales[0][:, k0:k0 + kv_chunk],
                                 q.dtype)
            vblk = kv_dequantize(vblk, kv_scales[1][:, k0:k0 + kv_chunk],
                                 q.dtype)
        kv_pos = k0 + torch.arange(kv_chunk, device=q.device)
        mask = kv_pos < cache_len
        if window > 0:
            mask = mask & (kv_pos >= cache_len - window)
        run = _merge(run, _attn_block(qg, kblk, vblk, scale,
                                      mask[None, None, None, None, :]))
    if return_lse:
        m, l, acc = run
        return acc, m, l
    return _finish(run[1], run[2], q.dtype).reshape(b, 1, h, dv)


# ----------------------------------------------------------- GQA attention --

def heads_cut(cfg: ModelConfig) -> bool:
    """Whether GQA's query and output heads are cut over 'model'; uneven
    head counts stay local."""
    return cfg.n_heads % 16 == 0


def gqa_abstract(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tp_heads = "tp" if heads_cut(cfg) else None
    p: Dict[str, PSpec] = {
        "wq": PSpec((d, h, dh), ("fsdp", tp_heads, None)),
        "wk": PSpec((d, hkv, dh), ("fsdp", None, None)),
        "wv": PSpec((d, hkv, dh), ("fsdp", None, None)),
        "wo": PSpec((h, dh, d), (tp_heads, None, "fsdp")),
    }
    if cfg.qkv_bias:
        p["bq"] = PSpec((h, dh), (tp_heads, None), init="zeros")
        p["bk"] = PSpec((hkv, dh), (None, None), init="zeros")
        p["bv"] = PSpec((hkv, dh), (None, None), init="zeros")
    return p


def _check_index(index: int, L: int) -> None:
    if not 0 <= index < L:
        raise IndexError(f"cache index {index} outside a cache of {L}")


def gqa_apply(p, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, *, cache: Optional[Dict] = None,
              cache_index: Optional[int] = None,
              kv_override: Optional[Tuple[torch.Tensor]] = None,
              causal: bool = True, tp=None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA attention.  With ``cache``, runs single-token decode at
    ``cache_index`` and returns the cache, updated in place.
    ``kv_override`` supplies external K/V source states (cross-attention).
    ``tp``: ``wq``/``bq``/``wo`` are this rank's blocks of heads where
    ``heads_cut``.
    """
    cdt = compute_dtype(cfg)
    tp = tp if heads_cut(cfg) else None
    q = einsum("bsd,dhk->bshk", TP.enter(x, tp), p["wq"].to(cdt))
    if "bq" in p:
        q = q + p["bq"].to(cdt)
    src = x if kv_override is None else kv_override[0]
    k = einsum("bsd,dhk->bshk", src, p["wk"].to(cdt))
    v = einsum("bsd,dhk->bshk", src, p["wv"].to(cdt))
    if "bk" in p:
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    if kv_override is None:  # self-attention: rope
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    n_q = q.shape[2]
    if tp is not None:
        lo = TP.lo(tp, n_q)
        kvs = TP.kv_heads(lo, n_q, cfg.n_heads // cfg.n_kv_heads)

    def own(t):
        """The kv heads of this rank's q heads."""
        return t if tp is None else t[:, :, kvs]

    if cache is not None:
        L = cache["k"].shape[1]
        int8_cache = bool(cfg.kv_cache_int8_scale)
        rolling = bool(cfg.attn_window) and L <= cfg.attn_window
        if int8_cache:
            k, ks_new = kv_quantize(k)
            v, vs_new = kv_quantize(v)
        if cfg.seq_shard_decode and not rolling:
            # the reference's flash decode takes every q head: gather them,
            # then keep this rank's outputs
            q_all = TP.gather(q, 2, tp)
            if int8_cache:
                out = seqshard_decode_gqa_int8(
                    q_all, cache["k"], cache["v"], cache["ks"], cache["vs"],
                    k, v, ks_new, vs_new, cache_index)[0]
            else:
                out = seqshard_decode_gqa(q_all, cache["k"], cache["v"], k,
                                          v, cache_index)[0]
            if tp is not None:
                out = out[:, :, lo:lo + n_q]
        else:
            # rolling window cache: slot = index mod window; every resident
            # entry is in-window by construction (keys carry absolute RoPE,
            # softmax is order-invariant)
            slot = cache_index % L if rolling else cache_index
            _check_index(slot, L)
            cache["k"][:, slot] = k[:, 0]
            cache["v"][:, slot] = v[:, 0]
            scales = None
            if int8_cache:
                cache["ks"][:, slot] = ks_new[:, 0]
                cache["vs"][:, slot] = vs_new[:, 0]
                scales = (own(cache["ks"]), own(cache["vs"]))
            if rolling:
                out = decode_attention(q, own(cache["k"]), own(cache["v"]),
                                       min(cache_index + 1, L), window=0,
                                       kv_scales=scales)
            else:
                out = decode_attention(q, own(cache["k"]), own(cache["v"]),
                                       cache_index + 1,
                                       window=cfg.attn_window,
                                       kv_scales=scales)
        new_cache = cache
    else:
        out = flash_attention(q, own(TP.enter(k, tp)), own(TP.enter(v, tp)),
                              causal=causal and kv_override is None,
                              window=cfg.attn_window)
        if cfg.kv_cache_int8_scale:  # prefill fills an int8 cache
            kq, kss = kv_quantize(k)
            vq, vss = kv_quantize(v)
            new_cache = {"k": kq, "v": vq, "ks": kss, "vs": vss}
        else:
            new_cache = {"k": k, "v": v}  # prefill: return built cache
    y = einsum("bshk,hkd->bsd", out, p["wo"].to(cdt))
    return TP.leave(y, tp), new_cache


# --------------------------------------------------------------------- MLA --

def mla_abstract(cfg: ModelConfig) -> Dict[str, PSpec]:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim
    return {
        "w_dq": PSpec((d, m.q_lora_rank), ("fsdp", None)),
        "q_norm": PSpec((m.q_lora_rank,), (None,), init="ones"),
        "w_uq": PSpec((m.q_lora_rank, h, qk + m.qk_rope_dim),
                      (None, "tp", None)),
        "w_dkv": PSpec((d, m.kv_lora_rank + m.qk_rope_dim), ("fsdp", None)),
        "kv_norm": PSpec((m.kv_lora_rank,), (None,), init="ones"),
        "w_uk": PSpec((m.kv_lora_rank, h, qk), (None, "tp", None)),
        "w_uv": PSpec((m.kv_lora_rank, h, m.v_head_dim), (None, "tp", None)),
        "wo": PSpec((h, m.v_head_dim, d), ("tp", None, "fsdp")),
    }


def mla_apply(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
              *, cache: Optional[Dict] = None,
              cache_index: Optional[int] = None, tp=None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Multi-head Latent Attention.

    Prefill/train: expanded form (per-head K/V made from the latent).
    Decode: absorbed form -- the cache stores only (c_kv, k_rope), and the
    queries are projected into the latent space, so decode is MQA with one
    (kv_lora + rope)-dim KV head.  ``tp``: ``w_uq``/``w_uk``/``w_uv``/``wo``
    are this rank's blocks of heads; the latents, computed whole, enter
    through ``tp.enter`` after their norms."""
    m: MLAConfig = cfg.mla
    cdt = compute_dtype(cfg)
    b, s, _ = x.shape
    qk, qr = m.qk_nope_dim, m.qk_rope_dim

    cq = rmsnorm(einsum("bsd,dr->bsr", x, p["w_dq"].to(cdt)), p["q_norm"])
    q = einsum("bsr,rhk->bshk", TP.enter(cq, tp), p["w_uq"].to(cdt))
    h = q.shape[2]                          # this rank's heads under ``tp``
    q_nope, q_rope = q[..., :qk], q[..., qk:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    dkv = einsum("bsd,dr->bsr", x, p["w_dkv"].to(cdt))
    c_kv = rmsnorm(dkv[..., :m.kv_lora_rank], p["kv_norm"])
    k_rope = apply_rope(dkv[..., None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)

    scale = (qk + qr) ** -0.5
    if cache is not None:
        q_lat = einsum("bshk,rhk->bshr", q_nope, p["w_uk"].to(cdt))
        q_abs = torch.cat([q_lat, q_rope], dim=-1)             # (B,1,H,r+qr)
        if cfg.seq_shard_decode:
            q_abs = TP.gather(q_abs, 2, tp)
            # MQA with one (r + qr)-dim KV head over the cache's L shard;
            # ``v_full`` is a view of ``ckv``, so its update is the cache's
            L_local = cache["ckv"].shape[1]
            lo = _shard_lo(L_local, cache_index)
            _masked_update(cache["kr"], k_rope[:, :, 0], cache_index, lo)
            k_full = torch.cat([cache["ckv"], cache["kr"]],
                               dim=-1)[:, :, None]
            v_full = cache["ckv"][:, :, None]
            k_new = torch.cat([c_kv, k_rope[:, :, 0]], dim=-1)[:, :, None]
            o_lat = seqshard_decode_gqa(q_abs, k_full, v_full, k_new,
                                        c_kv[:, :, None], cache_index,
                                        scale=scale)[0]
            if tp is not None:
                o_lat = o_lat.narrow(2, TP.lo(tp, h), h)
        else:
            _check_index(cache_index, cache["ckv"].shape[1])
            cache["ckv"][:, cache_index] = c_kv[:, 0]
            cache["kr"][:, cache_index] = k_rope[:, 0, 0]
            k_full = torch.cat([cache["ckv"], cache["kr"]],
                               dim=-1)[:, :, None]
            v_full = cache["ckv"][:, :, None]
            o_lat = decode_attention(q_abs, k_full, v_full, cache_index + 1,
                                     scale=scale)
        out = einsum("bshr,rhv->bshv", o_lat.to(cdt), p["w_uv"].to(cdt))
        new_cache = cache
    else:
        c_in = TP.enter(c_kv, tp)
        k_nope = einsum("bsr,rhk->bshk", c_in, p["w_uk"].to(cdt))
        v = einsum("bsr,rhv->bshv", c_in, p["w_uv"].to(cdt))
        k = torch.cat([k_nope, TP.enter(k_rope, tp).expand(b, s, h, qr)],
                      dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        out = flash_attention(qfull, k, v, causal=True)
        new_cache = {"ckv": c_kv, "kr": k_rope[:, :, 0, :]}
    y = einsum("bshv,hvd->bsd", out, p["wo"].to(cdt))
    return TP.leave(y, tp), new_cache


# --------------------------------------------------------------------- MLP --

def mlp_abstract(cfg: ModelConfig, d_ff: Optional[int] = None
                 ) -> Dict[str, PSpec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w1": PSpec((d, f), ("fsdp", "tp")),   # gate
        "w3": PSpec((d, f), ("fsdp", "tp")),   # up
        "w2": PSpec((f, d), ("tp", "fsdp")),   # down
    }


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig, tp=None
              ) -> torch.Tensor:
    """The gated MLP; ``tp``: ``w1``/``w3`` column- and ``w2`` row-parallel
    blocks of the hidden width."""
    cdt = compute_dtype(cfg)
    x = TP.enter(x, tp)
    g = einsum("bsd,df->bsf", x, p["w1"].to(cdt))
    u = einsum("bsd,df->bsf", x, p["w3"].to(cdt))
    return TP.leave(einsum("bsf,fd->bsd", silu(g) * u, p["w2"].to(cdt)), tp)


# ------------------------------------------------------- int8 KV cache -----

def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """HP-MDR-style per-(token, head) exponent alignment: int8 mantissa +
    one bf16 scale per head-vector (1/dh overhead).  Returns (q, scales).
    The reference's order: ``x / scale * 127`` in float32, round half to
    even, clip, convert; the scale rounded to bfloat16."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8)
    q = torch.clamp(torch.round(xf / scale * 127.0), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)[..., 0]


def kv_dequantize(q: torch.Tensor, scales: torch.Tensor, dtype
                  ) -> torch.Tensor:
    return (q.float() * (scales.float()[..., None] / 127.0)).to(dtype)


# ------------------------------------------------ seq-sharded flash decode --

def _lse_combine(acc, m, l, axis: str):
    """Flash-decoding cross-shard combine of (acc, m, l) partials."""
    m_g = shd.pmax(m, axis)
    corr = torch.exp(m - m_g)                     # (b,hkv,g,1)
    l_g = shd.psum(l * corr, axis)
    corr_b = corr.permute(0, 3, 1, 2)[..., None]
    acc_g = shd.psum(acc * corr_b, axis)
    return acc_g, l_g


def _shard_lo(L_local: int, index: int) -> int:
    """The first cache position of this rank's L shard over 'model'; the
    global ``index`` must fall in the whole cache."""
    mesh = shd.get_current_mesh()
    if mesh is None or "model" not in mesh.shape:
        raise RuntimeError(
            "seq_shard_decode shards the cache's L axis over the 'model' "
            "axis of the current mesh: run under sharding.use_mesh with a "
            "mesh that has one")
    _check_index(index, L_local * mesh.shape["model"])
    return mesh.index("model") * L_local


def _masked_update(cache_local, new, index: int, lo: int) -> None:
    """Write ``new`` (B, 1, ...) at position ``index`` if it falls in this
    shard's [lo, lo + L_local), in place."""
    off = index - lo
    if 0 <= off < cache_local.shape[1]:
        cache_local[:, off] = new[:, 0].to(cache_local.dtype)


def _seqshard_attend(q, kc, vc, index: int, lo: int, scale, kv_scales=None):
    """This shard's partial attention for the token at ``index``, combined
    over 'model'."""
    clen_local = min(max(index + 1 - lo, 0), kc.shape[1])
    acc, m, l = decode_attention(q, kc, vc, clen_local, window=0,
                                 scale=scale, return_lse=True,
                                 kv_scales=kv_scales)
    acc_g, l_g = _lse_combine(acc, m, l, "model")
    l_b = l_g.permute(0, 3, 1, 2)[..., None]
    out = (acc_g / torch.clamp_min(l_b, 1e-30)).to(q.dtype)
    return out.reshape(q.shape[0], 1, q.shape[2], vc.shape[-1])


def seqshard_decode_gqa(q, k_cache, v_cache, k_new, v_new, index: int, *,
                        scale=None):
    """Flash-decoding with the KV cache sharded over 'model' on the L axis,
    on each rank: ``k_cache``/``v_cache`` are this rank's (B, L/tp, Hkv,
    dh) shards, updated in place at the global ``index``.

    All heads are computed on every model shard (decode is memory-bound;
    the cache READ is the cost and it is perfectly sharded -- wire traffic
    is one (B,1,H,dv) + LSE psum per layer).  Returns (out, k_cache,
    v_cache).  The reference's ``batch_axes`` argument places the batch
    dim of its global cache; a rank's shard needs none."""
    lo = _shard_lo(k_cache.shape[1], index)
    _masked_update(k_cache, k_new, index, lo)
    _masked_update(v_cache, v_new, index, lo)
    return (_seqshard_attend(q, k_cache, v_cache, index, lo, scale),
            k_cache, v_cache)


def seqshard_decode_gqa_int8(q, k_cache, v_cache, ks_cache, vs_cache,
                             k_new, v_new, ks_new, vs_new, index: int, *,
                             scale=None):
    """Flash-decoding over an int8, per-(token,head)-aligned KV cache
    sharded over 'model' on the L axis (HP-MDR alignment on serving
    state): cache reads are half the bytes.  Returns (out, k_cache,
    v_cache, ks_cache, vs_cache), the caches updated in place."""
    lo = _shard_lo(k_cache.shape[1], index)
    for c, n in ((k_cache, k_new), (v_cache, v_new), (ks_cache, ks_new),
                 (vs_cache, vs_new)):
        _masked_update(c, n, index, lo)
    out = _seqshard_attend(q, k_cache, v_cache, index, lo, scale,
                           kv_scales=(ks_cache, vs_cache))
    return out, k_cache, v_cache, ks_cache, vs_cache
