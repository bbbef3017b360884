"""Attention-free sequence mixers: RWKV6 (Finch) and Mamba (selective SSM).

A port of ``repro.models.ssm``.  On the card and on ``meta`` each scan (the
reference's compiled ``lax.scan``) is one operator of ``kernels.scan``,
at every length (a decode step is one launch): ``wkv6`` for RWKV6,
``mamba_scan`` for Mamba, hand-written CUDA kernels whose forward keeps
the state entering every ``REMAT_CHUNK`` (64) steps under autograd and
whose backward recomputes each chunk from it (the reference's
``jax.checkpoint`` around its inner scan).  Nothing sends a card run to
the loop.  On the CPU the scan is a Python loop over tokens (``_scan``),
held bit-identical to the reference by the tests, and decode is the same
step applied once to the carried state.  When autograd records and the
sequence is a multiple of ``REMAT_CHUNK`` steps longer than one, the loop
runs as chunks of 64 steps, each under ``torch.utils.checkpoint``: the
backward keeps only the states at chunk boundaries and recomputes a
chunk's steps (64x fewer states; the gradients are the same bits, since
the recomputed graph is the recorded one).  Either runs inside an
``ssm.scan`` span (host wall).

RWKV6 has the data-dependent decay ``w_t = exp(-exp(w0 + lora(x_t)))``
and Finch's ddlerp token-shift mixers (arXiv:2404.05892).  Mamba is the
selective SSM (S4D discretization, input-dependent Delta/B/C) with the
depthwise causal conv, as in Jamba's Mamba layers.

Under ``tp`` (``distributed.tp.context``) Mamba computes on the rank's
channels of ``d_inner``, the blocks its specs cut over 'model', as GSPMD
does: ``in_proj`` re-cut to the rank's channels of ``x`` and ``z``
(``tp.recut``) and column-parallel behind ``tp.enter``; the conv, the
delta's up-projection, ``A``, the skip and the gate on those channels;
``w_dt_down``, ``w_b`` and ``w_c`` row-parallel, their partial sums
all-reduced forward and backward (``tp.summed``: every rank's channels
read the sums); ``out_proj`` row-parallel behind ``tp.leave``.  The decode
state is whole on every rank (``cache_shardings``): a step reads its
channels and returns its channels of the new state, which
``transformer.stack_apply`` gathers whole where a cache keeps it.  RWKV's
time mix gathers its leaves whole over 'model' (``tp.whole``); no config
cuts them.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tp as TP
from repro_torch.kernels import scan as scan_ops
from repro_torch.models.layers import compute_dtype, einsum, sigmoid, silu
from repro_torch.models.params import PSpec
from repro_torch.obs import trace as obs_trace

RWKV_HEAD_DIM = 64
DDLERP_RANK = 32
DECAY_RANK = 64
REMAT_CHUNK = 64        # steps a rematerialized chunk of a scan; 0: none
                        # (the loop's; the operators take 1 to 64)


def _on_operators(t: torch.Tensor) -> bool:
    """A scan over ``t`` runs as an operator of ``kernels.scan``: on the
    card and on ``meta``; the CPU runs the loop."""
    return t.device.type != "cpu"


def _steps(step, carry, *xs):
    """``step(carry, *x_t) -> (carry, y_t)`` over dim 1 of ``xs``:
    (the last carry, the ``y_t`` stacked along dim 1)."""
    ys = []
    for t in range(xs[0].shape[1]):
        carry, y = step(carry, *(x[:, t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


def _scan(step, carry, *xs):
    """:func:`_steps` over the whole sequence, as chunks of ``REMAT_CHUNK``
    steps under ``checkpoint`` when autograd records and the length is a
    multiple of the chunk longer than one (the reference's rule)."""
    s, c = xs[0].shape[1], REMAT_CHUNK
    records = torch.is_grad_enabled() and any(
        t.requires_grad for t in (carry,) + xs)
    if not (records and c and s % c == 0 and s > c):
        return _steps(step, carry, *xs)
    ys = []
    for lo in range(0, s, c):
        carry, y = checkpoint(_steps, step, carry,
                              *(x[:, lo:lo + c] for x in xs),
                              use_reentrant=False)
        ys.append(y)
    return carry, torch.cat(ys, dim=1)


# ------------------------------------------------------------------- RWKV6 --

def rwkv_time_mix_abstract(cfg: ModelConfig) -> Dict[str, PSpec]:
    d = cfg.d_model
    h = d // RWKV_HEAD_DIM
    tp = "tp" if h % 16 == 0 else None
    return {
        "mu_x": PSpec((d,), (None,), init="zeros"),
        "mu": PSpec((5, d), (None, None), init="zeros"),       # w,k,v,r,g
        "ddlerp_a": PSpec((d, 5 * DDLERP_RANK), ("fsdp", None)),
        "ddlerp_b": PSpec((5, DDLERP_RANK, d), (None, None, None),
                          init="zeros"),
        "w0": PSpec((d,), (None,), init="zeros"),
        "decay_a": PSpec((d, DECAY_RANK), ("fsdp", None)),
        "decay_b": PSpec((DECAY_RANK, d), (None, None), init="zeros"),
        "u": PSpec((d,), (None,), init="zeros"),               # bonus
        "wr": PSpec((d, d), ("fsdp", tp)),
        "wk": PSpec((d, d), ("fsdp", tp)),
        "wv": PSpec((d, d), ("fsdp", tp)),
        "wg": PSpec((d, d), ("fsdp", tp)),
        "ln_w": PSpec((d,), (None,), init="ones"),             # per-head groupnorm
        "wo": PSpec((d, d), (tp, "fsdp")),
    }


def _shifted(x: torch.Tensor, state: Optional[Dict], cdt) -> torch.Tensor:
    """The token-shift input: the previous token (zero, or the carried
    ``shift`` state, before the first)."""
    if state is None:
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    return state["shift"][:, None, :].to(cdt)


def _rwkv_ddlerp(p, x, sx, cdt):
    """Finch data-dependent lerp: five mixed inputs (w,k,v,r,g)."""
    dx = sx - x
    xxx = x + dx * p["mu_x"].to(cdt)
    a = torch.tanh(einsum("btd,dr->btr", xxx, p["ddlerp_a"].to(cdt)))
    a = a.reshape(*a.shape[:-1], 5, DDLERP_RANK)
    mix = p["mu"].to(cdt) + einsum("btir,ird->btid", a,
                                   p["ddlerp_b"].to(cdt))
    return [x + dx * mix[..., i, :] for i in range(5)]


def rwkv_time_mix_apply(p, x: torch.Tensor, cfg: ModelConfig,
                        state: Optional[Dict] = None, tp=None
                        ) -> Tuple[torch.Tensor, Dict]:
    """x: (B,S,D). state (decode): {'shift': (B,D), 'wkv': (B,H,K,V)}.
    ``tp``: the leaves are blocks cut over 'model', gathered whole here."""
    p = TP.whole(p, rwkv_time_mix_abstract(cfg), tp)
    cdt = compute_dtype(cfg)
    b, s, d = x.shape
    hd = RWKV_HEAD_DIM
    h = d // hd
    sx = _shifted(x, state, cdt)
    S = (torch.zeros((b, h, hd, hd), device=x.device) if state is None
         else state["wkv"])
    xw, xk, xv, xr, xg = _rwkv_ddlerp(p, x, sx, cdt)

    # data-dependent decay (the Finch signature); the low-rank product
    # contracts x with decay_a first, as the reference's einsum path does
    wlog = p["w0"].float() + (xw.float() @ p["decay_a"].float()
                              ) @ p["decay_b"].float()
    w = torch.exp(-torch.exp(torch.clamp(wlog, -8.0, 4.0)))    # (B,S,D) in (0,1)

    r = einsum("btd,de->bte", xr, p["wr"].to(cdt))
    k = einsum("btd,de->bte", xk, p["wk"].to(cdt))
    v = einsum("btd,de->bte", xv, p["wv"].to(cdt))
    g = silu(einsum("btd,de->bte", xg, p["wg"].to(cdt)))

    rh = r.reshape(b, s, h, hd).float()
    kh = k.reshape(b, s, h, hd).float()
    vh = v.reshape(b, s, h, hd).float()
    wh = w.reshape(b, s, h, hd)
    u = p["u"].float().reshape(h, hd)

    with obs_trace.span("ssm.scan", kind="rwkv6", steps=s):
        if _on_operators(x):
            out, S = scan_ops.wkv6(rh, kh, vh, wh, u, S, REMAT_CHUNK)
        else:
            S, out = _scan(functools.partial(_rwkv_step, u[None, :, :, None]),
                           S, rh, kh, vh, wh)                 # (B,S,H,V)

    # per-head groupnorm
    mean = torch.mean(out, dim=-1, keepdim=True)
    var = torch.mean(torch.square(out - mean), dim=-1, keepdim=True)
    out = (out - mean) * torch.rsqrt(var + 64e-5)
    out = out.reshape(b, s, d) * p["ln_w"].float()
    y = einsum("btd,de->bte", out.to(cdt) * g, p["wo"].to(cdt))
    return y, {"shift": x[:, -1, :], "wkv": S}


def _rwkv_step(u, S, rt, kt, vt, wt):
    kv = kt[:, :, :, None] * vt[:, :, None, :]                # (B,H,K,V)
    out = torch.einsum("bhk,bhkv->bhv", rt, S + u * kv)
    return wt[:, :, :, None] * S + kv, out


def rwkv_channel_mix_abstract(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": PSpec((d,), (None,), init="zeros"),
        "mu_r": PSpec((d,), (None,), init="zeros"),
        "wk": PSpec((d, f), ("fsdp", "tp")),
        "wv": PSpec((f, d), ("tp", "fsdp")),
        "wr": PSpec((d, d), ("fsdp", None)),
    }


def rwkv_channel_mix_apply(p, x: torch.Tensor, cfg: ModelConfig,
                           state: Optional[Dict] = None, tp=None
                           ) -> Tuple[torch.Tensor, Dict]:
    """``tp``: ``wk`` column- and ``wv`` row-parallel blocks of the hidden
    width (the MLP's pattern)."""
    cdt = compute_dtype(cfg)
    sx = _shifted(x, state, cdt)
    xk = x + (sx - x) * p["mu_k"].to(cdt)
    xr = x + (sx - x) * p["mu_r"].to(cdt)
    k = einsum("btd,df->btf", TP.enter(xk, tp), p["wk"].to(cdt))
    k = torch.square(torch.relu(k))
    v = TP.leave(einsum("btf,fd->btd", k, p["wv"].to(cdt)), tp)
    r = sigmoid(einsum("btd,de->bte", xr, p["wr"].to(cdt)))
    return r * v, {"shift": x[:, -1, :]}


# ------------------------------------------------------------------- Mamba --

def mamba_abstract(cfg: ModelConfig) -> Dict[str, PSpec]:
    d = cfg.d_model
    ssm = cfg.ssm
    din = ssm.expand * d
    dtr = ssm.dt_rank or d // 16
    ds = ssm.d_state
    return {
        "in_proj": PSpec((d, 2 * din), ("fsdp", "tp")),
        "conv_w": PSpec((ssm.conv_width, din), (None, "tp")),
        "conv_b": PSpec((din,), ("tp",), init="zeros"),
        "w_dt_down": PSpec((din, dtr), ("tp", None)),
        "w_dt_up": PSpec((dtr, din), (None, "tp")),
        "dt_bias": PSpec((din,), ("tp",), init="zeros"),
        "w_b": PSpec((din, ds), ("tp", None)),
        "w_c": PSpec((din, ds), ("tp", None)),
        "a_log": PSpec((din, ds), ("tp", None), init="zeros"),
        "d_skip": PSpec((din,), ("tp",), init="ones"),
        "out_proj": PSpec((din, d), ("tp", "fsdp")),
    }


def _mamba_step(A, h, xt, dtt, bt, ct):
    da = torch.exp(dtt[..., None] * A[None])                   # (B,din,ds)
    h = da * h + (dtt * xt)[..., None] * bt[:, None, :]
    return h, torch.einsum("bds,bs->bd", h, ct)


def mamba_apply(p, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict] = None, tp=None
                ) -> Tuple[torch.Tensor, Dict]:
    """x: (B,S,D).  state (decode): {'conv': (B,W-1,din), 'ssm': (B,din,ds)}.
    ``tp``: the leaves are this rank's blocks of ``d_inner`` (the module
    docstring); the state is read whole and returned as this rank's
    channels."""
    cdt = compute_dtype(cfg)
    ssm = cfg.ssm
    b, s, d = x.shape
    din = p["d_skip"].shape[0]                  # this rank's under ``tp``
    wconv = ssm.conv_width

    w_in = p["in_proj"].to(cdt)
    if tp is not None:
        w_in, x = TP.recut(w_in, tp), TP.enter(x, tp)
    xz = einsum("btd,de->bte", x, w_in)
    xin, z = xz[..., :din], xz[..., din:]

    # depthwise causal conv
    if state is None:
        pad = torch.zeros((b, wconv - 1, din), dtype=cdt, device=x.device)
    else:
        pad = TP.own(state["conv"], -1, tp).to(cdt)
    xpad = torch.cat([pad, xin], dim=1)                        # (B, S+W-1, din)
    conv = sum(xpad[:, i:i + s, :] * p["conv_w"][i].to(cdt)
               for i in range(wconv)) + p["conv_b"].to(cdt)
    xc = silu(conv)

    # the low-rank delta contracts xc with w_dt_down first, as the
    # reference's einsum path does
    dt = TP.summed(einsum("bte,er->btr", xc, p["w_dt_down"].to(cdt)), tp)
    dt = einsum("btr,rf->btf", dt, p["w_dt_up"].to(cdt)) + p["dt_bias"].to(cdt)
    dt = dt.float()
    # softplus; a 0-d zero, which its backward keeps, not a (B,S,din) one
    dt = torch.logaddexp(dt, dt.new_zeros(()))
    Bm = TP.summed(einsum("bte,es->bts", xc, p["w_b"].to(cdt)), tp).float()
    Cm = TP.summed(einsum("bte,es->bts", xc, p["w_c"].to(cdt)), tp).float()
    A = -torch.exp(p["a_log"].float())                         # (din, ds)

    h = (TP.own(state["ssm"], 1, tp) if state is not None
         else torch.zeros((b, din, ssm.d_state), device=x.device))
    xc32 = xc.float()
    with obs_trace.span("ssm.scan", kind="mamba", steps=s):
        if _on_operators(x):
            ys, h = scan_ops.mamba_scan(xc32, dt, Bm, Cm, A, h, REMAT_CHUNK)
        else:
            h, ys = _scan(functools.partial(_mamba_step, A), h, xc32, dt,
                          Bm, Cm)
    y = ys + xc32 * p["d_skip"].float()
    y = y.to(cdt) * silu(z)
    out = TP.leave(einsum("bte,ed->btd", y, p["out_proj"].to(cdt)), tp)
    return out, {"conv": xpad[:, -(wconv - 1):, :], "ssm": h}
