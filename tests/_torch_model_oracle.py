"""The JAX reference's outputs for one architecture at its ``SMOKE`` size,
and the port's checks against them (shared by ``tests/test_torch_models*.py``).

The reference's parameters (``Model.init(PRNGKey(0))``, as numpy) are carried
across with ``params_from_reference``; token and embedding inputs are made
with numpy from a seed; the port runs on the CPU.  Each arch's reference
outputs are computed once per test module (a module-scoped fixture).

Tolerance, float32 compute: logits, caches and decode steps within
``1e-4 x max|reference|`` (XLA and torch round their sums in different
orders; ~1e-5 is typical); jamba's within ``1e-3``: its smoke Mamba state
reaches 1e7, and the float32 ulps it carries grow through 8 layers (a
single Mamba layer agrees within 6e-7).  The loss within 1e-5 relative.
Greedy tokens are equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import smoke_config as jsmoke
from repro.launch import driver as jdriver
from repro.models.model import Model as JModel
from repro_torch.configs.base import smoke_config
from repro_torch.launch import driver
from repro_torch.models.model import Model
from repro_torch.models.params import _leaf_tensor, params_from_reference

B, S = 2, 24                      # forward / prefill+decode inputs
SERVE = dict(batch=2, prompt_len=8, new_tokens=6)
TOL = {"jamba-v0.1-52b": 1e-3}


def tol(arch):
    return TOL.get(arch, 1e-4)


def to_torch(x):
    return None if x is None else _leaf_tensor(np.asarray(x))


def leaves_with_paths(tree):
    """(path, leaf) in the reference's flattening order, for either tree."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            out.append((path, t))
    walk(tree, ())
    return out


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def close(a, b, rtol, what=""):
    a = as_np(a).astype(np.float64)
    b = as_np(b).astype(np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err, top = np.abs(a - b).max(), np.abs(a).max()
    assert err <= rtol * top, (what, err, top)


def reference_outputs(arch):
    """Everything the tests hold the port against, from the reference."""
    cfg = jsmoke(arch)
    jm = JModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    out = {"params": jax.tree.map(np.asarray, params)}
    if cfg.external_embed:
        emb = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        out.update(embeds=emb, labels=labels,
                   forward=np.asarray(jm.forward(params,
                                                 embeds=jnp.asarray(emb))),
                   loss=float(jm.loss(params, {"embeds": jnp.asarray(emb),
                                               "labels": jnp.asarray(labels)})))
        return out
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    vis = None
    if cfg.cross_attn_period:
        vis = rng.normal(size=(B, cfg.n_vision_tokens, cfg.d_model)
                         ).astype(np.float32)
    jvis = None if vis is None else jnp.asarray(vis)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    if vis is not None:
        batch["vision_states"] = jvis
    logits_p, cache = jm.prefill(params, tokens=jnp.asarray(toks[:, :-1]),
                                 vision_states=jvis, max_len=S + 4)
    dec, _ = jm.decode_step(params, cache, jnp.int32(S - 1),
                            jnp.asarray(toks[:, -1:]), vision_states=jvis)
    prompts, pvis = jdriver.build_inputs(cfg, SERVE["batch"],
                                         SERVE["prompt_len"], seed=1)
    served = jdriver.serve_greedy(cfg, **SERVE, param_seed=0, input_seed=1)
    out.update(
        tokens=toks, labels=labels, vision=vis,
        forward=np.asarray(jm.forward(params, tokens=jnp.asarray(toks),
                                      vision_states=jvis)),
        loss=float(jm.loss(params, batch)),
        prefill=np.asarray(logits_p),
        cache=[(p, np.asarray(v)) for p, v in leaves_with_paths(cache)],
        decode=np.asarray(dec),
        serve_prompts=np.asarray(prompts),
        serve_vision=None if pvis is None else np.asarray(pvis),
        serve_tokens=np.asarray(served.tokens))
    return out


def port_model(arch, ref):
    return Model(smoke_config(arch), params_from_reference(ref["params"],
                                                           "cpu"),
                 device="cpu")


# ------------------------------------------------------- the port's checks --

def check_forward_and_loss(arch, ref):
    m = port_model(arch, ref)
    if m.cfg.external_embed:
        emb = torch.from_numpy(ref["embeds"])
        close(ref["forward"], m.forward(None, embeds=emb), tol(arch))
        loss = m.loss(None, {"embeds": emb,
                             "labels": torch.from_numpy(ref["labels"])})
    else:
        toks = torch.from_numpy(ref["tokens"])
        vis = to_torch(ref["vision"])
        close(ref["forward"], m.forward(None, tokens=toks,
                                        vision_states=vis), tol(arch))
        batch = {"tokens": toks, "labels": torch.from_numpy(ref["labels"])}
        if vis is not None:
            batch["vision_states"] = vis
        loss = m.loss(None, batch)
    assert float(loss) == pytest.approx(ref["loss"], rel=1e-5)


def check_prefill_and_caches(arch, ref):
    m = port_model(arch, ref)
    toks = torch.from_numpy(ref["tokens"])
    logits, cache = m.prefill(None, tokens=toks[:, :-1],
                              vision_states=to_torch(ref["vision"]),
                              max_len=S + 4)
    close(ref["prefill"], logits, tol(arch))
    got = leaves_with_paths(cache)
    assert [p for p, _ in got] == [p for p, _ in ref["cache"]]
    for (path, want), (_, have) in zip(ref["cache"], got):
        assert tuple(have.shape) == want.shape, path
        assert str(have.dtype).split(".")[-1] == str(want.dtype), path
        close(want, have, tol(arch), path)


def check_decode_step(arch, ref):
    """decode(prefill(x[:-1]), x[-1]) against the reference's, and against
    the port's own forward at the last position."""
    m = port_model(arch, ref)
    toks = torch.from_numpy(ref["tokens"])
    vis = to_torch(ref["vision"])
    with torch.inference_mode():
        _, cache = m.prefill(None, tokens=toks[:, :-1], vision_states=vis,
                             max_len=S + 4)
        out, cache2 = m.decode_step(None, cache, S - 1, toks[:, -1:],
                                    vision_states=vis)
        full = m.forward(None, tokens=toks, vision_states=vis)
    assert cache2 is cache
    close(ref["decode"], out, tol(arch))
    close(full[:, -1], out[:, 0], tol(arch))


def check_greedy_tokens(arch, ref):
    """The driver loop on the reference's prompts and parameters gives the
    reference driver's tokens."""
    m = port_model(arch, ref)
    res = driver.greedy_decode(m, None, to_torch(ref["serve_prompts"]),
                               SERVE["new_tokens"],
                               to_torch(ref["serve_vision"]))
    assert res.tokens.dtype == torch.int32
    assert res.logits.shape == (SERVE["batch"], SERVE["new_tokens"],
                                m.cfg.vocab_size)
    np.testing.assert_array_equal(res.tokens.numpy(), ref["serve_tokens"])
    np.testing.assert_array_equal(res.logits.argmax(-1).numpy(),
                                  ref["serve_tokens"])
