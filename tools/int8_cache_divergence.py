#!/usr/bin/env python3
"""How far the int8 KV cache moves qwen2-7b's logits, in the reference and
in the port, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/int8_cache_divergence.py \
        [--layers 2] [--vocab 4096] [--batch 2] [--prompt 32] [--steps 8]

needs jax and torch (CPU builds are enough).  qwen2-7b's published widths
(``configs/qwen2_7b.py``) with depth and vocabulary cut to the arguments;
the reference's ``Model.init(PRNGKey(0))`` weights, carried into the port
with ``params_from_reference``; seeded prompts.  The reference greedy-
decodes ``--steps`` tokens with its bfloat16 cache (jitted, as its driver
runs); then each package runs prefill + decode with the bfloat16 and with
the int8 cache (``kv_cache_int8_scale=8.0``) on those tokens
(teacher-forced).  Prints, per package, the top-1 agreement of int8 with
bfloat16 and the largest |int8 - bf16| over max|bf16 logit|, in all and
at each step, and how far the port's bfloat16 logits are from the
reference's.  On random weights the int8 cache's divergence is a property
of the reference's design, which the port should reproduce step by step.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_reference  # noqa: E402

INT8 = dict(kv_cache_int8_scale=8.0)


def reference_logits(model, params, toks, steps, feed=None):
    """Prefill ``toks``, then ``steps - 1`` decode steps fed ``feed``'s
    tokens (``None``: greedy, the argmax of each step): the last
    position's logits at each step (B, steps, V) and the tokens fed."""
    max_len = toks.shape[1] + steps
    prefill = jax.jit(lambda p, t: model.prefill(p, tokens=t,
                                                 max_len=max_len))
    decode = jax.jit(lambda p, c, i, t: model.decode_step(p, c, i, t))
    logits, cache = prefill(params, jnp.asarray(toks))
    out, fed = [np.asarray(logits[:, -1])], []
    for i in range(steps - 1):
        tok = (out[-1].argmax(-1)[:, None].astype(np.int32) if feed is None
               else feed[:, i:i + 1])
        fed.append(tok)
        logits, cache = decode(params, cache, jnp.int32(toks.shape[1] + i),
                               jnp.asarray(tok))
        out.append(np.asarray(logits[:, -1]))
    return np.stack(out, axis=1), np.concatenate(fed, axis=1)


@torch.inference_mode()
def port_logits(model, toks, tokens_in):
    logits, cache = model.prefill(
        None, tokens=torch.from_numpy(toks),
        max_len=toks.shape[1] + tokens_in.shape[1] + 1)
    out = [logits[:, -1].numpy()]
    for i in range(tokens_in.shape[1]):
        logits, cache = model.decode_step(
            None, cache, toks.shape[1] + i,
            torch.from_numpy(tokens_in[:, i:i + 1]))
        out.append(logits[:, -1].numpy())
    return np.stack(out, axis=1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(a).max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    cut = dict(n_layers=args.layers, vocab_size=args.vocab)
    rcfg = dataclasses.replace(ref_config("qwen2-7b"), **cut)
    cfg = dataclasses.replace(get_config("qwen2-7b"), **cut)
    ref, ref8 = RefModel(rcfg), RefModel(dataclasses.replace(rcfg, **INT8))
    params = ref.init(jax.random.PRNGKey(0))
    tree = params_from_reference(jax.tree.map(np.asarray, params), "cpu")
    port = Model(cfg, tree, device="cpu")
    port8 = Model(dataclasses.replace(cfg, **INT8), port.params,
                  device="cpu")
    toks = np.random.default_rng(1).integers(
        0, args.vocab, (args.batch, args.prompt)).astype(np.int32)

    # the reference's greedy tokens with its bf16 cache feed every run
    r16, seq = reference_logits(ref, params, toks, args.steps)
    r8, _ = reference_logits(ref8, params, toks, args.steps, feed=seq)
    p16 = port_logits(port, toks, seq)
    p8 = port_logits(port8, toks, seq)
    for name, a, b in (("reference", r16, r8), ("port", p16, p8)):
        agree = float((a.argmax(-1) == b.argmax(-1)).mean())
        steps = ", ".join(f"{rel(a[:, i], b[:, i]):.4f}"
                          for i in range(a.shape[1]))
        print(f"{name}: int8 vs bf16 cache, top-1 agreement {agree:.3f}, "
              f"max relative logit difference {rel(a, b):.4f}; per step "
              f"{steps}")
    print(f"port vs reference, bf16 cache: {rel(r16, p16):.4f} of "
          f"max|logit| ({np.abs(r16).max():.3f})")


if __name__ == "__main__":
    main()
