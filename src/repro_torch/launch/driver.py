"""Shared greedy prefill+decode serving driver.

A port of ``repro.launch.driver``.  ``serve_greedy`` makes a model and
random prompts from seeds and hands them to ``greedy_decode``, the loop
itself (prefill, argmax, single-token decode steps against the cache), which
takes any model, parameter tree and prompts: the CLI
(``repro_torch.launch.serve``) and the tests run the same loop.  Prefill and
the decode steps are each timed between two ``torch.cuda.synchronize()``
calls on the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor       # (B, new_tokens) greedy token ids
    logits: torch.Tensor       # (B, new_tokens, V) float32, each step's
    prefill_s: float           # wall time of the prefill call
    decode_s: float            # wall time of all decode steps
    new_tokens: int

    @property
    def ms_per_token(self) -> float:
        return self.decode_s * 1e3 / max(self.new_tokens - 1, 1)


def build_inputs(cfg: ModelConfig, batch: int, prompt_len: int,
                 seed: int = 1, device: DeviceLike = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Random prompt ids (+ bfloat16 vision states when the arch
    cross-attends), drawn on the CPU from ``seed`` so that every device
    gets the same prompts, then placed on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen)
    vis = None
    if cfg.cross_attn_period:
        vis = torch.randn((batch, cfg.n_vision_tokens, cfg.d_model),
                          generator=gen).to(torch.bfloat16).to(dev)
    return prompts.to(dev), vis


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def greedy_decode(model: Model, params: Optional[Dict],
                  prompts: torch.Tensor, new_tokens: int,
                  vision_states: Optional[torch.Tensor] = None
                  ) -> ServeResult:
    """Prefill ``prompts`` (B, S) with ``params`` (``None``: the model's
    own tree), then greedy-decode ``new_tokens`` ids."""
    if model.cfg.encoder_only:
        raise ValueError(f"{model.cfg.name} is encoder-only: no decode step")
    dev = prompts.device
    prompt_len = prompts.shape[1]
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, tokens=prompts,
                                  max_len=prompt_len + new_tokens,
                                  vision_states=vision_states)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    generated, step_logits = [tok], [logits[:, -1]]
    t0 = time.perf_counter()
    for i in range(new_tokens - 1):
        logits, cache = model.decode_step(params, cache, prompt_len + i, tok,
                                          vision_states=vision_states)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        generated.append(tok)
        step_logits.append(logits[:, -1])
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return ServeResult(tokens=torch.cat(generated, dim=1),
                       logits=torch.stack(step_logits, dim=1),
                       prefill_s=prefill_s, decode_s=decode_s,
                       new_tokens=new_tokens)


def serve_greedy(cfg: ModelConfig, batch: int, prompt_len: int,
                 new_tokens: int, param_seed: int = 0, input_seed: int = 1,
                 device: DeviceLike = None) -> ServeResult:
    """Prefill a batch of random prompts, then greedy-decode
    ``new_tokens`` ids on ``device`` (``None`` means ``cuda``), with the
    parameters held in the compute dtype (``Model.compute_params``)."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    dev = resolve_device(device)
    model = Model(cfg, device=dev, seed=param_seed)
    prompts, vis = build_inputs(cfg, batch, prompt_len, seed=input_seed,
                                device=dev)
    return greedy_decode(model, model.compute_params(), prompts, new_tokens,
                         vis)
