"""Training loop: restart-safe, async-checkpointed, straggler-aware.

A port of ``repro.train.loop`` (fault-tolerance model as there):
  * async MDR checkpoints of ``{"params", "opt", "ef"}`` every
    ``ckpt_every`` steps and at the last, atomic commit, encoded on the
    model's device (``ckpt.manager.AsyncCheckpointer``); the leaf names
    are the reference's, so either package resumes the other's run;
  * on (re)start the loop resumes from the newest valid checkpoint, and a
    crashed run restarts bit-exactly;
  * a per-step wall-time ring buffer drives straggler detection: steps
    slower than ``straggler_factor`` x the rolling median raise a flag and
    call ``on_straggler``;
  * optional progressive gradient compression: every gradient leaf goes
    through ``ef_quantize`` (on the card its ``ef_amax`` and ``ef_apply``
    kernels, ``kernels/optim.py``), its error-feedback residual kept in
    the loop state and checkpointed;
  * AdamW's update of each leaf is one ``adamw_update`` kernel on the
    card (``optim/adamw.py``).

The step runs where the model's parameters are.  The reference draws its
start from ``Model.init(PRNGKey(seed))``; here a run starts from the
model's own tree (``Model(cfg, seed=...)``, or the reference's tree through
``params_from_reference``), so ``TrainerConfig`` has no ``seed``.

Determinism on the card: every op of the step gives the same bits on every
run.  Gathers (the embedding, the MoE dispatch) take their gradient through
``index_put_`` with accumulation, which the card runs as a sorted,
ordered reduction; the MoE combine sums a token's contributions in a fixed
order (``models/moe.py``); matmuls and reductions run one stream and one
algorithm per shape.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import statistics
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt import manager as ckpt_mgr
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.grad_compress import ef_quantize
from repro_torch.models.model import Model
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw
from repro_torch.train.step import value_and_grad


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    log_every: int = 10
    straggler_window: int = 16
    straggler_factor: float = 3.0
    grad_compress_planes: int = 0    # 0 = off


def _block(t: torch.Tensor) -> None:
    """Wait for the device that computes ``t``."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class Trainer:
    def __init__(self, model: Model, opt_cfg: adamw.AdamWConfig,
                 tcfg: TrainerConfig,
                 data_fn: Callable[[int], Dict[str, torch.Tensor]],
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        """``data_fn(step)`` must be a pure function of the step index so a
        restarted run consumes exactly the same stream (resume-exactness),
        its tensors on the model's device."""
        self.model = model
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.data_fn = data_fn
        self.on_straggler = on_straggler
        self.device = tree_leaves(model.params)[0].device
        self.step_times: collections.deque = collections.deque(
            maxlen=tcfg.straggler_window)
        self.straggler_events = 0
        self.metrics_log: list = []
        self.ckpt = ckpt_mgr.AsyncCheckpointer(tcfg.ckpt_dir,
                                               device=self.device)

    def _step(self, params, opt_state, ef_resid, batch):
        loss, grads = value_and_grad(lambda p: self.model.loss(p, batch),
                                     params)
        planes = self.tcfg.grad_compress_planes
        if planes:
            pairs = [ef_quantize(g, r, planes) for g, r in
                     zip(tree_leaves(grads), tree_leaves(ef_resid))]
            grads = tree_unflatten(grads, [q for q, _ in pairs])
            ef_resid = tree_unflatten(ef_resid, [r for _, r in pairs])
        params, opt_state, metrics = adamw.update(grads, opt_state, params,
                                                  self.opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, ef_resid, metrics

    # ------------------------------------------------------------ lifecycle --
    def init_or_resume(self):
        """(params, opt_state, ef residual, start step): the model's tree
        and a fresh state, or the newest checkpoint's, on the model's
        device."""
        params = tree_map(lambda t: t.detach(), self.model.params)
        opt_state = adamw.init(params, self.opt_cfg)
        ef = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)
        step0 = ckpt_mgr.latest_step(self.tcfg.ckpt_dir)
        if step0 is None:
            return params, opt_state, ef, 0
        tree = {"params": params, "opt": opt_state, "ef": ef}
        tree, _ = ckpt_mgr.load(self.tcfg.ckpt_dir, step0, tree,
                                device=self.device)
        print(f"[trainer] resumed from step {step0}")
        return tree["params"], tree["opt"], tree["ef"], step0

    def run(self, crash_at: Optional[int] = None) -> Dict[str, Any]:
        params, opt_state, ef, start = self.init_or_resume()
        t = self.tcfg
        step = start
        while step < t.total_steps:
            t0 = time.perf_counter()  # includes data fetch: host-side delays
            batch = self.data_fn(step)  # count toward straggler detection
            params, opt_state, ef, metrics = self._step(params, opt_state,
                                                        ef, batch)
            _block(metrics["loss"])
            dt = time.perf_counter() - t0
            step += 1
            self._track_time(step, dt)
            if step % t.log_every == 0 or step == t.total_steps:
                self.metrics_log.append(
                    {"step": step, "loss": float(metrics["loss"]),
                     "grad_norm": float(metrics["grad_norm"]), "dt": dt})
            if step % t.ckpt_every == 0 or step == t.total_steps:
                self.ckpt.save(step, {"params": params, "opt": opt_state,
                                      "ef": ef})
            if crash_at is not None and step >= crash_at:
                self.ckpt.wait()
                raise RuntimeError(f"injected crash at step {step}")
        self.ckpt.wait()
        return {"params": params, "opt_state": opt_state, "ef": ef,
                "final_step": step, "metrics": self.metrics_log,
                "straggler_events": self.straggler_events}

    # ------------------------------------------------------------ straggler --
    def _track_time(self, step: int, dt: float):
        if len(self.step_times) >= 4:
            med = statistics.median(self.step_times)
            if dt > self.tcfg.straggler_factor * med:
                self.straggler_events += 1
                if self.on_straggler:
                    self.on_straggler(step, dt / med)
        self.step_times.append(dt)


def synthetic_data(cfg, batch: int, seq: int, seed: int = 0,
                   device: DeviceLike = None):
    """Step-indexed synthetic batches: ``data_fn(step)`` is a pure function
    of (seed, step) -- the reference's numpy stream, bit for bit -- as
    tensors on ``device`` (``None`` means ``cuda``)."""
    dev = resolve_device(device)

    def data_fn(step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((seed, step))
        tok = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)
        out = {"labels": torch.from_numpy(np.roll(tok, -1, axis=1)).to(dev)}
        if cfg.external_embed:
            out["embeds"] = torch.from_numpy(
                rng.normal(size=(batch, seq, cfg.d_model)).astype(np.float32)
            ).to(dev)
        else:
            out["tokens"] = torch.from_numpy(tok).to(dev)
        if cfg.cross_attn_period:
            out["vision_states"] = torch.from_numpy(
                rng.normal(size=(batch, cfg.n_vision_tokens, cfg.d_model)
                           ).astype(np.float32)).to(dev)
        return out
    return data_fn
