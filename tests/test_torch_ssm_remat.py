"""The SSM scans' chunked rematerialization in the port
(``repro_torch.models.ssm``: ``REMAT_CHUNK`` steps a chunk under
``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` around its
inner scan), on the CPU.

What is held:
* RWKV6's time mix and Mamba, each a layer alone on random leaves, at
  sequences of 128 and 192 steps (chunked) and 100 (not a multiple of
  64: the loop runs whole either way): the output and the gradients of x
  and of every leaf bit-identical with and without the chunking;
* the same through a whole model under its per-repeat remat, where the
  chunks nest inside the repeat's ``checkpoint``: rwkv6-3b's and jamba's
  smoke at 128 tokens, loss and every gradient leaf bit-identical;
* the states a backward keeps, by count (a ``saved_tensors_hooks`` pack
  hook over the forward): without the chunking the loop saves at least
  one state-shaped tensor a step; with it, at most one a chunk (the
  chunks' own saves are the checkpoint's, recomputed in the backward).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import (ModelConfig, SSMConfig,  # noqa: E402
                                      smoke_config)
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import tree_init, tree_leaves  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402

torch.set_num_threads(1)

SEQS = (128, 192, 100)
MAMBA = ModelConfig(name="t", family="hybrid", n_layers=1, d_model=24,
                    n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
                    compute_dtype="float32",
                    ssm=SSMConfig(kind="mamba", d_state=8, expand=2,
                                  dt_rank=4, conv_width=4, attn_period=8,
                                  attn_offset=4))
RWKV = ModelConfig(name="t", family="ssm", n_layers=1, d_model=128,
                   n_heads=2, n_kv_heads=2, d_ff=256, vocab_size=64,
                   compute_dtype="float32", ssm=SSMConfig(kind="rwkv6"))
LAYERS = {
    "rwkv6": (RWKV, SSM.rwkv_time_mix_abstract,
              lambda p, x: SSM.rwkv_time_mix_apply(p, x, RWKV)),
    "mamba": (MAMBA, SSM.mamba_abstract,
              lambda p, x: SSM.mamba_apply(p, x, MAMBA)),
}


def _state_shape(kind, b):
    if kind == "rwkv6":
        h = RWKV.d_model // SSM.RWKV_HEAD_DIM
        return (b, h, SSM.RWKV_HEAD_DIM, SSM.RWKV_HEAD_DIM)
    return (b, MAMBA.ssm.expand * MAMBA.d_model, MAMBA.ssm.d_state)


def _layer_run(kind, s, chunk, monkeypatch, seed=0):
    """The layer's output and its gradients (x first, then every leaf) of
    ``sum(out * cot)`` at ``s`` steps with ``REMAT_CHUNK = chunk``, and the
    number of state-shaped tensors the forward saved for the backward."""
    cfg, abstract, apply = LAYERS[kind]
    monkeypatch.setattr(SSM, "REMAT_CHUNK", chunk)
    gen = torch.Generator().manual_seed(seed)
    params = tree_init(abstract(cfg), gen, "float32", "cpu")
    # the zero- and one-initialized leaves drawn too, so that every leaf
    # has a gradient of its own
    params = {k: v + 0.1 * torch.randn(v.shape, generator=gen)
              for k, v in params.items()}
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(2, s, cfg.d_model))
                         .astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(2, s, cfg.d_model))
                           .astype(np.float32))
    state = _state_shape(kind, 2)
    saved = []

    def pack(t):
        if tuple(t.shape) == state:
            saved.append(t)
        return t
    out = []

    def loss(tree):
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y = apply(tree["p"], tree["x"])[0]
        out.append(y.detach())
        return torch.sum(y * cot)
    _, g = value_and_grad(loss, {"p": params, "x": x})
    return out[0], [g["x"]] + tree_leaves(g["p"]), len(saved)


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_chunked_scan_gradients_bit_identical(kind, s, monkeypatch):
    y0, g0, _ = _layer_run(kind, s, 0, monkeypatch)
    y1, g1, _ = _layer_run(kind, s, 64, monkeypatch)
    assert torch.equal(y0, y1)
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
        assert bool((b != 0).any())


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_chunked_scan_keeps_a_state_a_chunk(kind, s, monkeypatch):
    """Without chunks the loop saves at least ``s`` states; with them at
    most ``s / 64`` (the chunks' boundaries, kept as the checkpoints'
    inputs), where the length is a multiple of 64 longer than one."""
    whole = _layer_run(kind, s, 0, monkeypatch)[2]
    chunked = _layer_run(kind, s, 64, monkeypatch)[2]
    assert whole >= s
    if s % 64 == 0 and s > 64:
        assert chunked <= s // 64
    else:
        assert chunked == whole


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_chunks_nest_inside_the_repeat_remat(arch, monkeypatch):
    """A smoke model's loss and gradients at 2 x 128 tokens, remat on (each
    repeat under ``checkpoint``), with and without the scans' chunks:
    bit for bit."""
    cfg = dataclasses.replace(smoke_config(arch), remat=True)
    model = Model(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 128))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    runs = []
    for chunk in (0, 64):
        monkeypatch.setattr(SSM, "REMAT_CHUNK", chunk)
        loss, g = value_and_grad(lambda p: model.loss(p, batch),
                                 model.params)
        runs.append((loss, tree_leaves(g)))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
