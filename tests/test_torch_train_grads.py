"""The loss's gradient in the port (``train.step.value_and_grad`` through
``Model.loss``) against ``jax.value_and_grad`` of the reference's loss, for
every architecture at its ``SMOKE`` size, on the CPU, from the reference's
parameters (``Model.init(PRNGKey(0))``) and numpy inputs made from a seed.

Tolerances (float32 compute): the loss within 1e-5 relative (jamba 1e-5
too: 2.3e-6 measured); each gradient leaf within ``2e-3 x`` its largest
reference value (measured up to 8.0e-4, at llama-vision's norm weights:
XLA's float32 ``exp`` and ``tanh`` differ from torch's by an ulp, and a
norm weight's gradient sums a whole batch of products); jamba's within
``5e-2`` (1.8e-2 measured at ``dt_bias``, 1.7e-2 at ``a_log``: its smoke
Mamba state reaches 1e7, as in ``tests/_torch_model_oracle.py``, and the
gradient of the step size runs through every step's ``exp(dt * A)``).
Where ``exp(-x)`` overflows, autograd through the sigmoid as XLA expands
it would give NaN; ``models/layers.py`` gives it JAX's rule.  With ``remat`` on and off the
port's gradients are bit-identical, but for jamba, whose recomputed scans
add the gradients of leaves read at every step in another order (within
1e-6 of each leaf's largest).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs.base import smoke_config as jsmoke  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
import _torch_model_oracle as oracle  # noqa: E402
from repro_torch.configs.base import list_archs, smoke_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (params_from_reference,  # noqa: E402
                                       tree_leaves)
from repro_torch.train.step import value_and_grad  # noqa: E402

torch.set_num_threads(1)

B, S = 2, 24
TOL = {"jamba-v0.1-52b": 5e-2}


def _batch(cfg):
    rng = np.random.default_rng(1)
    out = {}
    if cfg.external_embed:
        out["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)
                                     ).astype(np.int32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.cross_attn_period:
        out["vision_states"] = rng.normal(
            size=(B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def _port(arch, params, remat=None):
    cfg = smoke_config(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    return Model(cfg, params_from_reference(params, "cpu"), device="cpu")


def _grads(model, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return value_and_grad(lambda p: model.loss(p, tb), model.params)


@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_grads_match_jax_value_and_grad(arch):
    cfg = jsmoke(arch)
    assert cfg.remat             # the smoke configs train with remat
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _grads(_port(arch, jax.tree.map(np.asarray, jp)), batch)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    want = oracle.leaves_with_paths(jax.tree.map(np.asarray, jg))
    got = tree_leaves(grads)
    assert len(want) == len(got)
    tol = TOL.get(arch, 2e-3)
    for (path, w), g in zip(want, got):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, path
        oracle.close(w, g, tol, path)


@pytest.mark.parametrize("arch", list_archs())
def test_remat_on_and_off_give_the_same_grads(arch):
    jp = JModel(jsmoke(arch)).init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jp)
    batch = _batch(jsmoke(arch))
    on = _grads(_port(arch, params, remat=True), batch)
    off = _grads(_port(arch, params, remat=False), batch)
    assert torch.equal(on[0], off[0])
    for a, b in zip(tree_leaves(on[1]), tree_leaves(off[1])):
        if arch == "jamba-v0.1-52b":
            assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max())
        else:
            assert torch.equal(a, b)
