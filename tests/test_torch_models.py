"""The port's LLM serving path vs the JAX reference, on the CPU: the dense,
sliding-window, parallel-block, cross-attention (vision) and encoder-only
(audio) models at their ``SMOKE`` sizes -- forward, loss, prefill logits
and caches, a decode step, the greedy driver's tokens -- and, on qwen2's
smoke config, bfloat16 compute, the int8 KV cache, the held compute-dtype
copy, checkpoints moving between the packages, the CLI and device rules.

Tolerances: ``tests/_torch_model_oracle.py`` for float32 compute;
bfloat16 compute over two layers ``1e-1 x max|logit|`` (measured 0.9e-2 to
4.4e-2 over three prompt seeds, at the forward, prefill and decode step):
every bfloat16 op matches XLA's bit for bit (the sigmoid spelled as XLA
expands it), but XLA's float32 ``exp``, ``sin`` and ``tanh`` differ from
torch's by an ulp, which flips bfloat16 roundings that each layer carries
on; one block alone stays within a bfloat16 step (``test_torch_layers``).
The int8 cache's codes within one step of the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.ckpt import manager as jck  # noqa: E402
from repro.configs.base import smoke_config as jsmoke  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
import _torch_model_oracle as oracle  # noqa: E402
from repro_torch.ckpt import manager as ck  # noqa: E402
from repro_torch.configs.base import list_archs, smoke_config  # noqa: E402
from repro_torch.launch import driver, serve  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_reference  # noqa: E402

torch.set_num_threads(1)

DENSE = ["deepseek-67b", "h2o-danube-3-4b", "command-r-plus-104b",
         "qwen2-7b", "llama-3.2-vision-90b"]


@pytest.fixture(scope="module", params=DENSE)
def arch_ref(request):
    return request.param, oracle.reference_outputs(request.param)


def test_forward_and_loss_match_the_reference(arch_ref):
    oracle.check_forward_and_loss(*arch_ref)


def test_prefill_logits_and_caches_match_the_reference(arch_ref):
    oracle.check_prefill_and_caches(*arch_ref)


def test_decode_step_matches_the_reference_and_forward(arch_ref):
    oracle.check_decode_step(*arch_ref)


def test_greedy_tokens_equal_the_reference_driver(arch_ref):
    oracle.check_greedy_tokens(*arch_ref)


def test_encoder_only_forward_and_loss_match_and_serving_refuses():
    ref = oracle.reference_outputs("hubert-xlarge")
    oracle.check_forward_and_loss("hubert-xlarge", ref)
    m = oracle.port_model("hubert-xlarge", ref)
    with pytest.raises(ValueError, match="encoder-only"):
        driver.greedy_decode(m, None, torch.zeros(1, 4, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="encoder-only"):
        driver.serve_greedy(m.cfg, 1, 4, 2, device="cpu")
    with pytest.raises(SystemExit):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])


# ------------------------------------------------ one config, many options --

def _qwen(**kw):
    jc = dataclasses.replace(jsmoke("qwen2-7b"), **kw)
    jm = JModel(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(dataclasses.replace(smoke_config("qwen2-7b"), **kw),
              params_from_reference(jax.tree.map(np.asarray, jp), "cpu"),
              device="cpu")
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 20)
                                             ).astype(np.int32)
    return jm, jp, m, toks


def test_bfloat16_compute_matches_the_reference():
    jm, jp, m, toks = _qwen(compute_dtype="bfloat16")
    want = np.asarray(jm.forward(jp, tokens=jnp.asarray(toks)))
    got = m.forward(None, tokens=torch.from_numpy(toks))
    assert got.dtype == torch.float32
    oracle.close(want, got, 1e-1)
    assert (want.argmax(-1) == got.argmax(-1).numpy()).mean() >= 0.9
    lj, cj = jm.prefill(jp, tokens=jnp.asarray(toks[:, :-1]), max_len=24)
    lt, ct = m.prefill(None, tokens=torch.from_numpy(toks[:, :-1]),
                       max_len=24)
    assert ct["dense"]["sub0_attn"]["k"].dtype == torch.bfloat16
    oracle.close(lj, lt, 1e-1)
    dj, _ = jm.decode_step(jp, cj, jnp.int32(19), jnp.asarray(toks[:, -1:]))
    dt, _ = m.decode_step(None, ct, 19, torch.from_numpy(toks[:, -1:]))
    oracle.close(dj, dt, 1e-1)
    # decode reproduces the forward's last position exactly, as the
    # reference's does
    assert torch.equal(dt[:, 0], got[:, -1])


@pytest.mark.parametrize("arch", list_archs())
def test_held_compute_copy_gives_the_bits_of_casting_each_call(arch):
    """``compute_params`` casts every leaf read through ``.to(cdt)`` once;
    bfloat16 compute over float32 parameters then gives the logits of
    casting on every call, bit for bit."""
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="bfloat16")
    m = Model(cfg, device="cpu", seed=3)
    held = m.compute_params()
    kw = {}
    if cfg.external_embed:
        kw["embeds"] = torch.randn(2, 9, cfg.d_model,
                                   generator=torch.Generator().manual_seed(0))
    else:
        kw["tokens"] = torch.randint(0, cfg.vocab_size, (2, 9),
                                     generator=torch.Generator().manual_seed(0))
    if cfg.cross_attn_period:
        kw["vision_states"] = torch.randn(2, cfg.n_vision_tokens, cfg.d_model)
    assert torch.equal(m.forward(None, **kw), m.forward(held, **kw))
    dtypes = {v.dtype for _, v in oracle.leaves_with_paths(held)}
    assert torch.bfloat16 in dtypes


def test_int8_kv_cache_matches_the_reference():
    """The exponent-aligned int8 cache: prefill codes within one step and
    bfloat16 scales within one bfloat16 ulp of the reference's, and the
    decode step's logits within the float32 tolerance."""
    jm, jp, m, toks = _qwen(kv_cache_int8_scale=8.0)
    lj, cj = jm.prefill(jp, tokens=jnp.asarray(toks[:, :-1]), max_len=24)
    lt, ct = m.prefill(None, tokens=torch.from_numpy(toks[:, :-1]),
                       max_len=24)
    oracle.close(lj, lt, 1e-4)
    got = dict(oracle.leaves_with_paths(ct))
    for path, want in oracle.leaves_with_paths(cj):
        have = got[path]
        assert str(have.dtype).split(".")[-1] == str(want.dtype), path
        oracle.close(want, have, 1 / 127 if path[-1] in "kv" else 2 ** -7,
                     path)
    dj, _ = jm.decode_step(jp, cj, jnp.int32(19), jnp.asarray(toks[:, -1:]))
    dt, _ = m.decode_step(None, ct, 19, torch.from_numpy(toks[:, -1:]))
    oracle.close(dj, dt, 1e-4)


# ------------------------------------------------------------- interop --

def test_reference_checkpoint_serves_the_reference_logits(tmp_path):
    """A ``{"params": ...}`` tree saved by ``repro.ckpt.manager`` loads
    through ``repro_torch.ckpt.manager`` into the port's ``Model`` with the
    reference's bits and gives its logits; the port's own save loads back
    in the reference and gives the port's logits."""
    jm, jp, m, toks = _qwen()
    jck.save(tmp_path / "ref", 1, {"params": jp})
    tree, _ = ck.load(tmp_path / "ref", 1, {"params": m.params},
                      device="cpu")
    mine = Model(m.cfg, tree["params"], device="cpu")
    for key, want in m.state_dict().items():
        assert torch.equal(mine.state_dict()[key], want), key
    want = np.asarray(jm.forward(jp, tokens=jnp.asarray(toks)))
    got = mine.forward(None, tokens=torch.from_numpy(toks))
    oracle.close(want, got, 1e-4)

    other = Model(m.cfg, device="cpu", seed=5)
    ck.save(tmp_path / "port", 2, {"params": other.params}, device="cpu")
    back, _ = jck.load(tmp_path / "port", 2, {"params": jp})
    ref_logits = np.asarray(jm.forward(back["params"],
                                       tokens=jnp.asarray(toks)))
    oracle.close(ref_logits, other.forward(None,
                                           tokens=torch.from_numpy(toks)),
                 1e-4)
    names = {".".join(p) for p, _ in oracle.leaves_with_paths(m.params)}
    assert names == set(m.state_dict())
    assert "blocks.dense.sub0_attn.attn.wq" in names


# ------------------------------------------------------- devices and CLI --

def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    cfg = smoke_config("qwen2-7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.serve_greedy(cfg, 1, 4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.build_inputs(cfg, 1, 4)


def test_serve_cli_and_serve_greedy_on_the_cpu(capsys):
    serve.main(["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "5", "--new-tokens", "3",
                "--kv-int8"])
    out = capsys.readouterr().out
    assert "qwen2-smoke" in out and "ms/token on cpu" in out
    cfg = smoke_config("llama-3.2-vision-90b")
    a = driver.serve_greedy(cfg, 2, 5, 3, device="cpu")
    b = driver.serve_greedy(cfg, 2, 5, 3, device="cpu")
    assert a.tokens.shape == (2, 3) and torch.equal(a.tokens, b.tokens)
    assert a.ms_per_token > 0 and a.prefill_s > 0
