"""The port's RWKV6 and Jamba (Mamba + attention + MoE) models at their
``SMOKE`` sizes vs the JAX reference, on the CPU: forward, loss, prefill
logits and caches, a decode step, and the greedy driver's tokens.
Tolerances: ``tests/_torch_model_oracle.py``."""
import pytest

torch = pytest.importorskip("torch")

import _torch_model_oracle as oracle  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["rwkv6-3b", "jamba-v0.1-52b"])
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
