"""The port's QoI-controlled retrieval (Algorithm 3) vs the JAX reference,
on the CPU.

Inputs are made with numpy from a seed; the port runs with ``device="cpu"``.
Tolerance: none.  Every compared quantity is exactly equal -- iterations,
bytes, ``converged``, ``degraded_groups``, ``per_iteration``, ``eps_final``,
``tau_estimated`` -- and the values are bit-identical.  The reference's XLA
CPU arithmetic flushes float32 subnormals (inputs and results); the port
flushes explicitly, so the cases below that produce subnormals (the
``tau = 5e-324`` CP cap, subnormal inputs to the pointwise bounds) are exact
too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import qoi as jqq  # noqa: E402
from repro.core import refactor as jrf  # noqa: E402
from repro.core import retrieve as jrt  # noqa: E402
from repro.data.fields import velocity_field  # noqa: E402
from repro.store import reliability as jrl  # noqa: E402
from repro_torch.core import qoi as qq  # noqa: E402
from repro_torch.core import refactor as rf  # noqa: E402
from repro_torch.core import retrieve as rt  # noqa: E402
from repro_torch.data.fields import gaussian_field  # noqa: E402
from repro_torch.store import reliability as rl  # noqa: E402

torch.set_num_threads(1)

DESIGNS = ["register_block", "locality", "shuffle"]
METHODS = {"cp": {}, "ma": {}, "mape": {"c": 10.0}}
KINDS = ["sum_squares", "magnitude", "linear", "product"]


def _bits(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def _same(a, b) -> None:
    """Port result ``a`` equals reference result ``b`` exactly."""
    assert a.iterations == b.iterations
    assert a.bytes_fetched == b.bytes_fetched
    assert a.bitrate == b.bitrate
    assert a.converged == b.converged
    assert a.degraded_groups == b.degraded_groups
    assert a.per_iteration == b.per_iteration
    assert a.eps_final == b.eps_final
    assert a.tau_estimated == b.tau_estimated
    assert a.tau_requested == b.tau_requested
    assert len(a.values) == len(b.values)
    for va, vb in zip(a.values, b.values):
        assert va.dtype == vb.dtype == np.float32
        assert _bits(va) == _bits(vb)


def _pair(vs, design, **kw):
    """Readers over the same data in both packages (wire blobs equal)."""
    jrefs = [jrf.refactor_array(v, f"v{i}", design=design)
             for i, v in enumerate(vs)]
    trefs = [rf.refactor_array(v, f"v{i}", design=design, device="cpu")
             for i, v in enumerate(vs)]
    for a, b in zip(trefs, jrefs):
        assert rf.refactored_to_bytes(a) == jrf.refactored_to_bytes(b)
    return trefs, jrefs


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("method", list(METHODS))
def test_qoi_retrieve_matches_reference(method, design):
    """Fresh readers per method; tau tightens 1e-2 -> 1e-4 on the same
    readers, as examples/qoi_retrieval.py does."""
    vs = list(velocity_field((12, 14, 16), seed=3))
    trefs, jrefs = _pair(vs, design)
    tr = [rt.ProgressiveReader(r, device="cpu") for r in trefs]
    jr = [jrt.ProgressiveReader(r) for r in jrefs]
    truth = sum(v.astype(np.float64) ** 2 for v in vs)
    for tau in (1e-2, 1e-4):
        a = qq.progressive_qoi_retrieve(tr, qq.V_TOTAL, tau, method=method,
                                        **METHODS[method])
        b = jqq.progressive_qoi_retrieve(jr, jqq.V_TOTAL, tau, method=method,
                                         **METHODS[method])
        _same(a, b)
        actual = np.abs(sum(v.astype(np.float64) ** 2 for v in a.values)
                        - truth).max()
        assert a.converged and actual <= a.tau_estimated <= tau


@pytest.mark.parametrize("method", list(METHODS))
def test_qoi_degraded_matches_reference(method):
    """Unreachable plane groups under ``degrade=True``: the same groups are
    dropped and Algorithm 3 stops at the same (raised) floor."""
    vs = list(velocity_field((10, 12, 14), seed=5))
    trefs, jrefs = _pair(vs, "register_block")
    fail = [(1, 1), (0, 3)]
    tr = [rt.ProgressiveReader(r, device="cpu", degrade=True,
                               source=_FailingSource(r, fail,
                                                     rl.UnreachableSegmentError))
          for r in trefs]
    jr = [jrt.ProgressiveReader(r, degrade=True,
                                source=_FailingSource(r, fail,
                                                      jrl.UnreachableSegmentError))
          for r in jrefs]
    a = qq.progressive_qoi_retrieve(tr, qq.V_TOTAL, 1e-7, method=method,
                                    **METHODS[method])
    b = jqq.progressive_qoi_retrieve(jr, jqq.V_TOTAL, 1e-7, method=method,
                                     **METHODS[method])
    _same(a, b)
    assert a.degraded_groups > 0 and not a.converged


class _FailingSource:
    """Serves the inline segments but fails on a set of (piece, group)."""

    def __init__(self, ref, fail, exc):
        self._ref, self._fail, self._exc = ref, set(fail), exc

    def sign(self, piece):
        if (piece, -1) in self._fail:
            raise self._exc("sign unreachable")
        return self._ref.pieces[piece].sign_seg

    def group(self, piece, group):
        if (piece, group) in self._fail:
            raise self._exc("group unreachable")
        return self._ref.pieces[piece].groups[group]

    def prefetch(self, wants):
        pass


def test_cp_halving_cap_matches_reference():
    """tests/test_reconstruct.py's pathological ``tau = 5e-324`` CP case:
    the halving loop runs into eps*eps terms far below float32's normal
    range, where the flush decides the estimate."""
    x = np.full((1,), 0.5, np.float32)
    a = qq.progressive_qoi_retrieve(
        [rt.ProgressiveReader(rf.refactor_array(x, "s", device="cpu"),
                              device="cpu")],
        qq.QoI("sum_squares"), 5e-324, method="cp", max_iters=5)
    b = jqq.progressive_qoi_retrieve(
        [jrt.ProgressiveReader(jrf.refactor_array(x, "s"))],
        jqq.QoI("sum_squares"), 5e-324, method="cp", max_iters=5)
    _same(a, b)
    assert a.iterations <= 5


def test_mixed_size_fleet_matches_reference():
    """tests/test_reconstruct.py's mixed-size fleet: a field and a
    broadcastable scalar; the bitrate sums both element counts, and CP
    indexes the broadcast field."""
    a_np = gaussian_field((4096,), seed=1)
    b_np = np.full((1,), 0.75, np.float32)
    for method in METHODS:
        port = qq.progressive_qoi_retrieve(
            [rt.ProgressiveReader(rf.refactor_array(v, n, device="cpu"),
                                  device="cpu")
             for v, n in [(a_np, "a"), (b_np, "b")]],
            qq.V_TOTAL, 1e-1, method=method)
        ref = jqq.progressive_qoi_retrieve(
            [jrt.ProgressiveReader(jrf.refactor_array(v, n))
             for v, n in [(a_np, "a"), (b_np, "b")]],
            jqq.V_TOTAL, 1e-1, method=method)
        _same(port, ref)
        assert port.bytes_fetched > 0
        assert port.bitrate == 8.0 * port.bytes_fetched / (a_np.size + 1)


def test_floor_terminates_like_the_reference():
    """Empty detail pieces: an unreachable tau stops at the floor."""
    x = np.full((1,), 0.5, np.float32)
    a = qq.progressive_qoi_retrieve(
        [rt.ProgressiveReader(rf.refactor_array(x, "s", device="cpu"),
                              device="cpu")],
        qq.QoI("sum_squares"), 1e-30, method="ma")
    b = jqq.progressive_qoi_retrieve(
        [jrt.ProgressiveReader(jrf.refactor_array(x, "s"))],
        jqq.QoI("sum_squares"), 1e-30, method="ma")
    _same(a, b)
    assert not a.converged and a.iterations < 20


def _pointwise_inputs(seed: int):
    rng = np.random.default_rng(seed)
    vs = [rng.normal(size=500).astype(np.float32) for _ in range(3)]
    # zeros, subnormals, tiny normals and large values: where flush-to-zero
    # and the eps*eps terms decide the result
    for v in vs:
        v[:6] = np.array([0.0, 1e-40, -3e-39, 1.2e-38, 1e-20, 3e18],
                         np.float32)
    return vs


@pytest.mark.parametrize("eps", [(1e-3, 2e-3, 5e-4), (1e-20, 3e-21, 1e-19),
                                 (1e-40, 0.0, 2e-3), (0.1, 1e-30, 4.0)])
@pytest.mark.parametrize("kind", KINDS)
def test_pointwise_error_and_value_match_reference(kind, eps):
    vs = _pointwise_inputs(4)
    q = qq.QoI(kind, coeffs=(1.0, -2.0, 0.5) if kind == "linear" else None)
    jq = jqq.QoI(kind, coeffs=q.coeffs)
    n = 2 if kind == "product" else 3
    got = qq.qoi_error_pointwise(vs[:n], list(eps[:n]), q, device="cpu")
    want = np.asarray(jqq.qoi_error_pointwise(
        [jnp.asarray(v) for v in vs[:n]], list(eps[:n]), jq))
    assert got.dtype == torch.float32
    assert _bits(got.numpy()) == _bits(want)
    got_v = qq.qoi_value(vs[:n], q, device="cpu")
    want_v = np.asarray(jqq.qoi_value(vs[:n], jq))
    assert _bits(got_v.numpy()) == _bits(want_v)


def test_argmax_is_the_first_maximum():
    x = torch.tensor([0.0, 3.0, 1.0, 3.0, 3.0])
    v, i = qq._max_and_argmax(x.reshape(5, 1))
    jv, ji = jqq._max_and_argmax(jnp.asarray(x.numpy()))
    assert (float(v), int(i)) == (float(jv), int(ji)) == (3.0, 1)
