"""Progressive retrieval with guaranteed QoI error control (paper §6.2, Alg 3).

A port of ``repro.core.qoi``.

QoI families (pointwise, per [39]):
  * ``sum_squares``  f = sum_i v_i^2        (the paper's V_total)
  * ``magnitude``    f = sqrt(sum_i v_i^2)
  * ``linear``       f = sum_i a_i v_i
  * ``product``      f = v_0 * v_1

Error estimates are conservative given per-variable max-norm bounds eps_i:
  |x^2 - xh^2|           <= eps*(2|xh| + eps)
  |sqrt(g) - sqrt(gh)|   <= min(sqrt(dg), dg/(sqrt(max(gh-dg,0)) + sqrt(gh)))
  |sum a_i v_i - ^|      <= sum |a_i| eps_i
  |xy - xh yh|           <= |xh| eps_y + |yh| eps_x + eps_x eps_y

Three next-error-bound estimators (paper §6.2): CP (decay + single-point
re-evaluation on stale data), MA (fetch one more merged plane group per
variable), MAPE (proportional jump eps/p with p = tau'/tau, switching to MA
when p <= c).

Bit-identity with the reference: the fields are float32, every host scalar
(``eps_i``, coefficients) is rounded once to a float32 tensor, as the
reference's ``jnp.float32`` and weak-typed scalars are, and the reference's
XLA CPU arithmetic treats subnormal inputs as zero and flushes subnormal
results, so the port flushes its inputs and every product, quotient and
difference (``align.flush_subnormal``; a sum of non-negative normal numbers
cannot be subnormal).  Square roots are taken correctly rounded
(``_sqrt``).  ``argmax`` returns the first maximal index, as
``jnp.argmax`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import lossless_batch as lb
from repro_torch.core.align import flush_subnormal as _ftz
from repro_torch.core.retrieve import ProgressiveReader
from repro_torch.device import DeviceLike, as_float32


@dataclasses.dataclass(frozen=True)
class QoI:
    kind: str
    coeffs: Optional[Tuple[float, ...]] = None  # for 'linear'


V_TOTAL = QoI("sum_squares")


def _f32(x: float, device: torch.device) -> torch.Tensor:
    """A host scalar as a 0-d float32 tensor (rounded once, flushed)."""
    return _ftz(torch.tensor(float(x), dtype=torch.float32, device=device))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt on every device, as XLA's.  CUDA's
    float32 sqrt is; torch's CPU one is not, so on the CPU the root is taken
    in float64 and rounded once to float32 (which is correctly rounded)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _fields(vs, device: DeviceLike) -> List[torch.Tensor]:
    return [_ftz(as_float32(v, device)) for v in vs]


def _sum(terms):
    """Python's left-to-right ``sum`` of the reference."""
    it = iter(terms)
    acc = next(it)
    for t in it:
        acc = acc + t
    return acc


def qoi_value(vs, q: QoI, *, device: DeviceLike = None) -> torch.Tensor:
    vs = _fields(vs, device)
    if q.kind == "sum_squares":
        return _sum(_ftz(v * v) for v in vs)
    if q.kind == "magnitude":
        return _sqrt(_sum(_ftz(v * v) for v in vs))
    if q.kind == "linear":
        # mixed signs: each partial sum may be subnormal
        acc = None
        for a, v in zip(q.coeffs, vs):
            t = _ftz(_f32(a, v.device) * v)
            acc = t if acc is None else _ftz(acc + t)
        return acc
    if q.kind == "product":
        return _ftz(vs[0] * vs[1])
    raise ValueError(q.kind)


def qoi_error_pointwise(v_hats, eps: Sequence[float], q: QoI, *,
                        device: DeviceLike = None) -> torch.Tensor:
    """Pointwise conservative bound |f(v) - f(v_hat)| given
    |v_i - v_hat_i| <= eps_i."""
    vh = _fields(v_hats, device)
    dev = vh[0].device
    e = [_f32(x, dev) for x in eps]
    if q.kind in ("sum_squares", "magnitude"):
        dg = _sum(_ftz(ei * (2.0 * v.abs() + ei)) for v, ei in zip(vh, e))
        if q.kind == "sum_squares":
            return dg
        gh = _sum(_ftz(v * v) for v in vh)
        lo = _sqrt(torch.clamp_min(_ftz(gh - dg), 0.0))
        denom = lo + _sqrt(gh)
        ratio = torch.where(denom > 0,
                            _ftz(dg / torch.clamp_min(denom, 1e-30)),
                            torch.full_like(denom, float("inf")))
        return torch.minimum(_sqrt(dg), ratio)
    if q.kind == "linear":
        total = _sum(_ftz(_f32(abs(float(a)), dev) * ei)
                     for a, ei in zip(q.coeffs, e))
        return total * torch.ones_like(vh[0])
    if q.kind == "product":
        x, y = vh
        ex, ey = e
        return _ftz(x.abs() * ey) + _ftz(y.abs() * ex) + _ftz(ex * ey)
    raise ValueError(q.kind)


def _max_and_argmax(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max, first index of the max) of the flattened field, on its device."""
    flat = x.reshape(-1)
    i = torch.argmax(flat)
    return flat[i], i


# ----------------------------------------------------------- Algorithm 3 ----

@dataclasses.dataclass
class QoIRetrievalResult:
    values: List[np.ndarray]         # reconstructed variables
    tau_estimated: float             # final max estimated QoI error (tau')
    tau_requested: float
    iterations: int
    bytes_fetched: int
    bitrate: float                   # bits per element, summed over variables
    eps_final: List[float]
    converged: bool
    # plane groups the readers dropped under the degrade policy during THIS
    # call.  converged=False together with degraded_groups > 0 means tau was
    # unattainable because of unreachable data, not because the stored
    # precision ran out.
    degraded_groups: int = 0
    # per Algorithm-3 iteration: bytes fetched, delta plane bytes actually
    # decoded (incremental engine), and the full-decode baseline
    per_iteration: List[Dict[str, int]] = dataclasses.field(
        default_factory=list)


# Cap for the CP estimator's halving loop: pathological tau values (e.g.
# denormal-small relative to the achieved bounds) would otherwise spin
# through hundreds of subnormal halvings before the estimate moves.  64
# halvings take eps below 2^-64 of its start — past any float32 data scale.
CP_MAX_HALVINGS = 64


def _point_estimate(vh_at_p: np.ndarray, eps: np.ndarray, q: QoI) -> float:
    """Scalar QoI error estimate at one point (CP's stale re-evaluation),
    on the host: a handful of float32 scalar ops.  ``device="cpu"`` is
    deliberate, not a fallback: the values already crossed to the host in
    the counted ``qoi.cp_point`` sync, and a card launch per op would cost
    more than the ops."""
    return float(qoi_error_pointwise(
        [np.float32(v) for v in vh_at_p], list(eps), q, device="cpu"))


def _qoi_scale(amaxs: np.ndarray, q: QoI) -> float:
    """Maximal value of the QoI itself (the paper's init denominator)."""
    if q.kind in ("sum_squares",):
        return float(np.sum(amaxs ** 2))
    if q.kind == "magnitude":
        return float(np.sqrt(np.sum(amaxs ** 2)))
    if q.kind == "linear":
        return float(np.sum(np.abs(q.coeffs) * amaxs))
    if q.kind == "product":
        return float(np.prod(amaxs[:2]))
    raise ValueError(q.kind)


def progressive_qoi_retrieve(
    readers: Sequence[ProgressiveReader],
    q: QoI,
    tau: float,
    method: str = "mape",
    c: float = 10.0,
    max_iters: int = 100,
) -> QoIRetrievalResult:
    """Algorithm 3: iterate (fetch -> recompose -> estimate) until tau' <= tau.

    The loop is device-resident end to end: reconstructions stay on the
    readers' device (``retrieve_device``/``reconstruct_device`` reuse each
    reader's incremental state), the QoI error field and its max/argmax are
    evaluated there, and only the tau' scalar (plus, for CP, the values at
    the argmax point) crosses to the host per iteration, each through one
    counted ``lossless_batch.host_sync`` — full arrays are copied to the
    host exactly once, at return."""
    n_v = len(readers)
    ranges = np.array([r.ref.data_range for r in readers])
    amaxs = np.array([r.ref.data_amax for r in readers])

    # initial data error bounds: relative value of tau over the QoI's maximal
    # value, multiplied with the value range of the data (paper §6.2).
    tau_scale = _qoi_scale(amaxs, q)
    rel = min(tau / max(tau_scale, 1e-30), 1.0)
    eps_req = np.maximum(rel * ranges, 1e-30)

    tau_p = np.inf
    bytes0 = sum(r.total_bytes_fetched for r in readers)
    deg0 = sum(getattr(r, "degraded_count", 0) for r in readers)
    vals: List[Optional[torch.Tensor]] = [None] * n_v
    eps_ach = np.zeros(n_v)
    it = 0
    converged = False
    per_iter: List[Dict[str, int]] = []
    bytes_prev = bytes0  # end-of-iteration fetches count toward the iteration
    while it < max_iters:  # that decodes them (MA/MAPE fetch between rounds)
        it += 1
        # per-reader engine counters, not the global STATS: concurrent
        # readers decoding elsewhere must not pollute this call's metrics
        dec0 = sum(r.delta_decoded_bytes() for r in readers)
        # fetch + recompose each variable toward its current data error bound
        for i, r in enumerate(readers):
            if method == "ma" and it > 1:
                r.fetch_one_more_group()
                vals[i], eps_ach[i] = r.reconstruct_device()
            else:
                vals[i], eps_ach[i], _ = r.retrieve_device(float(eps_req[i]))
        bytes_now = sum(r.total_bytes_fetched for r in readers)
        per_iter.append({
            "iteration": it,
            "bytes_fetched": bytes_now - bytes_prev,
            "delta_plane_bytes": sum(r.delta_decoded_bytes()
                                     for r in readers) - dec0,
            "full_plane_bytes": sum(r.decoded_plane_bytes() for r in readers),
        })
        bytes_prev = bytes_now
        err = qoi_error_pointwise(vals, list(eps_ach), q,
                                  device=vals[0].device)
        tau_dev, pstar = _max_and_argmax(err)
        tau_p = float(lb.host_sync(tau_dev, label="qoi.tau"))
        if tau_p <= tau:
            converged = True
            break
        # floor = nothing fetchable remains anywhere (peek_best skips pieces
        # that can't reduce the bound, e.g. empty ones)
        at_floor = all(r.peek_best()[1] is None for r in readers)
        if at_floor:
            break
        # estimate next data error bounds
        if method == "cp":
            # index into the BROADCAST field: a variable smaller than err
            # (mixed-size fleet) must be expanded first
            at_p = torch.stack([v.to(err.device).broadcast_to(err.shape)
                                .reshape(-1)[pstar] for v in vals])
            vh_at_p = np.asarray(lb.host_sync(at_p, label="qoi.cp_point"),
                                 np.float64)
            nxt = eps_ach.copy()
            for _ in range(CP_MAX_HALVINGS):
                if _point_estimate(vh_at_p, nxt, q) <= tau:
                    break
                nxt = nxt / 2.0
            eps_req = nxt
        elif method == "ma":
            pass  # handled by fetch_one_more_group above
        elif method == "mape":
            p = tau_p / tau
            if p > c:
                eps_req = eps_ach / p
            else:
                for r in readers:
                    r.fetch_one_more_group()
        else:
            raise ValueError(method)

    total_bytes = sum(r.total_bytes_fetched for r in readers) - bytes0
    # bitrate per stored value across the (possibly mixed-size) fleet
    n_vals = sum(r.ref.n_elements for r in readers)
    return QoIRetrievalResult(
        values=[v.cpu().numpy() for v in vals], tau_estimated=tau_p,
        tau_requested=tau, iterations=it, bytes_fetched=total_bytes,
        bitrate=8.0 * total_bytes / max(n_vals, 1),
        eps_final=list(eps_ach), converged=converged, per_iteration=per_iter,
        degraded_groups=sum(getattr(r, "degraded_count", 0)
                            for r in readers) - deg0)
