"""Exponent alignment: float <-> sign-magnitude fixed point.

A port of ``repro.core.align``.  HP-MDR (Alg. 1, step 1) aligns all values
of a (level-)array to the global maximum exponent so bitplane boundaries are
consistent across elements.

fp32 path: Bm = 23 magnitude bits (sign kept separately).  With
``e = frexp_exponent(max|x|)`` and ``scale = 2**(Bm - e)`` we have
``|x*scale| <= 2**Bm``, so the magnitude fits in Bm bits -- except where an
element within half a unit of ``2**e`` rounds up to ``2**Bm`` (more often
with the reference's scale, which can sit above ``2**k``, see below).  Such
a magnitude loses its top bit in the Bm planes and the stored data breaks
its error bound; the writers check ``overflows`` and raise
``MagnitudeOverflowError`` instead of storing it.

Bit-identity with the reference on every device:

* ``scale`` is the reference's own value of ``exp2(Bm - e)``, looked up from
  its float32 bit pattern (``exp2_int``).  The reference computes it with
  XLA's CPU ``exp2``, which for integer arguments is NOT exactly ``2**k``
  (up to 67 ulps off), so the port tabulates those values instead of
  calling a library ``exp2``;
* ``torch.round`` rounds half to even, like ``jnp.round``;
* the reference runs under XLA's flush-to-zero CPU arithmetic, so
  subnormal inputs and subnormal decoded values are flushed to zero here
  explicitly (identically on CPU and CUDA);
* the float -> uint32 conversion saturates like XLA's (NaN -> 0, >= 2**32
  -> 2**32 - 1).

Magnitudes and signs are uint32 bit patterns in int32 storage.

Error model (used by the retrieval planner):
  keeping the top ``P`` of ``Bm`` planes, with midpoint reconstruction of the
  truncated tail, gives
      |x - decode(P)| <= (2**(Bm-P-1) + 0.5) / scale      for 0 < P < Bm
      |x - decode(Bm)| <= 0.5 / scale                     (near-lossless floor)
      |x - 0|         <= 2**e                             for P = 0
"""
from __future__ import annotations

import functools
from typing import Tuple, Union

import numpy as np
import torch

DEFAULT_MAG_BITS = 23  # fp32 path: largest Bm with exact fp32 quantization

_MIN_NORMAL = 2.0 ** -126
_U32_MAX = 0xFFFFFFFF


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU flush-to-zero (and denormals-are-zero) made explicit: a
    subnormal becomes a zero of its own sign, as the x86 FTZ/DAZ flags give
    it (``x * 0``); NaN and infinities pass."""
    return x * (x.abs() >= _MIN_NORMAL)  # NaN * 0 is NaN


# float32 bit patterns of the reference's exp2(k) for k = -126 .. 127 (XLA's
# CPU exp2 of an integer-valued float32, flush-to-zero); k > 127 gives inf
# and k < -126 gives 0.  Generated from the reference package with
# ``jax.jit(lambda k: jnp.exp2(k.astype(jnp.float32)))``.
_EXP2_K0 = -126
_EXP2_BITS = (
    0x00000000, 0x0100001A, 0x0180000E, 0x02000002, 0x027FFFEC, 0x02FFFFD4,
    0x0380001E, 0x04000012, 0x04800006, 0x04FFFFF4, 0x057FFFDC, 0x05FFFFC4,
    0x06800016, 0x0700000A, 0x077FFFFC, 0x07FFFFE4, 0x087FFFCC, 0x0900001A,
    0x0980000E, 0x0A000002, 0x0A7FFFED, 0x0AFFFFD5, 0x0B7FFFBD, 0x0C000012,
    0x0C800006, 0x0CFFFFF5, 0x0D7FFFDD, 0x0DFFFFC5, 0x0E800016, 0x0F00000A,
    0x0F7FFFFD, 0x0FFFFFE5, 0x107FFFCD, 0x1100001B, 0x1180000F, 0x12000003,
    0x127FFFED, 0x1300000B, 0x137FFFFD, 0x13FFFFE5, 0x14800007, 0x14FFFFF5,
    0x157FFFDD, 0x16000003, 0x167FFFED, 0x1700000B, 0x177FFFFD, 0x17FFFFE5,
    0x18800007, 0x18FFFFF6, 0x1980000F, 0x1A000003, 0x1A7FFFEE, 0x1B00000B,
    0x1B7FFFFE, 0x1BFFFFE6, 0x1C800007, 0x1CFFFFF6, 0x1D7FFFDE, 0x1E000003,
    0x1E7FFFEE, 0x1F00000B, 0x1F7FFFFE, 0x1FFFFFE6, 0x20800007, 0x20FFFFF6,
    0x2180000F, 0x22000003, 0x227FFFEE, 0x2300000B, 0x237FFFFE, 0x23FFFFE6,
    0x24800007, 0x24FFFFF6, 0x257FFFDE, 0x26000003, 0x267FFFEE, 0x2700000B,
    0x277FFFFE, 0x27FFFFE6, 0x28800007, 0x28FFFFF7, 0x297FFFFF, 0x2A000003,
    0x2A7FFFEF, 0x2AFFFFF7, 0x2B7FFFFF, 0x2C000003, 0x2C800007, 0x2CFFFFF7,
    0x2D7FFFFF, 0x2E000003, 0x2E7FFFEF, 0x2EFFFFF7, 0x2F7FFFFF, 0x30000004,
    0x30800008, 0x30FFFFF7, 0x317FFFFF, 0x32000004, 0x327FFFEF, 0x32FFFFF7,
    0x337FFFFF, 0x34000004, 0x347FFFFF, 0x34FFFFF7, 0x357FFFFF, 0x36000004,
    0x367FFFFF, 0x36FFFFF7, 0x377FFFFF, 0x38000004, 0x38800000, 0x38FFFFF8,
    0x39800000, 0x3A000000, 0x3A800000, 0x3B000000, 0x3B800000, 0x3C000000,
    0x3C800000, 0x3D000000, 0x3D800000, 0x3E000000, 0x3E800000, 0x3F000000,
    0x3F800000, 0x40000000, 0x40800000, 0x41000000, 0x41800000, 0x42000000,
    0x42800000, 0x43000000, 0x43800000, 0x44000000, 0x44800000, 0x45000000,
    0x45800000, 0x46000004, 0x46800000, 0x46FFFFF8, 0x47800000, 0x48000004,
    0x48800000, 0x48FFFFF9, 0x49800000, 0x4A000004, 0x4A800000, 0x4AFFFFF9,
    0x4B800000, 0x4C000004, 0x4C800008, 0x4CFFFFF9, 0x4D800000, 0x4E000004,
    0x4E7FFFF1, 0x4EFFFFF9, 0x4F800001, 0x50000005, 0x50800009, 0x50FFFFF9,
    0x51800001, 0x52000005, 0x527FFFF1, 0x52FFFFF9, 0x53800001, 0x54000005,
    0x54800009, 0x54FFFFF9, 0x55800001, 0x56000005, 0x567FFFF1, 0x5700000D,
    0x57800001, 0x57FFFFEA, 0x58800009, 0x58FFFFFA, 0x59800011, 0x5A000005,
    0x5A7FFFF2, 0x5B00000D, 0x5B800001, 0x5BFFFFEA, 0x5C800009, 0x5CFFFFFA,
    0x5D7FFFE2, 0x5E000005, 0x5E7FFFF2, 0x5F00000D, 0x5F800001, 0x5FFFFFEA,
    0x60800009, 0x60FFFFFA, 0x61800011, 0x62000005, 0x627FFFF2, 0x6300000D,
    0x63800001, 0x63FFFFEA, 0x64800009, 0x64FFFFFA, 0x657FFFE2, 0x66000005,
    0x667FFFF2, 0x6700000D, 0x67800001, 0x67FFFFEB, 0x68800009, 0x68FFFFFB,
    0x69800011, 0x6A000005, 0x6A7FFFF3, 0x6B00000D, 0x6B800001, 0x6BFFFFEB,
    0x6C800009, 0x6CFFFFFB, 0x6D7FFFE3, 0x6DFFFFCB, 0x6E80001A, 0x6F00000E,
    0x6F800002, 0x6FFFFFEB, 0x707FFFD3, 0x7100001E, 0x71800012, 0x72000006,
    0x727FFFF3, 0x72FFFFDB, 0x73800022, 0x74000016, 0x7480000A, 0x74FFFFFB,
    0x757FFFE3, 0x75FFFFCB, 0x7680001A, 0x7700000E, 0x77800002, 0x77FFFFEC,
    0x787FFFD4, 0x7900001E, 0x79800012, 0x7A000006, 0x7A7FFFF4, 0x7AFFFFDC,
    0x7B7FFFC4, 0x7C000016, 0x7C80000A, 0x7CFFFFFC, 0x7D7FFFE4, 0x7DFFFFCC,
    0x7E80001A, 0x7F00000E,
)


@functools.lru_cache(maxsize=8)
def _exp2_table(device: torch.device) -> torch.Tensor:
    bits = torch.tensor(_EXP2_BITS, dtype=torch.int64)
    return bits.to(torch.int32).view(torch.float32).to(device)


def exp2_int(k: torch.Tensor) -> torch.Tensor:
    """The reference's float32 ``exp2(k)`` for an integer tensor ``k``."""
    k = k.to(torch.int64)
    table = _exp2_table(k.device)
    val = table[(k - _EXP2_K0).clamp(0, len(_EXP2_BITS) - 1)]
    val = torch.where(k > 127, torch.full_like(val, float("inf")), val)
    return torch.where(k < _EXP2_K0, torch.zeros_like(val), val)


def _sat_u32(q: torch.Tensor) -> torch.Tensor:
    """Non-negative float32 -> uint32 bit pattern (int32 storage),
    saturating like XLA's convert: NaN -> 0, >= 2**32 -> 2**32 - 1."""
    big = q >= 4294967296.0
    q = torch.where(torch.isnan(q) | big, torch.zeros_like(q), q)
    v = q.to(torch.int64)
    v = torch.where(big, torch.full_like(v, _U32_MAX), v)
    return v.to(torch.int32)


def max_exponent(x: torch.Tensor) -> torch.Tensor:
    """Return integer e with max|x| <= 2**e (frexp convention), e=0 if x==0."""
    if x.numel() == 0:
        return torch.zeros((), dtype=torch.int32, device=x.device)
    amax = torch.max(torch.abs(x))
    _, e = torch.frexp(amax)
    return torch.where(amax > 0, e, torch.zeros_like(e)).to(torch.int32)


def align_encode(x: torch.Tensor, mag_bits: int = DEFAULT_MAG_BITS
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize to sign-magnitude fixed point aligned at the max exponent.

    Returns (magnitude [same shape], sign 0/1 [same shape], exponent int32
    scalar); magnitude and sign are uint32 bit patterns in int32 storage."""
    x = flush_subnormal(x.to(torch.float32))
    e = max_exponent(x)
    scale = exp2_int(mag_bits - e)
    q = torch.round(x * scale)
    sign = (q < 0).to(torch.int32)
    mag = _sat_u32(torch.abs(q))
    return mag, sign, e


class MagnitudeOverflowError(ValueError):
    """A quantized magnitude needs more than the format's magnitude bits."""


def overflows(mag: torch.Tensor, mag_bits: int = DEFAULT_MAG_BITS
              ) -> torch.Tensor:
    """Device bool scalar: some magnitude of ``align_encode`` has a bit at or
    above ``mag_bits`` and so cannot be stored in ``mag_bits`` planes.  With
    ``mag_bits = 32`` the float -> uint32 conversion saturates instead."""
    if mag_bits >= 32 or mag.numel() == 0:
        return torch.zeros((), dtype=torch.bool, device=mag.device)
    return torch.bitwise_and(mag, -(1 << mag_bits)).ne(0).any()


def check_fits(flags, mag_bits: int, name: str) -> None:
    """Raise ``MagnitudeOverflowError`` if any per-piece host flag of
    ``overflows`` is set."""
    bad = [i for i, f in enumerate(np.asarray(flags).reshape(-1)) if f]
    if bad:
        raise MagnitudeOverflowError(
            f"{name}: piece(s) {bad} hold a value that quantizes to "
            f"2**{mag_bits} at the piece's exponent, one bit more than "
            f"{mag_bits} magnitude planes hold; stored, it would break the "
            f"error bound")


def align_decode(mag: torch.Tensor, sign: torch.Tensor,
                 e: Union[int, torch.Tensor],
                 mag_bits: int = DEFAULT_MAG_BITS,
                 planes_kept: int | None = None) -> torch.Tensor:
    """Inverse of align_encode. If ``planes_kept`` < mag_bits, the magnitude is
    assumed already truncated to its top ``planes_kept`` planes and a midpoint
    correction of the truncated tail is applied (MDR-style unbiased decode)."""
    p = mag_bits if planes_kept is None else planes_kept
    m = mag.to(torch.int64) & _U32_MAX
    if p < mag_bits:
        tail = mag_bits - p
        m = (m >> tail) << tail
        # midpoint of the truncation interval; applied even at mag==0 (the
        # sign plane travels with the first group, so sign is known)
        m = (m + (1 << (tail - 1))) & _U32_MAX if tail >= 1 else m
    if not isinstance(e, torch.Tensor):
        e = torch.tensor(int(e), dtype=torch.int32, device=mag.device)
    scale = exp2_int(mag_bits - e.to(mag.device))
    val = flush_subnormal(m.to(torch.float32) / scale)
    return torch.where(sign != 0, -val, val)


def truncation_error(e: int | np.ndarray, planes_kept: int, mag_bits: int = DEFAULT_MAG_BITS) -> float:
    """Conservative max-norm error bound for keeping ``planes_kept`` planes."""
    e = np.asarray(e, dtype=np.float64)
    if planes_kept <= 0:
        return float(np.exp2(e))
    scale = np.exp2(mag_bits - e)
    if planes_kept >= mag_bits:
        return float(0.5 / scale)
    return float((np.exp2(mag_bits - planes_kept - 1) + 0.5) / scale)
