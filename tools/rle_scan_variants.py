#!/usr/bin/env python3
"""Where ``rle_scan``'s device time goes, by variants of its source.

    python3 tools/rle_scan_variants.py [--reps 2]

needs one CUDA card and ``nvcc``.  Builds
``src/repro_torch/kernels/csrc/lossless.cu`` as it is and once for each
variant below (a text substitution, which must apply exactly once) into
``build/rle_scan_variants/``, all at once; holds the builds that keep the
output (shipped, narrow, wide) byte-identical to the plain pass on edge
sizes and a bucket of many tiles; then prints each build's ``rle_scan``
device time (``chip_smoke.py``'s CUDA-graph replay over input copies past
the L2), the builds in turns, ``--reps`` rounds, at S = 10,938,368
(Isabel's finest 4-plane group), 2,734,592 (its sign plane), 4,194,304
and 262,144 (phase 8's and phase 9's largest groups), one row each, on
five contents (uniform bytes, a skewed draw, runs of 1-300, all zero, and
a plane-like mix of zeros and 4-bit noise), beside the byte bound (the
symbols read, this data's runs written).  The variants:

* shipped: the source as it is;
* narrow, wide: blocks of 256 or of 512 threads whatever the tile count;
* no emission: no run written, only the reads, counts and look-backs
  (timing only: its output is wrong);
* values only, lengths only: one output stream's stores removed (timing
  only).

Then a write-rate probe: warps each writing their own contiguous bytes 32
a step, one byte a lane, at a 16-byte boundary and 7 bytes past one (the
scan's value stores begin at any slot).  The card's name and power limit
come first.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)

SIZES = (10_938_368, 2_734_592, 4_194_304, 262_144)
CONTENTS = ("uniform", "skewed", "runs", "zeros", "planes")
WIDE = "  const bool wide = tickets <= 2LL * sm_count();\n"
VALUE_STORE = "        vrow[r] = static_cast<uint8_t>(x[k]);\n"
LENGTH_STORE = ("          lrow[r - 1] = static_cast<uint16_t>(p - before);"
                "\n")
VARIANTS = {
    "shipped": [],
    "narrow": [(WIDE, "  const bool wide = false;\n")],
    "wide": [(WIDE, "  const bool wide = tickets > 0;\n")],
    "no emission": [("    if (piece_n[pi] == 0) continue;\n",
                     "    if (piece_n[pi] >= 0) continue;\n")],
    "values only": [(LENGTH_STORE, "          (void)before;\n")],
    "lengths only": [(VALUE_STORE, "")],
}
KEEP_OUTPUT = ("shipped", "narrow", "wide")
PROBE = r"""
#include <cstdint>
#include <cuda_runtime.h>
// warp w writes out[w * per + shift, (w + 1) * per + shift), 32 bytes a
// step, one a lane
__global__ void probe_kernel(uint8_t* out, long long per, int shift,
                             int warps) {
  const int lane = threadIdx.x & 31;
  const long long w = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (w >= warps) return;
  uint8_t* o = out + w * per + shift;
  for (long long q = 0; q + 32 <= per; q += 32) o[q + lane] = (uint8_t)lane;
}
extern "C" int write_probe(void* out, long long per, int shift, int warps,
                           void* stream) {
  probe_kernel<<<(warps * 32 + 255) / 256, 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), per, shift, warps);
  return (int)cudaGetLastError();
}
"""


def build(bp):
    """One shared library a variant, and the write probe, built at once."""
    src = open(os.path.join(os.path.dirname(bp.SOURCES[0]),
                            "lossless.cu")).read()
    out_dir = os.path.join(REPO, "build", "rle_scan_variants")
    os.makedirs(out_dir, exist_ok=True)
    texts = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old.strip()!r} not found once")
            text = text.replace(old, new)
        texts[name] = text
    texts["write probe"] = PROBE
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu = os.path.join(out_dir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (cu[:-3] + ".so", subprocess.Popen(
            [bp._nvcc(), *bp.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    vp, ll_, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        if name == "write probe":
            lib.write_probe.argtypes = [vp, ll_, i, i, vp]
            lib.write_probe.restype = i
        else:
            lib.rle_scan.argtypes = [vp, ll_, ll_, vp, vp, vp, vp, vp]
            lib.rle_scan.restype = i
        libs[name] = lib
    return libs


def run(torch, lib, x):
    """``rle_scan`` of the build ``lib`` on the (B, S) rows ``x``, as the
    wrapper launches it."""
    b, s = x.shape
    status = torch.empty((b * -(-s // 32768) + 1,), dtype=torch.int64,
                         device=x.device)
    vals = torch.empty((b, s), dtype=torch.uint8, device=x.device)
    lens = torch.empty((b, s), dtype=torch.int16, device=x.device)
    nruns = torch.empty((b,), dtype=torch.int64, device=x.device)
    err = lib.rle_scan(x.data_ptr(), b, s, status.data_ptr(),
                       vals.data_ptr(), lens.data_ptr(), nruns.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rle_scan launch failed: cudaError {err}")
    return vals, lens, nruns


def rows(np, kind, b, s, rng):
    if kind == "uniform":
        return rng.integers(0, 256, (b, s)).astype(np.uint8)
    if kind == "skewed":
        return (rng.geometric(0.3, (b, s)) % 256).astype(np.uint8)
    if kind == "runs":
        reps = rng.integers(1, 300, (b, s // 20 + 2))
        vals = rng.integers(0, 4, (b, s // 20 + 2))
        return np.stack([np.repeat(v, r)[:s] for v, r in zip(vals, reps)]
                        ).astype(np.uint8)
    if kind == "zeros":
        return np.zeros((b, s), np.uint8)
    return (rng.integers(0, 16, (b, s)) * (rng.random((b, s)) < 0.6)
            ).astype(np.uint8)


def check(torch, ll, lib, x, what):
    vals, lens, nruns = run(torch, lib, x)
    pv, pl, pn = ll._rle_scan_plain(x)
    live = torch.arange(x.shape[1], device=x.device)[None, :] < pn[:, None]
    if not (torch.equal(nruns, pn) and torch.equal(vals[live], pv[live])
            and torch.equal(lens.to(torch.int64)[live] & 0xFFFF, pl[live])):
        raise RuntimeError(f"{what}: differs from the plain pass on "
                           f"{tuple(x.shape)}")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("rle_scan_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import lossless as ll
    from repro_torch.kernels import bitplane as bp

    print(f"card: {cs.card_line()}", flush=True)
    libs = build(bp)
    rng = np.random.default_rng(31)
    shapes = [(b, s) for s in (1, 31, 4097, 32767, 32768, 32769, 100_000)
              for b in (1, 3)] + [(400, 16384), (263, 16384)]
    for name in KEEP_OUTPUT:
        for (b, s), kind in itertools.product(shapes, CONTENTS):
            x = torch.from_numpy(rows(np, kind, b, s, rng)).cuda()
            check(torch, ll, libs[name], x, name)
    print(f"{', '.join(KEEP_OUTPUT)}: byte-identical to the plain pass on "
          f"{len(shapes) * len(CONTENTS)} cases", flush=True)
    for s in SIZES:
        for kind in CONTENTS:
            x0 = torch.from_numpy(rows(np, kind, 1, s, rng)).cuda()
            copies = [x0] + [x0.clone() for _ in range(
                -(-2 * cs.L2_BYTES // s) - 1)]
            nruns = int(ll._rle_scan_plain(x0)[2][0])
            nbytes = s + 3 * nruns + 8
            times = {name: [] for name in VARIANTS}
            for _ in range(args.reps):
                for name in VARIANTS:
                    it = itertools.cycle(copies)
                    times[name].append(cs.time_ms(
                        lambda: run(torch, libs[name], next(it)),
                        graph=True) * 1e3)
            print(f"S={s} {kind} ({nruns} runs, bound "
                  f"{nbytes / cs.HBM_BYTES_PER_S * 1e6:.2f} us): " + ", ".join(
                      f"{name} " + " / ".join(f"{t:.1f}" for t in ts)
                      for name, ts in times.items()) + " us", flush=True)
            del copies
    probe = libs["write probe"]
    outs = [torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
            for _ in range(4)]
    for warps, per in ((2672, 4096), (2672, 8192)):
        for shift in (0, 7):
            it = itertools.cycle(outs)
            ms = cs.time_ms(lambda: probe.write_probe(
                next(it).data_ptr(), per, shift, warps,
                torch.cuda.current_stream().cuda_stream), graph=True)
            mb = warps * per / 1e6
            print(f"write probe: {warps} warps x {per} B = {mb:.1f} MB at "
                  f"{shift} past a 16-byte boundary: {ms * 1e3:.1f} us "
                  f"({mb / ms / 1e3:.2f} TB/s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
