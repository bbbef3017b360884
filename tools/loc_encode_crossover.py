#!/usr/bin/env python3
"""Where ``loc_encode`` should stop gathering plane words bit by bit.

    python3 tools/loc_encode_crossover.py [--k 0 4 8 12 16 32] [--reps 2]

needs one CUDA card and ``nvcc``.  ``loc_encode_kernel`` in
``src/repro_torch/kernels/csrc/bitplane.cu`` forms the words of at most
``kDirectPlanes`` planes directly (~33 P + 32 integer ops per word) and
transposes the 32 x 32 bits of a word in registers above that (~500 ops,
whatever P is).  This script builds the source once for each value of the
constant given (``--k``; 0 always transposes, 32 never does) into
``build/loc_encode_crossover/``, holds each build's ``loc_encode`` bit-exact
against the plain version, and prints its ``device_ms`` (``chip_smoke.py``'s
CUDA-graph replay over input copies past the L2) at the Isabel finest piece
(N = 21,875,000) for P from 1 to 23, beside the byte bound and ``rb_encode``
(the transpose without the shared tile).  The builds are timed in turns,
``--reps`` rounds.  The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)

PLANES = (1, 2, 3, 4, 6, 8, 9, 10, 12, 13, 14, 16, 20, 23)


def build_variants(bp, ks):
    """One shared library per kDirectPlanes value, built in parallel."""
    src = open(bp.SOURCES[0]).read()
    out_dir = os.path.join(REPO, "build", "loc_encode_crossover")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for k in ks:
        text, hits = re.subn(r"constexpr int kDirectPlanes = \d+;",
                             f"constexpr int kDirectPlanes = {k};", src)
        if hits != 1:
            raise RuntimeError("kDirectPlanes not found in the source")
        cu = os.path.join(out_dir, f"bitplane_k{k}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[k] = (cu[:-3] + ".so", subprocess.Popen(
            [bp._nvcc(), *bp.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for k, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for kDirectPlanes = {k}:\n{log}")
        libs[k] = ctypes.CDLL(so)
        fn = libs[k].loc_encode
        vp, ll_, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [vp, vp, ll_, ll_, i, i, ll_, vp]
        fn.restype = i
    return libs


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, nargs="+", default=[0, 4, 8, 12, 16, 32])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("loc_encode_crossover: no CUDA device available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import bitplane as bp
    from repro_torch.kernels import ref

    print(f"card: {cs.card_line()}", flush=True)
    libs = build_variants(bp, args.k)
    n = cs.FINEST_N
    x = torch.randint(0, 2 ** cs.MAG_BITS, (1, n), dtype=torch.int32,
                      device="cuda")
    copies = [x] + [x.clone() for _ in range(
        -(-2 * cs.L2_BYTES // (4 * n)) - 1)]
    it = itertools.cycle(copies)
    words = -(-n // 4096) * 128

    def encode(lib, a, p):
        out = torch.empty((1, p, words), dtype=torch.int32, device="cuda")
        err = lib.loc_encode(a.data_ptr(), out.data_ptr(), n, n, 1, p, words,
                             torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"loc_encode launch failed: cudaError {err}")
        return out

    times = {}
    for _ in range(args.reps):
        for k, lib in libs.items():
            for p in PLANES:
                cs.check(torch.equal(encode(lib, x, p),
                                     ref.encode_locality(x, p)),
                         f"kDirectPlanes = {k}: loc_encode P={p} differs")
                times.setdefault((k, p), []).append(cs.time_ms(
                    lambda: encode(lib, next(it), p), graph=True))
        for p in PLANES:
            times.setdefault(("rb", p), []).append(cs.time_ms(
                lambda: bp.encode_register_block_cuda(next(it), p),
                graph=True))
    print(f"device us per call at N={n}, {args.reps} rounds in turns; "
          "kN = loc_encode built with kDirectPlanes = N")
    for p in PLANES:
        bound = (4 * n + 4 * p * words) / cs.HBM_BYTES_PER_S * 1e6
        print(f"P={p:2d} bound {bound:.1f} | " + " | ".join(
            f"{'rb_encode' if k == 'rb' else f'k{k}'} "
            + " / ".join(f"{t * 1e3:.1f}" for t in times[(k, p)])
            for k in [*libs, "rb"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
