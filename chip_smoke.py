#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its main path on a GPU.

    python3 chip_smoke.py [--profile]

needs one CUDA card, ``nvcc`` and the checkout's ``src/repro_torch``; it
imports nothing of JAX and nothing of the JAX package.  Phases, in order
(any failure exits non-zero and prints no result):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` and print
   the build time and the card's name and power limit;
2. hold each of the five kernels bit-exact against its plain torch version
   on the card (N in {1, 4095, 4097, 12289, 21875000}, P in {1, 8, 9, 23,
   31, 32}, batch {1, 3}, plane offsets {0, 4, 20}, decoded row counts {1,
   2, 3, 4, 5, 8, 9, 16, 17, 31} and all rows) and time kernel and plain
   version at the Hurricane-Isabel finest-piece shape and at phase 8's
   finest piece, where ``shuffle_encode`` and ``loc_decode`` run (CUDA
   events, median).  A kernel's ``ms`` is a call back to back through its
   wrapper, host path included, on one input; its ``device_ms`` is the
   replay of a CUDA graph of its calls that cycles through enough copies
   of the input to move at least twice the L2's size between two reads of
   one copy, so that it is the device's time from memory, the one to hold
   against ``bound_ms``.  The three encoders' ``device_ms`` is also swept
   over P in {1, 2, 4, 8, 9, 12, 16} at the Isabel finest piece (either
   side of ``loc_encode``'s direct-gather bound);
3. refactor the full Isabel-shaped field (100, 500, 500) float32 on the card,
   serialize and deserialize it, and progressively retrieve it over the
   relative tolerances 1e-1 .. 1e-6, requiring max|x - x_hat| <= bound at
   every step and non-decreasing cumulative bytes; the kernels' launch
   counters are zeroed just before and read just after, and the
   ``register_block`` pair's must be > 0;
4. a (64, 128, 128) slice refactored on the card and on the CPU must give
   byte-identical wire blobs and bit-identical reconstructions at three
   tolerances;
5. warm write and read-ladder times (the warm blob must equal the first);
6. only with ``--profile``: the same write and ladder under
   ``torch.profiler``: stage wall times, device busy time, the bitplane
   kernels' device time and the top ops.  This takes about two minutes;
7. QoI-controlled retrieval (Algorithm 3) over Hurricane Isabel's U, V, W
   at (100, 500, 500) each, refactored on the card with
   ``design="locality"`` (U also with ``"shuffle"``, whose segments must be
   byte-identical): CP, MA and MAPE each on fresh readers, tau 1e-2 then
   1e-4, requiring the actual V_total error (float64, on the card) <= the
   estimate, the estimate <= tau when converged, and non-decreasing bytes;
   then card == CPU results on a (48, 48, 48) velocity field;
8. the chunked pipeline, ``design="shuffle"``, on the NYX-shaped field
   (512, 512, 512) in 8 chunks of 2**24 values: pipelined and serial writes
   must give identical blobs, pipelined and serial reads identical values
   within the tolerance; the plain backend on the card must write the same
   blobs and read the same values (the kernels held against their plain
   versions at the pipeline's own shapes and batches); then card == CPU
   chunk blobs on a (64, 128, 128) field for both new designs;
9. the store and serving stack: ``DatasetWriter`` writes Isabel's U, V, W
   (3 x 25,000,000 float32, chunks of 2**20, ``register_block``, pipelined,
   checksums on) into a store under ``build/store_smoke/``; the store is
   opened cold behind a ``CachingBackend`` and 8 session threads, released
   by one barrier, are served through the shared ``ServingTier``: two
   relative-tolerance ladders 1e-1 .. 1e-5 per variable (the second a step
   behind the first after their common first step, so claims coalesce and
   then hit the plane cache) and two MAPE QoI sessions (V_total, tau 1e-3).
   Every array must equal a private (``serving=False``) service's on the
   plain backend (``backend="torch"``: every shared ``rb_decode`` bucket
   is held against the plain decode) bit for bit with equal bounds and
   bytes, errors must stay within the bounds and
   the QoI's actual error within tau', the tier's claims must add up with
   one backend fetch per decoded group (plus the manifest), the
   ``rb_decode`` launches must be fewer than the decode jobs, and a CPU
   write of U must give the card's segment bytes and manifest entry.

Phases 7, 8 and 9 zero the launch counters before their runs and require
the kernels of their paths to have launched; the kernels line's
``launches`` is phase 3's count for the ``register_block`` pair (phase 9's
are printed on a line of their own).  Each phase's wall and peak device
memory are printed at its end.
Then it prints the ``{"kernels": [...]}`` line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

ISABEL_SHAPE = (100, 500, 500)
NYX_SHAPE = (512, 512, 512)    # data.fields.DATASETS["nyx"]
FINEST_N = 21_875_000          # finest detail piece of the Isabel field
MAG_BITS = 23
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
L2_BYTES = 50 * 2 ** 20        # H100 SXM data sheet
INT32_OPS_PER_S = 16.7e12      # 132 SMs x 64 INT32 lanes x 1.98 GHz boost
TOLS = (1e-1, 1e-2, 1e-3, 1e-4, 1e-5, 1e-6)
QOI_TAUS = (1e-2, 1e-4)
QOI_METHODS = {"cp": {}, "ma": {}, "mape": {"c": 10.0}}
PIPE_TOL = 1e-4
PIPE_CHUNK = 1 << 24           # phase 8's chunk_elems
PIPE_LEVELS = 2
DECODE_ROWS = (1, 2, 3, 4, 5, 8, 9, 16, 17, 31)  # edges of any row bucket
SWEEP_PLANES = (1, 2, 4, 8, 9, 12, 16)  # both sides of kDirectPlanes = 8


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 11, inner: int = 20, warmup: int = 10,
            graph: bool = False) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``inner`` calls,
    after ``warmup`` untimed calls.  With ``graph`` the ``inner`` calls are
    captured once in a CUDA graph and replayed, so that the time is the
    device's alone; without, a call that costs the host more than the
    device has to do measures the host."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(inner):
            fn()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / inner)
    return statistics.median(out)


def phase(name: str):
    import torch
    print(f"== {name}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    return time.perf_counter()


def done(t0: float, name: str) -> None:
    import torch
    print(f"-- {name}: {time.perf_counter() - t0:.2f} s wall, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
          f"allocated", flush=True)


# ---------------------------------------------------------------- phase 2 --

def kernel_specs(bp, ref):
    """Per format: its plain encode and decode, its encode kernels and its
    decode kernel, each as (name, wrapper, replaced TPU kernel)."""
    tpu = "src/repro/kernels/bitplane.py"
    return {
        "register_block": (
            ref.encode_register_block, ref.decode_register_block,
            [("rb_encode", bp.encode_register_block_cuda, f"{tpu}:74")],
            ("rb_decode", bp.decode_register_block_cuda, f"{tpu}:96")),
        "locality": (
            ref.encode_locality, ref.decode_locality,
            [("loc_encode", bp.encode_locality_cuda, f"{tpu}:121"),
             ("shuffle_encode", bp.encode_shuffle_cuda, f"{tpu}:144")],
            ("loc_decode", bp.decode_locality_cuda, f"{tpu}:130")),
    }


def kernels_vs_plain(torch, specs):
    """Bit-exact comparisons on the card (these launches are not counted as
    main-path launches: the counters are reset before phases 3, 7 and 8)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    n_cases = 0
    for n in (1, 4095, 4097, 12289, FINEST_N):
        for p in (1, 8, 9, 23, 31, 32):
            for b in ((1,) if n == FINEST_N else (1, 3)):
                x = torch.randint(-2 ** 31, 2 ** 31, (b, n), generator=g,
                                  dtype=torch.int64, device="cuda"
                                  ).to(torch.int32)
                for fmt, (enc, dec, encoders, (dname, dfn, _)) in \
                        specs.items():
                    want = enc(x, p)
                    for name, fn, _ in encoders:
                        check(torch.equal(fn(x, p), want),
                              f"{name} n={n} P={p} B={b}")
                        n_cases += 1
                    for off in sorted({min(o, p - 1) for o in (0, 4, 20)}):
                        for rows in sorted({r for r in DECODE_ROWS
                                            if r < p - off} | {p - off}):
                            pl = want[:, off:off + rows].contiguous()
                            check(torch.equal(dfn(pl, p - off, n),
                                              dec(pl, p - off, n)),
                                  f"{dname} n={n} P={p} B={b} off={off} "
                                  f"rows={rows}")
                            n_cases += 1
    torch.cuda.synchronize()
    return n_cases


def kernel_timings(torch, specs, n=FINEST_N):
    """Kernel vs plain time of every kernel at ``n`` elements (the main
    path's finest-piece shape by default); rows keyed (kernel, case)."""
    x = torch.randint(0, 2 ** MAG_BITS, (1, n), dtype=torch.int32,
                      device="cuda")
    rows = {}

    def err(a, b):
        return (a.to(torch.int64) - b.to(torch.int64)).abs().max().item()

    def timed(call, arg, nbytes, **extra):
        """``call(arg)`` back to back on one input, and as the replay of a
        graph cycling through copies of ``arg`` (at least 2 L2 sizes moved
        between two reads of one copy)."""
        copies = [arg] + [arg.clone() for _ in range(
            -(-2 * L2_BYTES // nbytes) - 1)]
        it = itertools.cycle(copies)
        return dict(n=n, ms=time_ms(lambda: call(arg)),
                    device_ms=time_ms(lambda: call(next(it)), graph=True),
                    copies=len(copies), bytes=nbytes, **extra)

    for fmt, (enc, dec, encoders, (dname, dfn, _)) in specs.items():
        planes = enc(x, MAG_BITS)
        words = planes.shape[2]
        group = planes[:, :4].contiguous()
        sign = enc(x, 1)
        # the bit transpose of a 5-stage butterfly, ~512 integer ops per 32
        # words, is the least work any of the formats needs
        ops = 16 * 32 * words
        for case, p in (("encode 23 planes", MAG_BITS),
                        ("encode 1 sign plane", 1)):
            want = enc(x, p)
            plain_ms = time_ms(lambda: enc(x, p), reps=3, inner=1, warmup=1)
            for name, fn, _ in encoders:
                rows[(name, case)] = timed(
                    lambda a: fn(a, p), x, 4 * n + 4 * p * words,
                    plain_ms=plain_ms, ops=ops,
                    max_abs_err=err(fn(x, p), want))
        for case, pl, total in (("decode 4-plane group", group, MAG_BITS),
                                ("decode 23 planes", planes, MAG_BITS),
                                ("decode 1 sign plane", sign, 1)):
            want = dec(pl, total, n)
            rows[(dname, case)] = timed(
                lambda a: dfn(a, total, n), pl,
                4 * pl.shape[1] * words + 4 * n,
                plain_ms=time_ms(lambda: dec(pl, total, n),
                                 reps=3, inner=1, warmup=1),
                ops=ops, max_abs_err=err(dfn(pl, total, n), want))
    for r in rows.values():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / INT32_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return rows


def encode_sweep(torch, bp, n=FINEST_N):
    """``device_ms`` of the three encoders at each of ``SWEEP_PLANES``:
    ``loc_encode`` gathers each plane's word bit by bit up to
    ``kDirectPlanes`` (8) planes and transposes above, ``rb_encode`` always
    transposes; rows keyed (kernel, P)."""
    x = torch.randint(0, 2 ** MAG_BITS, (1, n), dtype=torch.int32,
                      device="cuda")
    copies = [x] + [x.clone() for _ in range(-(-2 * L2_BYTES // (4 * n)) - 1)]
    it = itertools.cycle(copies)
    words = -(-n // 4096) * 128  # planes are padded to whole 4096-tiles
    rows = {}
    for p in SWEEP_PLANES:
        for name, fn in (("loc_encode", bp.encode_locality_cuda),
                         ("rb_encode", bp.encode_register_block_cuda),
                         ("shuffle_encode", bp.encode_shuffle_cuda)):
            rows[(name, p)] = time_ms(lambda: fn(next(it), p), graph=True)
        bound = (4 * n + 4 * p * words) / HBM_BYTES_PER_S * 1e3
        print(f"encode sweep P={p} (N={n}): device " + ", ".join(
            f"{name} {rows[(name, p)] * 1e3:.1f} us" for name in
            ("loc_encode", "rb_encode", "shuffle_encode"))
            + f"; bound {bound * 1e3:.1f} us", flush=True)
    return rows


def print_timings(timings) -> None:
    for (name, case), r in timings.items():
        print(f"{name} {case} (N={r['n']}): kernel {r['ms'] * 1e3:.1f} us "
              f"a call back to back through the wrapper, device "
              f"{r['device_ms'] * 1e3:.1f} us (graph replay over "
              f"{r['copies']} input copies, "
              f"{r['bytes'] / r['device_ms'] / 1e6:.0f} GB/s), "
              f"plain {r['plain_ms'] * 1e3:.1f} us, bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})", flush=True)


# ---------------------------------------------------------------- phase 3 --

def read_launches(bp, required, what: str):
    """Every kernel's launch count since the last reset; the ``required``
    ones must be > 0."""
    launches = {"rb_encode": bp.encode_register_block_cuda.launches,
                "rb_decode": bp.decode_register_block_cuda.launches,
                "loc_encode": bp.encode_locality_cuda.launches,
                "shuffle_encode": bp.encode_shuffle_cuda.launches,
                "loc_decode": bp.decode_locality_cuda.launches}
    print(f"{what}: {launches}", flush=True)
    for k in required:
        check(launches[k] > 0, f"kernel {k} was not launched ({what})")
    return launches


def main_path(torch, bp, rf, rt, x_np):
    from repro_torch.core import lossless_batch as lb
    x_dev = torch.from_numpy(x_np).to("cuda")
    bp.reset_launches()
    t0 = time.perf_counter()
    with lb.stats_scope() as st:
        r = rf.refactor_array(x_np, "isabel", device="cuda")
    torch.cuda.synchronize()
    t_write = time.perf_counter() - t0
    check(st.host_syncs == 3, f"write made {st.host_syncs} host syncs, not 3")
    blob = rf.refactored_to_bytes(r)
    print(f"refactor {ISABEL_SHAPE} float32 (first call): {t_write:.3f} s, "
          f"{x_np.nbytes / t_write / 1e9:.3f} GB/s, {len(blob)} wire bytes "
          f"(ratio {x_np.nbytes / len(blob):.3f}), 3 host syncs", flush=True)
    r2 = rf.refactored_from_bytes(blob)
    check(rf.refactored_to_bytes(r2) == blob, "wire blob does not round-trip")

    reader = rt.ProgressiveReader(r2, device="cuda")
    cum = 0
    for tol in TOLS:
        t0 = time.perf_counter()
        with lb.stats_scope() as st:
            xh, bound, fetched = reader.retrieve_device(tol, relative=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(st.host_syncs <= 1, f"tol {tol}: {st.host_syncs} host syncs")
        check(tuple(xh.shape) == ISABEL_SHAPE and xh.dtype == torch.float32,
              f"reconstruction shape {tuple(xh.shape)} {xh.dtype}")
        check(bool(torch.isfinite(xh).all()), f"non-finite values at {tol}")
        err = (xh - x_dev).abs().max().item()
        check(err <= bound, f"tol {tol}: max error {err} > bound {bound}")
        check(bound <= max(tol * r2.data_range, reader.floor_bound() * 1.001),
              f"tol {tol}: bound {bound} above the request")
        check(fetched >= 0 and reader.total_bytes_fetched >= cum,
              "cumulative bytes decreased")
        cum = reader.total_bytes_fetched
        print(f"retrieve rel tol {tol:g}: {dt:.3f} s, bound {bound:.6g}, "
              f"max err {err:.6g}, +{fetched} B, cumulative {cum} B, "
              f"{st.host_syncs} host sync(s)", flush=True)
    launches = read_launches(bp, ("rb_encode", "rb_decode"),
                             "main-path launches")
    return launches, blob


# ------------------------------------------------------------ phases 5, 6 --

def warm_times(torch, rf, rt, x_np, blob):
    """Warm write (median of 3) and warm read ladder, on the host clock."""
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = rf.refactor_array(x_np, "isabel", device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(rf.refactored_to_bytes(r) == blob, "warm refactor differs")
    w = statistics.median(walls)
    print(f"write (warm, median of 3): {w:.3f} s, "
          f"{x_np.nbytes / w / 1e9:.3f} GB/s")
    reader = rt.ProgressiveReader(r, device="cuda")
    t_ladder = time.perf_counter()
    for tol in TOLS:
        t0 = time.perf_counter()
        reader.retrieve_device(tol, relative=True)
        torch.cuda.synchronize()
        print(f"read (warm) rel tol {tol:g}: "
              f"{time.perf_counter() - t0:.3f} s")
    print(f"read ladder (warm, {len(TOLS)} steps): "
          f"{time.perf_counter() - t_ladder:.3f} s")
    return r


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _prof_report(prof, what: str, walls, n: int = 10) -> None:
    """Host walls of the profiler's start-up, the run and its exit; device
    busy ms (the profiler's own buffer requests left out); the bitplane
    kernels' device time; and the top ops by self CPU time."""
    evs = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    busy = sum(_dev_us(e) for e in evs
               if e.key != "Activity Buffer Request") / 1e3
    print(f"{what} (profiled): start-up {walls[0]:.3f} s, run "
          f"{walls[1]:.3f} s, exit {walls[2]:.3f} s (host walls); device "
          f"busy {busy:.1f} ms")
    for kern in ("rb_encode_kernel", "rb_decode_kernel"):
        hits = [e for e in evs if kern in e.key]
        print(f"  {what} kernel {kern}: {sum(e.count for e in hits)} "
              f"launches, device "
              f"{sum(_dev_us(e) for e in hits) / 1e3:.3f} ms")
    for e in evs[:n]:
        print(f"  {what} op {e.key}: {e.count} calls, self cpu "
              f"{e.self_cpu_time_total / 1e3:.1f} ms, self device "
              f"{_dev_us(e) / 1e3:.1f} ms")


def _profile(torch, fn):
    """Run ``fn`` under torch.profiler; returns the profile and the host
    walls of the profiler's start-up, of ``fn`` (synchronized) and of the
    profiler's exit, which processes the recorded events."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return prof, (t1 - t0, t2 - t1, time.perf_counter() - t2)


def profiled(torch, rf, rt, x_np, r):
    """The warm write and ladder under torch.profiler, with the write's
    stage spans from the port's tracer."""
    from repro_torch.obs import trace as obs_trace
    with obs_trace.tracing() as tr:
        prof, walls = _profile(torch, lambda: rf.refactor_array(
            x_np, "isabel", device="cuda"))
    spans = tr.summary()["spans"]
    print("write spans: " + ", ".join(
        f"{k} {v['total_s']:.3f} s" for k, v in spans.items()))
    _prof_report(prof, "write", walls)
    reader = rt.ProgressiveReader(r, device="cuda")

    def ladder():
        for tol in TOLS:
            reader.retrieve_device(tol, relative=True)
    prof, walls = _profile(torch, ladder)
    _prof_report(prof, f"read ladder ({len(TOLS)} steps)", walls)


# ---------------------------------------------------------------- phase 4 --

def card_vs_cpu(torch, rf, rt, x_np):
    xs = x_np[:64, :128, :128].copy()
    blobs = {d: rf.refactored_to_bytes(rf.refactor_array(xs, "slice",
                                                         device=d))
             for d in ("cuda", "cpu")}
    check(blobs["cuda"] == blobs["cpu"],
          "card and CPU wire blobs differ on the (64, 128, 128) slice")
    readers = {d: rt.ProgressiveReader(rf.refactored_from_bytes(blobs[d]),
                                       device=d) for d in ("cuda", "cpu")}
    for tol in (1e-2, 1e-4, 1e-6):
        outs = {d: readers[d].retrieve(tol, relative=True)
                for d in ("cuda", "cpu")}
        a, b = outs["cuda"], outs["cpu"]
        check(a[1] == b[1] and a[2] == b[2], f"tol {tol}: plan differs")
        check(a[0].tobytes() == b[0].tobytes(),
              f"tol {tol}: card and CPU reconstructions differ")
    print(f"card == CPU on (64, 128, 128): {len(blobs['cpu'])} wire bytes, "
          f"3 tolerances bit-identical", flush=True)


# ---------------------------------------------------------------- phase 7 --

def qoi_phase(torch, bp):
    """Algorithm 3 over Isabel's three velocity components, at full size."""
    from repro_torch.core import lossless_batch as lb
    from repro_torch.core import qoi as qq
    from repro_torch.core import refactor as rf
    from repro_torch.core import retrieve as rt
    from repro_torch.data.fields import velocity_field

    t0 = time.perf_counter()
    vs = velocity_field(ISABEL_SHAPE, seed=0)
    print(f"velocity field 3 x {ISABEL_SHAPE}: "
          f"{time.perf_counter() - t0:.2f} s to make", flush=True)
    bp.reset_launches()
    t0 = time.perf_counter()
    refs = [rf.refactor_array(v, n, design="locality", device="cuda")
            for v, n in zip(vs, "UVW")]
    torch.cuda.synchronize()
    t_write = time.perf_counter() - t0
    wire = [len(rf.refactored_to_bytes(r)) for r in refs]
    print(f"refactor U, V, W (locality, first call): {t_write:.3f} s, "
          f"{3 * vs[0].nbytes / t_write / 1e9:.3f} GB/s, wire bytes {wire}",
          flush=True)
    shuf = rf.refactor_array(vs[0], "U", design="shuffle", device="cuda")
    check(shuf.design == "shuffle", "shuffle blob names another design")
    for pa, pb in zip(refs[0].pieces, shuf.pieces):
        for sa, sb in zip((pa.sign_seg, *pa.groups),
                          (pb.sign_seg, *pb.groups)):
            check(sa.to_bytes() == sb.to_bytes(),
                  "shuffle and locality segments differ")
    print("U refactored with shuffle: every segment byte-identical to "
          "locality's", flush=True)

    truth = sum(torch.from_numpy(v).cuda().double() ** 2 for v in vs)
    for method, kw in QOI_METHODS.items():
        readers = [rt.ProgressiveReader(r, device="cuda") for r in refs]
        cum = 0
        for tau in QOI_TAUS:
            t0 = time.perf_counter()
            with lb.stats_scope() as st:
                res = qq.progressive_qoi_retrieve(readers, qq.V_TOTAL, tau,
                                                  method=method, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = sum(torch.from_numpy(v).cuda().double() ** 2
                      for v in res.values)
            actual = (got - truth).abs().max().item()
            check(actual <= res.tau_estimated,
                  f"{method} tau {tau}: actual {actual} > estimate "
                  f"{res.tau_estimated}")
            check(not res.converged or res.tau_estimated <= tau,
                  f"{method} tau {tau}: converged above tau")
            total = sum(r.total_bytes_fetched for r in readers)
            check(total >= cum, f"{method}: cumulative bytes decreased")
            cum = total
            print(f"qoi {method} tau {tau:g}: {res.iterations} iterations, "
                  f"converged {res.converged}, bitrate {res.bitrate:.4f}, "
                  f"+{res.bytes_fetched} B (cumulative {cum} B), estimate "
                  f"{res.tau_estimated:.6g}, actual {actual:.6g}, "
                  f"{wall:.3f} s, {st.host_syncs / res.iterations:.2f} host "
                  f"syncs per iteration", flush=True)
    launches = read_launches(bp, ("loc_encode", "shuffle_encode",
                                  "loc_decode"), "QoI-path launches")

    small = velocity_field((48, 48, 48), seed=1)
    blobs = {d: [rf.refactored_to_bytes(rf.refactor_array(
        v, n, design="locality", device=d)) for v, n in zip(small, "UVW")]
        for d in ("cuda", "cpu")}
    check(blobs["cuda"] == blobs["cpu"], "card and CPU QoI blobs differ")
    for method, kw in QOI_METHODS.items():
        out = {}
        for d in ("cuda", "cpu"):
            readers = [rt.ProgressiveReader(rf.refactored_from_bytes(b),
                                            device=d) for b in blobs["cpu"]]
            out[d] = [qq.progressive_qoi_retrieve(readers, qq.V_TOTAL, tau,
                                                  method=method, **kw)
                      for tau in QOI_TAUS]
        for a, b in zip(out["cuda"], out["cpu"]):
            check((a.iterations, a.bytes_fetched, a.converged, a.eps_final,
                   a.tau_estimated, a.per_iteration)
                  == (b.iterations, b.bytes_fetched, b.converged,
                      b.eps_final, b.tau_estimated, b.per_iteration),
                  f"{method}: card and CPU QoI results differ")
            check(all(x.tobytes() == y.tobytes()
                      for x, y in zip(a.values, b.values)),
                  f"{method}: card and CPU QoI values differ")
    print("card == CPU on the (48, 48, 48) velocity field: cp, ma, mape "
          f"identical at tau {QOI_TAUS}", flush=True)
    return launches


# ---------------------------------------------------------------- phase 8 --

def print_spans(tr, what: str) -> None:
    """Total host wall per tracer span name (spans on the prefetch and
    feeder threads overlap the main thread's)."""
    spans = tr.summary()["spans"]
    print(f"{what} spans: " + ", ".join(
        f"{k} {v['count']}x {v['total_s']:.3f} s"
        for k, v in sorted(spans.items())), flush=True)


def pipeline_phase(torch, bp):
    """The chunked write and read pipelines on the NYX-shaped field."""
    from repro_torch.core import pipeline as pipe
    from repro_torch.data.fields import gaussian_field
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace

    t0 = time.perf_counter()
    x = gaussian_field(NYX_SHAPE, slope=-1.8, seed=0)
    print(f"field {NYX_SHAPE}: {time.perf_counter() - t0:.2f} s to make",
          flush=True)
    kw = dict(chunk_elems=PIPE_CHUNK, levels=PIPE_LEVELS, design="shuffle",
              use_tune_cache=False, device="cuda")
    bp.reset_launches()
    first = None
    for i, piped in enumerate((True, False, True, False)):
        w = pipe.ChunkedRefactorPipeline(pipelined=piped, **kw)
        with obs_metrics.REGISTRY.scope(), obs_trace.tracing() as tr:
            t0 = time.perf_counter()
            blobs = w.refactor(x, "nyx")
            wall = time.perf_counter() - t0
            gauges = obs_metrics.snapshot()["gauges"]
        if i == 2:
            print_spans(tr, "write pipelined (warm)")
        first = blobs if first is None else first
        check(len(blobs) == 8, f"{len(blobs)} chunks, not 8")
        check(blobs == first, "pipelined and serial chunk blobs differ")
        print(f"write {'pipelined' if piped else 'serial'}: {wall:.3f} s, "
              f"{x.nbytes / wall / 1e9:.3f} GB/s, "
              f"{sum(len(b) for b in blobs)} wire bytes, "
              f"write.syncs_per_chunk {gauges['write.syncs_per_chunk']}",
              flush=True)
    x_dev = torch.from_numpy(x.reshape(-1)).cuda()
    outs = {}
    for piped in (True, False):
        with obs_trace.tracing() as tr:
            t0 = time.perf_counter()
            outs[piped] = pipe.ChunkedReconstructPipeline(
                pipelined=piped, device="cuda").reconstruct(first, PIPE_TOL)
            wall = time.perf_counter() - t0
        print_spans(tr, f"read {'pipelined' if piped else 'serial'}")
        err = (torch.from_numpy(outs[piped]).cuda() - x_dev).abs().max()
        check(err.item() <= PIPE_TOL, f"read error {err.item()} > tol")
        print(f"read {'pipelined' if piped else 'serial'} tol {PIPE_TOL:g}: "
              f"{wall:.3f} s, max err {err.item():.6g}", flush=True)
    check(outs[True].tobytes() == outs[False].tobytes(),
          "pipelined and serial reads differ")
    launches = read_launches(bp, ("shuffle_encode", "loc_decode"),
                             "pipeline-path launches")

    # the kernels against their plain versions at the pipeline's own piece
    # shapes and batches: the plain backend on the card must write the same
    # chunk blobs and read the same values (these runs launch no kernel)
    t0 = time.perf_counter()
    plain = pipe.ChunkedRefactorPipeline(pipelined=True, backend="torch",
                                         **kw).refactor(x, "nyx")
    check(plain == first, "kernel and plain-version chunk blobs differ")
    plain_out = pipe.ChunkedReconstructPipeline(
        pipelined=True, backend="torch", device="cuda").reconstruct(
            first, PIPE_TOL)
    check(plain_out.tobytes() == outs[True].tobytes(),
          "kernel and plain-version reads differ")
    check(bp.encode_shuffle_cuda.launches == launches["shuffle_encode"]
          and bp.decode_locality_cuda.launches == launches["loc_decode"],
          "the plain backend launched a kernel")
    print("kernel == plain version on the card at the pipeline's shapes: "
          f"write blobs and read values identical "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)

    small = gaussian_field((64, 128, 128), slope=-1.8, seed=1)
    for design in ("locality", "shuffle"):
        got = {d: pipe.ChunkedRefactorPipeline(
            chunk_elems=1 << 18, design=design, use_tune_cache=False,
            device=d).refactor(small, "s") for d in ("cuda", "cpu")}
        check(got["cuda"] == got["cpu"],
              f"{design}: card and CPU chunk blobs differ")
    print("card == CPU chunk blobs on (64, 128, 128), locality and shuffle",
          flush=True)
    return launches


# ---------------------------------------------------------------- phase 9 --

STORE_TOLS = (1e-1, 1e-2, 1e-3, 1e-4, 1e-5)
STORE_QOI_TAU = 1e-3
STORE_NAMES = ("U", "V", "W")
STORE_BYTE_CACHE = 4 << 30      # the backend's byte cache: nothing is evicted
STORE_PLANE_CACHE = 16 << 30    # the tier's decoded plane cache, on the card


def _store_entry(root, name):
    """(manifest entry without its segment key, segment file bytes)."""
    from repro_torch.store import layout as lo
    with open(os.path.join(root, lo.MANIFEST_NAME)) as f:
        v = json.load(f)["variables"][name]
    with open(lo.segment_path(root, v.pop("segment_file")), "rb") as f:
        return v, f.read()


def _run_sessions(jobs, timeout=900):
    """Run ``jobs`` (name -> callable) on threads released together by one
    barrier; returns name -> result, and fails on any error or hang."""
    import threading
    from repro_torch.obs import trace as obs_trace
    barrier = threading.Barrier(len(jobs))
    out, errors = {}, []

    def run(name, fn):
        try:
            barrier.wait(timeout=timeout)
            out[name] = fn()
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(f"{name}: {exc!r}")
            barrier.abort()
    ts = [threading.Thread(target=obs_trace.wrap_for_thread(run), args=kv)
          for kv in jobs.items()]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    check(not any(t.is_alive() for t in ts), "a session thread hung")
    check(not errors, f"session errors: {errors}")
    return out


def store_phase(torch, bp, shape=ISABEL_SHAPE, device="cuda"):
    """The store and serving stack at full size: write Isabel's U, V, W
    with ``DatasetWriter``, open the store cold and serve 8 concurrent
    sessions through the shared serving tier; every result is held against
    a private (``serving=False``) service on the plain backend, and the
    card's write against a CPU write.  Returns the phase's launch counts."""
    import shutil
    root = os.path.join(REPO, "build", "store_smoke")
    shutil.rmtree(root, ignore_errors=True)
    try:
        return _store_phase(torch, bp, shape, device, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _store_phase(torch, bp, shape, device, root):
    import threading

    import numpy as np
    from repro_torch.core import qoi as qq
    from repro_torch.data.fields import velocity_field
    from repro_torch.obs import trace as obs_trace
    from repro_torch.store import (CachingBackend, DatasetStore,
                                   DatasetWriter, LocalFileBackend,
                                   RetrievalService)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def peak(what):
        """The phase's peak device memory so far (the stage that raises it
        is the one that sets the phase's peak)."""
        if device == "cuda":
            print(f"{what}: peak device memory so far "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
                  f"allocated", flush=True)

    vs = dict(zip(STORE_NAMES, velocity_field(shape, seed=0)))
    raw = sum(v.nbytes for v in vs.values())
    card, cpu = os.path.join(root, "card"), os.path.join(root, "cpu")
    launches = {}
    bp.reset_launches()
    t0 = time.perf_counter()
    with DatasetWriter(card, device=device) as w:
        entries = [w.write(n, vs[n]) for n in STORE_NAMES]
    sync()
    t_write = time.perf_counter() - t0
    stored = sum(e.stored_bytes for e in entries)
    print(f"store write U, V, W {shape} ({raw / 1e6:.1f} MB raw, "
          f"{len(entries[0].chunks)} chunks of 2**20 each): {t_write:.3f} s, "
          f"{raw / t_write / 1e9:.3f} GB/s, {stored / 1e6:.1f} MB stored",
          flush=True)
    launches["write"] = read_launches(bp, ("rb_encode",),
                                      "phase-9 write launches")
    peak("phase-9 write")

    # the shared tier: 8 sessions released together, two ladders per
    # variable (the second trails the first by one step after the first
    # step: coalesced claims at the start, plane-cache hits after) and two
    # QoI sessions over all three variables
    t0 = time.perf_counter()
    backend = CachingBackend(LocalFileBackend(card),
                             capacity_bytes=STORE_BYTE_CACHE)
    svc = RetrievalService(DatasetStore.open(card, backend=backend,
                                             device=device),
                           plane_cache_bytes=STORE_PLANE_CACHE)
    print(f"cold open: {time.perf_counter() - t0:.3f} s", flush=True)
    led = {n: [threading.Event() for _ in STORE_TOLS] for n in STORE_NAMES}

    def ladder(name, k, service, events=None):
        s = service.open_session()
        steps = []
        try:
            for i, tol in enumerate(STORE_TOLS):
                if events is not None and k == 1 and i > 0:
                    events[name][i].wait(timeout=900)
                t = time.perf_counter()
                x, bound, fetched = s.retrieve(name, tol, relative=True)
                steps.append((x, bound, fetched, time.perf_counter() - t))
                if events is not None and k == 0:
                    events[name][i].set()
        finally:
            if events is not None and k == 0:
                for e in events[name]:
                    e.set()
        return steps

    def qoi(service):
        t = time.perf_counter()
        res = service.open_session().retrieve_qoi(
            STORE_NAMES, qq.V_TOTAL, STORE_QOI_TAU, method="mape")
        return res, time.perf_counter() - t

    jobs = {(n, k): (lambda n=n, k=k: ladder(n, k, svc, led))
            for n in STORE_NAMES for k in (0, 1)}
    jobs.update({("qoi", k): (lambda: qoi(svc)) for k in (0, 1)})
    bp.reset_launches()
    t0 = time.perf_counter()
    with obs_trace.tracing() as tr:
        shared = _run_sessions(jobs)
        sync()
    t_serve = time.perf_counter() - t0
    launches["serve"] = read_launches(bp, ("rb_decode",),
                                      "phase-9 shared serving launches")
    peak("phase-9 shared serving")
    snap = svc.stats()
    tier, be = snap["serving"], snap["backend"]
    print(f"shared serving, 8 sessions: {t_serve:.3f} s wall", flush=True)
    print_spans(tr, "shared serving (summed over threads)")
    for (n, k) in sorted(k for k in shared if k[0] != "qoi"):
        print(f"  session {n}{k} steps: " + ", ".join(
            f"{tol:g} {st[3]:.3f} s +{st[2]} B"
            for tol, st in zip(STORE_TOLS, shared[(n, k)])), flush=True)
    for k in (0, 1):
        res, wall = shared[("qoi", k)]
        print(f"  session qoi{k}: mape tau {STORE_QOI_TAU:g}, {wall:.3f} s, "
              f"{res.iterations} iterations, +{res.bytes_fetched} B, "
              f"estimate {res.tau_estimated:.6g}", flush=True)
    print(f"tier: {json.dumps(tier)}")
    print(f"backend: fetches {be['fetches']}, hit rate {be['hit_rate']:.4f}, "
          f"{be['bytes_fetched']} B fetched, {be['bytes_served']} B served")
    check(tier["requests"] == tier["plane_hits"] + tier["coalesced"]
          + tier["decoded"], "tier claims do not add up")
    check(be["fetches"] == tier["decoded"] + 1,
          f"{be['fetches']} backend fetches for {tier['decoded']} decodes")
    check(tier["plane_hits"] > 0, "the trailing sessions hit no cached plane")
    check(tier["errors_propagated"] == 0, "the tier propagated an error")
    check(launches["serve"]["rb_decode"] < tier["decoded"],
          f"{launches['serve']['rb_decode']} rb_decode launches for "
          f"{tier['decoded']} decode jobs: no launch was shared")

    # the private service on the plain backend: one cold session per shared
    # ladder and one QoI session, each alone on its state, must give the
    # same bits, which holds every rb_decode bucket of the shared rounds
    # against the plain decode (this run launches no kernel)
    t0 = time.perf_counter()
    priv = RetrievalService(DatasetStore.open(card, device=device),
                            serving=False, backend="torch")
    pjobs = {(n, 0): (lambda n=n: ladder(n, 0, priv)) for n in STORE_NAMES}
    pjobs[("qoi", 0)] = lambda: qoi(priv)
    bp.reset_launches()
    with obs_trace.tracing() as tr:
        private = _run_sessions(pjobs)
        sync()
    launches["private"] = read_launches(bp, (),
                                        "phase-9 private serving launches")
    check(not any(launches["private"].values()),
          "the plain backend launched a kernel")
    peak("phase-9 private serving")
    print(f"private serving (serving=False, plain backend, 4 sessions): "
          f"{time.perf_counter() - t0:.3f} s wall", flush=True)
    print_spans(tr, "private serving (summed over threads)")
    t0 = time.perf_counter()
    for n in STORE_NAMES:
        truth = vs[n]
        for k in (0, 1):
            for tol, (x, bound, fetched, _), (px, pbound, pfetched, _) in zip(
                    STORE_TOLS, shared[(n, k)], private[(n, 0)]):
                check(x.shape == truth.shape and x.dtype == np.float32,
                      f"{n}{k} {tol}: shape {x.shape} {x.dtype}")
                check(x.tobytes() == px.tobytes()
                      and (bound, fetched) == (pbound, pfetched),
                      f"{n}{k} tol {tol}: shared and private results differ")
                err = float(np.abs(x - truth).max())
                check(err <= bound, f"{n}{k} tol {tol}: error {err} > "
                      f"bound {bound}")
    pres, _ = private[("qoi", 0)]
    want = sum(torch.from_numpy(vs[n]).to(device).double() ** 2
               for n in STORE_NAMES)
    for k in (0, 1):
        res, _ = shared[("qoi", k)]
        check((res.iterations, res.bytes_fetched, res.tau_estimated,
               res.converged) == (pres.iterations, pres.bytes_fetched,
                                  pres.tau_estimated, pres.converged)
              and all(a.tobytes() == b.tobytes()
                      for a, b in zip(res.values, pres.values)),
              f"qoi{k}: shared and private QoI results differ")
        got = sum(torch.from_numpy(v).to(device).double() ** 2
                  for v in res.values)
        actual = (got - want).abs().max().item()
        check(actual <= res.tau_estimated, f"qoi{k}: actual {actual} > "
              f"estimate {res.tau_estimated}")
        check(not res.converged or res.tau_estimated <= STORE_QOI_TAU,
              f"qoi{k}: converged above tau")
    print(f"shared == private (bits, bounds, bytes) at every step, errors "
          f"within bounds, QoI actual <= estimate: checked in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    peak("phase-9 checks")

    # one variable written again on the CPU, at full shape
    t0 = time.perf_counter()
    with DatasetWriter(cpu, device="cpu") as w:
        w.write("U", vs["U"])
    check(_store_entry(cpu, "U") == _store_entry(card, "U"),
          "card and CPU writes of U differ")
    print(f"CPU write of U {shape}: {time.perf_counter() - t0:.3f} s, "
          f"segment bytes and manifest entry identical to the card's",
          flush=True)
    return launches


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 6, the torch.profiler pass")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core import refactor as rf
    from repro_torch.core import retrieve as rt
    from repro_torch.core.refactor_fused import piece_sizes
    from repro_torch.data.fields import gaussian_field
    from repro_torch.kernels import bitplane as bp
    from repro_torch.kernels import ref

    t_all = time.perf_counter()
    t0 = phase("1 build and device")
    bp.load()
    info = bp.BUILD_INFO
    print(f"kernel build: {info['seconds']:.2f} s "
          f"({'built' if info['built'] else 'reused'} {info['path']})")
    for line in info["log"].splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print("  ptxas:", line.strip())
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    done(t0, "phase 1")

    t0 = phase("2 kernels vs plain, on the card")
    specs = kernel_specs(bp, ref)
    n_cases = kernels_vs_plain(torch, specs)
    print(f"{n_cases} kernel cases bit-exact with the plain versions")
    timings = kernel_timings(torch, specs)
    print_timings(timings)
    x = torch.randint(0, 2 ** MAG_BITS, (FINEST_N,), dtype=torch.int32,
                      device="cuda")
    copy_dst = torch.empty_like(x)
    copy_ms = time_ms(lambda: copy_dst.copy_(x))
    print(f"device copy of {4 * FINEST_N} B: {copy_ms * 1e3:.1f} us "
          f"({2 * 4 * FINEST_N / copy_ms / 1e6:.0f} GB/s read + write)")
    encode_sweep(torch, bp)
    # phase 8 runs shuffle_encode and loc_decode at its own piece sizes
    print_timings(kernel_timings(
        torch, specs, max(piece_sizes((PIPE_CHUNK,), PIPE_LEVELS))))
    done(t0, "phase 2")

    t0 = phase("3 main path at full size")
    x_np = gaussian_field(ISABEL_SHAPE, slope=-2.0, seed=0)
    print(f"field {ISABEL_SHAPE}: {time.perf_counter() - t0:.2f} s to make")
    launches, blob = main_path(torch, bp, rf, rt, x_np)
    launches = {k: launches[k] for k in ("rb_encode", "rb_decode")}
    done(t0, "phase 3")

    t0 = phase("4 card vs CPU")
    card_vs_cpu(torch, rf, rt, x_np)
    done(t0, "phase 4")

    t0 = phase("5 warm write and read")
    warm = warm_times(torch, rf, rt, x_np, blob)
    done(t0, "phase 5")

    if args.profile:
        t0 = phase("6 where the time goes (profiled)")
        profiled(torch, rf, rt, x_np, warm)
        done(t0, "phase 6")

    t0 = phase("7 QoI retrieval (Alg. 3), locality, at full size")
    launches.update({k: v for k, v in qoi_phase(torch, bp).items()
                     if k in ("loc_encode", "loc_decode")})
    done(t0, "phase 7")

    t0 = phase("8 chunked pipeline, shuffle, at full size")
    launches["shuffle_encode"] = pipeline_phase(torch, bp)["shuffle_encode"]
    done(t0, "phase 8")

    t0 = phase("9 store and serving at full size")
    p9 = store_phase(torch, bp)
    print(f"phase-9 launches: rb_encode {p9['write']['rb_encode']} (write), "
          f"rb_decode {p9['serve']['rb_decode']} (shared serving)",
          flush=True)
    done(t0, "phase 9")

    src = "src/repro_torch/kernels/csrc/bitplane.cu"
    entries = []
    for fmt, (_, _, encoders, decoder) in specs.items():
        for (name, _, replaces), case in (
                [(e, "encode 23 planes") for e in encoders]
                + [(decoder, "decode 4-plane group")]):
            r = timings[(name, case)]
            entries.append({"name": name, "route": "cuda", "source": src,
                            "replaces": replaces,
                            "launches": launches[name],
                            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                            "device_ms": r["device_ms"],
                            "plain_ms": r["plain_ms"],
                            "bound_ms": r["bound_ms"],
                            "bound_by": r["bound_by"], "library_ms": None})
    print(f"total wall {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
