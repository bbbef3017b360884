#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its main path on a GPU.

    python3 chip_smoke.py [--profile]

needs one CUDA card, ``nvcc`` and the checkout's ``src/repro_torch``; it
imports nothing of JAX and nothing of the JAX package.  Phases, in order
(any failure exits non-zero and prints no result):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` and print
   the build time and the card's name and power limit;
2. hold each kernel bit-exact against its plain torch version on the card
   (N in {1, 4095, 4097, 12289, 21875000}, P in {1, 23, 32}, batch
   {1, 3}, plane offsets {0, 4, 20}) and time kernel and plain version at
   the Hurricane-Isabel finest-piece shape (CUDA events, median);
3. refactor the full Isabel-shaped field (100, 500, 500) float32 on the card,
   serialize and deserialize it, and progressively retrieve it over the
   relative tolerances 1e-1 .. 1e-6, requiring max|x - x_hat| <= bound at
   every step and non-decreasing cumulative bytes; the kernels' launch
   counters are zeroed just before and read just after, and each must be
   > 0;
4. a (64, 128, 128) slice refactored on the card and on the CPU must give
   byte-identical wire blobs and bit-identical reconstructions at three
   tolerances;
5. warm write and read-ladder times (the warm blob must equal the first);
6. only with ``--profile``: the same write and ladder under
   ``torch.profiler``: stage wall times, device busy time, the bitplane
   kernels' device time and the top ops.  This takes about two minutes.

Then it prints the ``{"kernels": [...]}`` line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

ISABEL_SHAPE = (100, 500, 500)
FINEST_N = 21_875_000          # finest detail piece of the Isabel field
MAG_BITS = 23
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT32_OPS_PER_S = 16.7e12      # 132 SMs x 64 INT32 lanes x 1.98 GHz boost
TOLS = (1e-1, 1e-2, 1e-3, 1e-4, 1e-5, 1e-6)


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


def time_ms(fn, reps: int = 11, inner: int = 20, warmup: int = 10) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``inner`` calls,
    after ``warmup`` untimed calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / inner)
    return statistics.median(out)


def phase(name: str):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0: float, name: str) -> None:
    print(f"-- {name}: {time.perf_counter() - t0:.2f} s wall", flush=True)


# ---------------------------------------------------------------- phase 2 --

def kernels_vs_plain(torch, bp, ref):
    """Bit-exact comparisons on the card (these launches are not counted as
    main-path launches: the counters are reset before phase 3)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    n_cases = 0
    for n in (1, 4095, 4097, 12289, FINEST_N):
        for p in (1, 23, 32):
            for b in ((1,) if n == FINEST_N else (1, 3)):
                x = torch.randint(-2 ** 31, 2 ** 31, (b, n), generator=g,
                                  dtype=torch.int64, device="cuda"
                                  ).to(torch.int32)
                want = ref.encode(x, p)
                got = bp.encode_register_block_cuda(x, p)
                check(torch.equal(got, want), f"encode n={n} P={p} B={b}")
                n_cases += 1
                for off in sorted({min(o, p - 1) for o in (0, 4, 20)}):
                    for rows in sorted({1, min(4, p - off), p - off}):
                        pl = want[:, off:off + rows].contiguous()
                        dw = ref.decode(pl, p - off, n)
                        got = bp.decode_register_block_cuda(pl, p - off, n)
                        check(torch.equal(got, dw),
                              f"decode n={n} P={p} B={b} off={off} "
                              f"rows={rows}")
                        n_cases += 1
    torch.cuda.synchronize()
    return n_cases


def kernel_timings(torch, bp, ref):
    """Kernel vs plain time at the main path's finest-piece shapes."""
    x = torch.randint(0, 2 ** MAG_BITS, (1, FINEST_N), dtype=torch.int32,
                      device="cuda")
    planes = bp.encode_register_block_cuda(x, MAG_BITS)
    words = planes.shape[2]
    group = planes[:, :4].contiguous()
    rows = {}

    def enc_case(name, p):
        out = bp.encode_register_block_cuda(x, p)
        err = (out.to(torch.int64) - ref.encode(x, p).to(torch.int64)
               ).abs().max().item()
        nbytes = 4 * FINEST_N + 4 * p * words
        ops = 16 * 32 * words  # 5-stage butterfly on 32 words per lane
        rows[name] = dict(
            ms=time_ms(lambda: bp.encode_register_block_cuda(x, p)),
            plain_ms=time_ms(lambda: ref.encode(x, p), reps=3, inner=1,
                             warmup=1),
            bytes=nbytes, ops=ops, max_abs_err=err)

    def dec_case(name, pl, total):
        out = bp.decode_register_block_cuda(pl, total, FINEST_N)
        err = (out.to(torch.int64) - ref.decode(pl, total, FINEST_N)
               .to(torch.int64)).abs().max().item()
        nbytes = 4 * pl.shape[1] * words + 4 * FINEST_N
        ops = 16 * 32 * words
        rows[name] = dict(
            ms=time_ms(lambda: bp.decode_register_block_cuda(pl, total,
                                                             FINEST_N)),
            plain_ms=time_ms(lambda: ref.decode(pl, total, FINEST_N),
                             reps=3, inner=1, warmup=1),
            bytes=nbytes, ops=ops, max_abs_err=err)

    enc_case("encode 23 planes", MAG_BITS)
    enc_case("encode 1 sign plane", 1)
    dec_case("decode 4-plane group", group, MAG_BITS)
    dec_case("decode 23 planes", planes, MAG_BITS)
    copy_dst = torch.empty_like(x)
    copy_ms = time_ms(lambda: copy_dst.copy_(x))
    for r in rows.values():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / INT32_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return rows, copy_ms


# ---------------------------------------------------------------- phase 3 --

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
    launches = {"rb_encode": bp.encode_register_block_cuda.launches,
                "rb_decode": bp.decode_register_block_cuda.launches}
    print(f"main-path launches: {launches}", flush=True)
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")
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
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    done(t0, "phase 1")

    t0 = phase("2 kernels vs plain, on the card")
    n_cases = kernels_vs_plain(torch, bp, ref)
    print(f"{n_cases} kernel cases bit-exact with the plain version")
    timings, copy_ms = kernel_timings(torch, bp, ref)
    for name, r in timings.items():
        print(f"{name} (N={FINEST_N}): kernel {r['ms'] * 1e3:.1f} us, "
              f"plain {r['plain_ms'] * 1e3:.1f} us, bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}), "
              f"{r['bytes'] / r['ms'] / 1e6:.0f} GB/s")
    print(f"device copy of {4 * FINEST_N} B: {copy_ms * 1e3:.1f} us "
          f"({2 * 4 * FINEST_N / copy_ms / 1e6:.0f} GB/s read + write)")
    done(t0, "phase 2")

    t0 = phase("3 main path at full size")
    x_np = gaussian_field(ISABEL_SHAPE, slope=-2.0, seed=0)
    print(f"field {ISABEL_SHAPE}: {time.perf_counter() - t0:.2f} s to make")
    launches, blob = main_path(torch, bp, rf, rt, x_np)
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

    src = "src/repro_torch/kernels/csrc/bitplane.cu"
    entries = []
    for name, key, replaces in (
            ("rb_encode", "encode 23 planes",
             "src/repro/kernels/bitplane.py:74"),
            ("rb_decode", "decode 4-plane group",
             "src/repro/kernels/bitplane.py:96")):
        r = timings[key]
        entries.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
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
