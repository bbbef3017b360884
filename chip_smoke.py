#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its main path on a GPU.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --write-side SRC   # phase 21 (c) alone, SRC's port

needs one CUDA card, ``nvcc`` and the checkout's ``src/repro_torch``; it
imports nothing of JAX and nothing of the JAX package.  Phases, in order
(any failure exits non-zero and prints no result):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (every
   source at once) and print the build time and the card's name and power
   limit;
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

10. the sharded engines on a mesh that names the one card four times
   (``["cuda:0"] * 4``): phase 8's field written through
   ``ShardedRefactorPlan.refactor_chunks`` must give phase 8's blobs, and
   read through ``ShardedReconstructEngine.engine_for`` phase 8's values;
   ``encode_bitplanes_sharded``/``decode_bitplanes_sharded`` on an (8,
   2**24) batch must equal the batch ops for every design, and a batch of 6
   must raise.  This is the split path on one card, not several cards;
11. the autotuner: ``tune()`` at Isabel's shape with a fresh cache under
   ``build/tune_smoke/`` scores all 9 programs with the cost model
   (``tune.cost``: 9 finite, positive model seconds), probes the default
   and the 3 best-scored programs (at most 4, the default first), with
   each probe's model and measured seconds, calibrates the model's scale
   (finite, positive) on the default's probe, then probes 3
   ``dispatch_ahead`` and 3 ``depth`` values through the real pipelines,
   with no failed score or probe; the winner's probe is no slower than
   the default's, and a second call is a cache hit.  Then the chunk problem a
   pipeline looks up (chunks of 2**20, levels 2) is tuned, and a
   ``ChunkedRefactorPipeline`` with the cache on (``REPRO_TUNE_CACHE``)
   must pick its winner and write an explicit ``config=winner`` write's
   blobs;
12. the exact codec and checkpoints: a Miranda-shaped float64 field (256,
   384, 384) refactored on the card (two 32-plane limbs), serialized, and
   retrieved at relative errors 1e-2 .. 1e-12 (within each bound, bytes
   non-decreasing) and exactly (bit-exact); card == CPU on a slice; then
   one decoder layer of qwen2-7b at its published widths (233M values), in
   float32 and in bfloat16 (16 planes), saved with ``save`` and with
   ``AsyncCheckpointer`` under ``build/ckpt_smoke/``, loaded bit-exact, and
   loaded at rel 1e-2 (float32) / 1e-1 (bfloat16) within the bound;
13. serve, the LLM path (``repro_torch.models``, ``launch.driver``; plain
   torch, no kernel of its own): every arch at its SMOKE size, one
   ``tree_init`` on the CPU copied to the card, card against CPU (logits
   within 1e-4 of max|logit|, jamba's 1e-3; greedy tokens equal;
   prefill(x[:-1]) + decode_step(x[-1]) against forward(x); hubert's
   forward only); qwen2-7b at its published widths and full depth
   (``tree_init`` on the card, float32 weights, bfloat16 compute), batch 4,
   prompt 256, 32 new tokens with the weights held in bfloat16, then cast
   on every call, then the int8 KV cache: prefill s, ms/token against the
   weight + cache read bound, the caches' bytes, int8 against bfloat16
   (teacher-forced top-1 agreement, max relative logit difference), and
   decode against forward at the last position within 5e-2 of max|logit|;
   deepseek-v2-236b cut to its first 2 layers (dense + MoE, MLA) with 16
   new tokens; rwkv6-3b at full depth, with the ``ssm.scan`` loops' share
   of prefill.  Each model is freed before the next;
14. train (``repro_torch.train``): every arch at its SMOKE size, one
   ``tree_init`` on the CPU copied to the card, 4 ``Trainer`` steps of
   batch 2 x 16 with 8-plane error-feedback compression and checkpoints
   every 2 steps under ``build/train_smoke/`` on the card and on the CPU
   (step 1's loss within 1e-4 relative, jamba's 1e-3, the later steps'
   within 5e-3, jamba's 5e-2; each parameter within 2 x lr a step, their
   mean within 0.1 x lr, jamba's lr), and a card run crashed at step 2 and
   resumed bit-identical (params, AdamW state, EF residual) to the uncrashed one;
   then h2o-danube-3-4b at its published widths, depth cut from 24 to 2,
   4 steps of batch 2 x 4096 (AdamW lr 3e-4, bf16 compute, remat, float32
   params and state, 8-plane compression), each step's wall against its
   bound, the step-4 checkpoint's snapshot, save and load seconds with the
   ``ckpt.*`` spans (loaded bit-exact); a step's launches are the
   optimizer path's kernels' (``kernels/csrc/optim.cu``): ``ef_amax`` and
   ``ef_apply`` a leaf for ``ef_quantize``, ``adamw_update`` a leaf and
   one ``global_sumsq`` for the global norm, with no
   ``rb_encode``/``rb_decode`` (the checkpoint's only) and no call of a
   plain version (the plain bitplanes, ``ef_quantize``'s plane path,
   AdamW's ``_upd``, the norm's float64 chain); each of the three
   elementwise kernels bit-identical to its plain version on every
   gradient leaf (the 122.9M-value embedding's included; ``adamw_update``
   in float32 and in bfloat16 state), and ``global_sumsq`` over the 12
   gradient leaves and over special leaves (zeros, subnormals, squares
   past float32, bfloat16, empty, unaligned) the same bits on two calls,
   each leaf's sum within 1e-12 relative of the float64 chain's and the
   norm within one float32 ulp (the difference printed), timed with its
   bound, the chain and ``torch.nn.utils.get_total_norm`` beside it; the
   step's stages (loss and gradient, ``ef_quantize``, the global norm,
   the update; CUDA events) and wall with the kernels and without them
   (the eager path before them) in turns in one process, and
   ``torch._fused_adamw_`` over the same leaves; the two register_block
   kernels and the elementwise ones timed at the embedding's N
   (``torch._fused_adamw_`` beside ``adamw_update``); with ``--profile``,
   one more danube step under ``torch.profiler``;
15. the mesh-bound paths (``repro_torch.distributed``, ``launch.mesh``):
   a NCCL world of one rank and a (1, 1) ``('data', 'model')`` mesh.
   ``make_compressed_allreduce`` over vectors of the sizes of
   h2o-danube-3-4b/2's 12 gradient leaves (122,880,000 values the
   largest): the output equal to ``ef_quantize(x, 0)``'s q (its
   ``ef_amax``/``ef_apply`` kernels) and the residual to x - q and to its
   residual bit for bit, through ``rb_encode``/``rb_decode``
   (two launches of each a leaf) and equal to the plain path; qwen2-7b at
   its published widths and full depth (bf16 weights held) with
   ``cell_policy``'s decode_32k policy (a 32,768-deep, seq-sharded cache),
   batch 4 of the shape's 128, a 256-token prompt and 16 new tokens with
   ``seq_shard_decode`` against the plain decode at the same cache length:
   greedy tokens equal and logits bit-identical (at one rank the combine
   multiplies by ``exp(0)``), ms/token against the weight + cache read
   bound; one ``make_train_step`` step under the mesh for every smoke arch
   equal to the step without one bit for bit; a checkpoint saved under the
   mesh byte-identical to one saved without, restored bit-exact by
   ``load(shardings=)``.  With two or more cards it also runs the ``-k
   cards`` card tests (one NCCL rank per card, worlds of 2 and up to 4)
   but phase 16's;
16. sharded parameter and AdamW-state storage (``distributed/fsdp.py``,
   the step factories' ``shardings=``): a NCCL world of one rank and a
   (1, 1) mesh.  h2o-danube-3-4b at its published widths cut to 2 layers,
   phase 14's settings (batch 2 x 4096, bf16 compute, remat, AdamW lr
   3e-4): 4 ``make_train_step`` steps from blocks placed by
   ``train_shardings`` bit-identical (loss, parameters, m, v) to 4 steps
   on the whole tree, with both steps' walls, the bytes a rank stores and
   the parameter gathers' wire bytes (none at one rank); the policy
   leaves 'model' out of the batch axes, so the steps take the
   tensor-parallel path (``distributed/tp.py``), and ``WIRE``'s
   ``tp_all_reduce`` calls must equal the layer plan's (``tp_plan``: 7 a
   layer and 5 outside the stack a step), which shows that the path ran;
   qwen2-7b at its published widths and full depth served from blocks under
   ``partition_specs()`` (batch 4, prompt 256, 16 new tokens): greedy
   tokens equal and logits bit-identical to the plain decode.  With two or
   more cards it runs the ``fsdp`` card tests (h2o-danube-3-4b at full
   depth on four cards; danube/2 on 2 and 4 cards against one);
17. tensor-parallel compute over 'model' (``distributed/tp.py``: the
   layers on the blocks that 'model' cuts, the vocabulary-parallel
   embedding, head and loss; its training steps run in phase 16): a NCCL
   world of one rank and a (1, 1) mesh.  h2o-danube-3-4b at all 24 layers
   served from ``param_shardings(drop_fsdp=True)`` blocks (batch 4, prompt
   256, 16 new tokens, bf16 weights held): greedy tokens equal and logits
   bit-identical to the plain decode, ``tp_all_reduce`` 49 and
   ``tp_all_gather`` 1 a step.  With two or more cards it runs the ``tp``
   card tests (h2o-danube-3-4b at 24 layers trained and served on a (1, 4)
   mesh of four cards);
18. Mamba on its 'model' blocks and the scan layers: (a) a NCCL
   world of one rank and a (1, 1) mesh, jamba-v0.1-52b at its published
   widths cut to one 8-layer period (7 Mamba layers, 1 GQA, 4 MoE layers
   of 16 experts, vocabulary 65,536; bf16 weights held, the stacked leaves
   rescaled to their per-layer fan-in, finite logits that differ) served from
   ``param_shardings(drop_fsdp=True)`` blocks (batch 4, prompt 256, 16 new
   tokens): greedy tokens equal and logits bit-identical to the plain
   decode, ``WIRE``'s tp counts the layer plan's (``jamba_serve_plan``);
   (b) one Mamba layer at jamba's widths and one RWKV6 time mix at
   rwkv6-3b's, 1 x 4096 tokens, forward and backward through the scan
   kernels (the card's path) and through the loop (the dispatch patched
   for the comparison): the kernels' peak of requested bytes at or under
   the loop's recorded figures, both walls, and in float32 the gradients
   within 1e-4 of their largest.  With two or more cards it runs the ``jamba
   and cards`` card tests (one period on a (1, 4) mesh, served and
   trained);
19. the dispatched-op analysis (``launch/op_analysis.py``) and the cost
   model (``tune/cost.py``) against the card: (a) the fused write program
   of Isabel's chunk at the default config run under ``OpAnalysis`` on the
   card and counted by ``CostModel`` on ``meta``: FLOPs, bytes and every
   operator's count equal, the kernel operators equal to the launches, the
   byte bound at 3.35 TB/s no more than the measured wall (measured /
   predicted printed); (b) danube/2's train step (phase 14's settings, a
   NCCL world of one rank, a (1, 1) mesh) counted by ``dryrun.measure`` on
   ``meta`` and run on the card under ``OpAnalysis``: FLOPs and bytes
   within 1% (operators that dispatch differently listed), the allocator's
   peak within [0.80, 1.25] x the predicted arguments + temp bytes, and
   neither the FLOP bound (989 TFLOP/s) nor the byte bound above the wall;
   (c) one ``wkv6_bwd`` call at rwkv6-3b's widths and one
   ``mamba_scan_bwd`` call at jamba's, 1 x 4096, run right after the
   build (an allocator with no earlier phase's cached blocks): the
   allocator's peak rise over the call, in bytes requested, equal to
   ``OpAnalysis``'s temp bytes on ``meta`` (the outputs and the declared
   workspace), and in bytes allocated within 512 bytes an allocation of
   it;
20. the SSM scan kernels (``kernels/csrc/scan.cu``): (a) each of
   ``wkv6_fwd``, ``wkv6_bwd``, ``mamba_scan_fwd`` and ``mamba_scan_bwd``
   against its plain version at rwkv6-3b's widths (40 heads of 64) and
   jamba's (d_inner 8192, d_state 16), 1 x 4096 and 2 x 1, 63, 64, 200
   steps, Mamba's also at 1 x 4096 on jamba's (1, 4) block of 2048
   channels: final and kept states bit-identical (wkv6's at most 2 ulp),
   outputs within 1e-5 of max|out|, gradients within 1e-4 of their
   largest, two ``mamba_scan_bwd`` calls the same bits; each timed at
   1 x 4096 (wrapper, replayed graph, plain loop, bound), Mamba's at both
   widths, and ``mamba_scan_fwd`` at B x 4096, B = 2 and 4, at one and
   two states a thread (the same states at both); (b) their main paths,
   counters zeroed before each: rwkv6-3b
   cut to 4 layers and jamba's period without its MoE, 3
   ``make_train_step`` steps of 1 x 4096 each (losses finite and
   falling), and jamba's period prefilling 1 x 4096 (finite logits);
   launches = scanning layers x steps x passes (and ``adamw_update``
   parameter leaves x steps, ``global_sumsq`` one a step for each 64
   leaves, no other kernel); the event time of the scan
   calls in each step and in the prefill (CUDA events around each wrapper
   call: an upper bound on the kernels' device time) and its share of the
   wall; then one more warm training step of each under ``torch.profiler``:
   the scan kernels' own device time beside the events' bound;
21. the lossless codec's kernels (``kernels/csrc/lossless.cu``): (a)
   ``lossless_stats``, ``huffman_pack``, ``huffman_decode``, ``rle_scan``
   and ``rle_expand`` byte-identical to their plain passes at S in {1, 2, 31,
   4095, 4096, 4097, 32767, 32768, 32769, 65537}, B 1 and 3, and on
   buckets of many short rows, either side of the stats' tile rule and
   the pack's tickets of two and four chunks ((B, S) in {(64, 4096), (64,
   65537), (263, 16384), (264, 16384), (199, 16385), (400, 16384)}), five
   contents, and on groups taken from real writes (Isabel's finest-piece
   4-plane group and sign plane, phase 8's and phase 9's largest), timed
   there (wrapper, replayed graph past the L2, plain pass, bound,
   ``torch.bincount`` beside the histogram, ``torch.repeat_interleave``
   beside the expand; the pack's bound also with the whole cap written,
   the floor of a byte-identical output); the write side's kernels and
   ``rle_scan`` at most two device activities a call (the kernel, copy
   and memset nodes of a CUDA graph of one call), the pack with no
   bit-count pass and no row scan, the scan with no count kernel and no
   row scan; on those groups the read side's kernels also give the
   decode's walks over one call (chunks, none walked serially,
   synchronisation rounds), its device time at 32, 64, 128 and 256 lanes a
   chunk, the largest expand tile's share of the bytes, and each kernel's
   device activities a call (the expand's at most two); the edge cases and
   every engine decode of phases 3-12 walk no chunk serially; Isabel
   written and read with
   RLE forced (the RLE kernels' main path; the default picks none there),
   counters zeroed before, no plain pass, the blob ``backend="torch"``'s;
   (c) every ``lossless_stats`` and ``huffman_pack`` call of one phase-8
   pipelined write and of phase 9's store write recorded: their (B, S)
   spread, both kernels timed at phase 9's median bucket, and their calls
   replayed under ``torch.profiler``, the summed device time of their
   activities (memsets included) a phase and kernel, or their replayed
   graph's time where the profile holds nothing (``--write-side SRC``
   runs this part alone with the port under SRC, such as a parent tree's
   ``src``, to compare two trees on one card);
   (b) phase 3's write and ladder and phase 8's pipelined write and read
   with ``backend="torch"``, the kernels, the kernels, ``"torch"``: the
   same blobs and values, the walls, the ``encode.finish`` /
   ``encode.finish_many`` and ``codec.decode`` spans and each read's
   peak rise.

Phases 3, 7-12, 14, 15, 20 and 21 zero the launch counters before their
runs and require the kernels of their paths to have launched (3, 8, 9 and
12 the lossless kernels too, with no plain lossless pass on the card; 3
one launch a batch of each); the kernels line's ``launches`` is phase 3's
count for the ``register_block`` pair and the lossless kernels (RLE's:
phase 21's forced-RLE path), phase 14's danube/2 run's for the optimizer
kernels and phase 20 (b)'s for the scan kernels (phases 9's and 15's are
printed on lines of their own).  Each phase's wall and peak device
memory are printed at its end.
Then it prints the ``{"kernels": [...]}`` line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
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


def registration_cost(torch, bp, sizes=(4096, FINEST_N), p=MAG_BITS):
    """Each kernel called back to back three ways, 23 planes, at each of
    ``sizes``: through its wrapper (nothing observes the dispatcher, so it
    launches directly), through its dispatcher operator
    (``torch.ops.repro_torch.<name>``, the path a dispatch mode such as
    ``OpAnalysis`` sees), and through its launch function alone.  At 4096
    elements the host's time a call is what is timed.  Rows keyed (kernel,
    n): (wrapper, operator, direct) in ms."""
    rows = {}
    for n in sizes:
        x = torch.randint(0, 2 ** MAG_BITS, (1, n), dtype=torch.int32,
                          device="cuda")
        calls = []
        for name, fn in (("rb_encode", bp.encode_register_block_cuda),
                         ("loc_encode", bp.encode_locality_cuda),
                         ("shuffle_encode", bp.encode_shuffle_cuda)):
            calls.append((name, fn, (x, p)))
        for name, fn, enc in (
                ("rb_decode", bp.decode_register_block_cuda,
                 bp.encode_register_block_cuda),
                ("loc_decode", bp.decode_locality_cuda,
                 bp.encode_locality_cuda)):
            calls.append((name, fn, (enc(x, p), p, n)))
        for name, fn, args in calls:
            def via_op(name=name, args=args):
                with torch._C._AutoDispatchBelowADInplaceOrView():
                    return bp._OPS[name](*args)
            rows[(name, n)] = (time_ms(lambda: fn(*args)), time_ms(via_op),
                               time_ms(lambda: bp._LAUNCH[name](*args)))
    for (name, n), (wrap, op, direct) in rows.items():
        print(f"{name} (N={n}, 23 planes) back to back: wrapper "
              f"{wrap * 1e3:.2f} us ({(wrap - direct) * 1e3:+.2f} us over "
              f"the launch alone, {direct * 1e3:.2f} us); through the "
              f"dispatcher operator {op * 1e3:.2f} us "
              f"({(op - direct) * 1e3:+.2f} us)", flush=True)
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
    launches = bp.launches()
    print(f"{what}: {launches}", flush=True)
    for k in required:
        check(launches[k] > 0, f"kernel {k} was not launched ({what})")
    return launches


def main_path(torch, bp, rf, rt, x_np):
    from repro_torch.core import lossless_batch as lb
    x_dev = torch.from_numpy(x_np).to("cuda")
    batches = dict.fromkeys(("hist_batches", "huffman_pack_batches",
                             "rle_scan_batches", "huffman_unpack_batches",
                             "rle_expand_batches"), 0)
    plain = _PlainCalls(targets=_plain_lossless_targets())
    plain.__enter__()
    bp.reset_launches()
    t0 = time.perf_counter()
    with lb.stats_scope() as st:
        r = rf.refactor_array(x_np, "isabel", device="cuda")
    torch.cuda.synchronize()
    for k in batches:
        batches[k] += getattr(st, k)
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
        for k in batches:
            batches[k] += getattr(st, k)
        print(f"retrieve rel tol {tol:g}: {dt:.3f} s, bound {bound:.6g}, "
              f"max err {err:.6g}, +{fetched} B, cumulative {cum} B, "
              f"{st.host_syncs} host sync(s)", flush=True)
    plain.__exit__(None, None, None)
    launches = lossless_launches(
        bp, plain.n, ("rb_encode", "rb_decode", "lossless_stats",
                      "huffman_pack", "huffman_decode"), "main-path launches")
    # one launch a batch of each lossless pass: none ran another way
    for k, name in (("hist_batches", "lossless_stats"),
                    ("huffman_pack_batches", "huffman_pack"),
                    ("rle_scan_batches", "rle_scan"),
                    ("huffman_unpack_batches", "huffman_decode"),
                    ("rle_expand_batches", "rle_expand")):
        check(launches[name] == batches[k], f"{name}: {launches[name]} "
              f"launches for {batches[k]} {k}")
    print(f"main-path lossless batches {batches} == the kernels' launches; "
          f"no plain lossless pass", flush=True)
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


def _busy_ms(evs) -> float:
    """Device busy ms: the device-side events' time (kernels, copies,
    sets), the profiler's own buffer requests left out.  An op's self
    device time repeats its kernels' time, so ops are not summed."""
    from torch.autograd import DeviceType
    return sum(_dev_us(e) for e in evs if e.device_type == DeviceType.CUDA
               and e.key != "Activity Buffer Request") / 1e3


def _prof_report(prof, what: str, walls, n: int = 10) -> None:
    """Host walls of the profiler's start-up, the run and its exit; device
    busy ms (the profiler's own buffer requests left out); the bitplane
    kernels' device time; and the top ops by self CPU time."""
    evs = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    busy = _busy_ms(evs)
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
    plain = _PlainCalls(targets=_plain_lossless_targets())
    plain.__enter__()
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
    plain.__exit__(None, None, None)
    launches = lossless_launches(
        bp, plain.n, ("shuffle_encode", "loc_decode", "lossless_stats",
                      "huffman_pack", "huffman_decode"),
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
    check(bp.launches() == launches, "the plain backend launched a kernel")
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
    return launches, x, first, outs[True]


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
    on_card = ("lossless_stats", "huffman_pack") if device == "cuda" else ()
    bp.reset_launches()
    t0 = time.perf_counter()
    with _PlainCalls(targets=_plain_lossless_targets()) as plain, \
            DatasetWriter(card, device=device) as w:
        entries = [w.write(n, vs[n]) for n in STORE_NAMES]
    sync()
    t_write = time.perf_counter() - t0
    stored = sum(e.stored_bytes for e in entries)
    print(f"store write U, V, W {shape} ({raw / 1e6:.1f} MB raw, "
          f"{len(entries[0].chunks)} chunks of 2**20 each): {t_write:.3f} s, "
          f"{raw / t_write / 1e9:.3f} GB/s, {stored / 1e6:.1f} MB stored",
          flush=True)
    launches["write"] = lossless_launches(
        bp, plain if on_card else {}, ("rb_encode",) + on_card,
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
    with _PlainCalls(targets=_plain_lossless_targets()) as plain, \
            obs_trace.tracing() as tr:
        shared = _run_sessions(jobs)
        sync()
    t_serve = time.perf_counter() - t0
    launches["serve"] = lossless_launches(
        bp, plain if on_card else {},
        ("rb_decode",) + (("huffman_decode",) if on_card else ()),
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


# --------------------------------------------------------------- phase 10 --

ONE_CARD_MESH = ["cuda:0"] * 4


def sharded_phase(torch, bp, x, blobs, values):
    """Phase 8's write and read through the sharded engines on a mesh that
    names the one card four times, and the sharded kernel ops against the
    batch ops."""
    from repro_torch.core import refactor as rf
    from repro_torch.core import retrieve as rt
    from repro_torch.core import sharded as shd
    from repro_torch.kernels import ops

    flat = x.reshape(-1)
    chunks = [flat[i:i + PIPE_CHUNK] for i in range(0, flat.size, PIPE_CHUNK)]
    plan = shd.ShardedRefactorPlan(ONE_CARD_MESH, levels=PIPE_LEVELS,
                                   design="shuffle")
    bp.reset_launches()
    shd.STATS.reset()
    t0 = time.perf_counter()
    refs = plan.refactor_chunks(chunks, name="nyx")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = [rf.refactored_to_bytes(r) for r in refs]
    check(got == blobs, "sharded chunk blobs differ from phase 8's")
    snap = shd.STATS.snapshot()
    print(f"refactor_chunks on {len(ONE_CARD_MESH)} x cuda:0, {len(chunks)} "
          f"chunks: "
          f"{wall:.3f} s, {x.nbytes / wall / 1e9:.3f} GB/s, {snap['rounds']} "
          f"windows, dispatches by mesh entry "
          f"{snap['dispatches_by_device']}; blobs == phase 8's", flush=True)

    eng = shd.ShardedReconstructEngine(ONE_CARD_MESH)
    t0 = time.perf_counter()
    readers = []
    for ci, blob in enumerate(blobs):
        ref = rf.refactored_from_bytes(blob)
        reader = rt.ProgressiveReader(ref, device=eng.device_for(ci))
        reader.engine = eng.engine_for(ci, ref)
        reader.stage_retrieve(PIPE_TOL)
        readers.append(reader)
    eng.drain([r.engine for r in readers])
    out = torch.cat([r.reconstruct_device()[0].reshape(-1) for r in readers])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(out.cpu().numpy().tobytes() == values.tobytes(),
          "engine_for reads differ from phase 8's values")
    print(f"read through engine_for, one drain of {len(readers)} engines, tol "
          f"{PIPE_TOL:g}: {wall:.3f} s; values == phase 8's", flush=True)
    read_launches(bp, ("shuffle_encode", "loc_decode"),
                  "phase-10 sharded-engine launches")

    mags = torch.randint(0, 2 ** MAG_BITS, (8, PIPE_CHUNK), dtype=torch.int32,
                         device="cuda",
                         generator=torch.Generator(device="cuda"
                                                   ).manual_seed(10))
    bp.reset_launches()
    for design in ops.DESIGNS:
        want = ops.encode_bitplanes_batch(mags, MAG_BITS, design)
        blocks = ops.encode_bitplanes_sharded(mags, MAG_BITS, design,
                                              mesh=ONE_CARD_MESH)
        check(len(blocks) == 4 and torch.equal(torch.cat(blocks), want),
              f"{design}: sharded encode differs from the batch op")
        prefix = want[:, :8].contiguous()
        dec = ops.decode_bitplanes_sharded(prefix, MAG_BITS, PIPE_CHUNK,
                                           design, mesh=ONE_CARD_MESH)
        check(torch.equal(torch.cat(dec), ops.decode_bitplanes_batch(
            prefix, MAG_BITS, PIPE_CHUNK, design)),
            f"{design}: sharded decode differs from the batch op")
        del want, blocks, prefix, dec
    try:
        ops.encode_bitplanes_sharded(mags[:6], MAG_BITS, mesh=ONE_CARD_MESH)
    except ValueError as exc:
        print(f"a batch of 6 over 4 mesh entries raises: {exc}")
    else:
        raise SmokeFailure("a batch of 6 over 4 mesh entries did not raise")
    read_launches(bp, ("rb_encode", "rb_decode", "loc_encode",
                       "shuffle_encode", "loc_decode"),
                  "phase-10 sharded-op launches (batch ops and 4 blocks)")
    print("sharded ops == batch ops on (8, 2**24), 23 planes encoded, 8 "
          "decoded, all three designs.  This runs the split path on one card "
          "(4 mesh entries, all cuda:0); it says nothing of several cards.",
          flush=True)


# --------------------------------------------------------------- phase 11 --

TUNE_CHUNK = 1 << 20    # the chunk DatasetWriter writes by default


def _print_tune(r, what):
    print(f"{what}: {r.tune_s:.3f} s, winner {r.config.design} "
          f"group_size={r.config.group_size} dispatch_ahead="
          f"{r.config.dispatch_ahead} depth={r.config.depth}; model scale "
          f"{r.model_scale:.4g} (calibrated on the default's probe)",
          flush=True)
    model = dict(r.scores)
    for c, sec in r.probes:
        print(f"  probe {c.design}/group_size={c.group_size}: model "
              f"{model[c]:.6f} s (x scale {model[c] * r.model_scale:.4f} s), "
              f"measured {sec:.4f} s")
    for c, sec in r.dispatch_probes:
        print(f"  probe dispatch_ahead={c.dispatch_ahead}: {sec:.4f} s")
    for c, sec in r.depth_probes:
        print(f"  probe depth={c.depth}: {sec:.4f} s", flush=True)


def tune_phase(torch, bp, x_np):
    """``tune()`` at Isabel's shape with a fresh cache under ``build/``,
    then a pipeline with the cache on picks a tuned winner up."""
    import shutil
    root = os.path.join(REPO, "build", "tune_smoke")
    shutil.rmtree(root, ignore_errors=True)
    old = os.environ.get("REPRO_TUNE_CACHE")
    try:
        _tune_phase(torch, bp, x_np, root)
    finally:
        if old is None:
            os.environ.pop("REPRO_TUNE_CACHE", None)
        else:
            os.environ["REPRO_TUNE_CACHE"] = old
        shutil.rmtree(root, ignore_errors=True)


def _tune_phase(torch, bp, x_np, root):
    from repro_torch.core import pipeline as pipe
    from repro_torch.tune import cache as tcache
    from repro_torch.tune import search as ts

    ts.STATS.reset()
    bp.reset_launches()
    r = ts.tune(ISABEL_SHAPE, cache_root=root)
    _print_tune(r, f"tune {ISABEL_SHAPE} float32 (levels auto)")
    st = ts.STATS.snapshot()
    print(f"tuner stats: {st}; failures {list(r.failures)}", flush=True)
    check(st["probes_failed"] == 0 and st["scores_failed"] == 0
          and not r.failures, f"{st['scores_failed']} scores and "
          f"{st['probes_failed']} tuner probes failed: {r.failures}")
    check(len(r.scores) == 9 and all(math.isfinite(sec) and sec > 0
                                     for _, sec in r.scores),
          f"model scores: {[sec for _, sec in r.scores]}")
    check(math.isfinite(r.model_scale) and r.model_scale > 0,
          f"model scale {r.model_scale}")
    check(not r.cache_hit and 1 <= len(r.probes) <= 4
          and r.probes[0][0].design == "register_block"
          and r.probes[0][0].group_size == 4, "the default did not head "
          "at most 4 program probes")
    check(len(r.dispatch_probes) == 3 and len(r.depth_probes) == 3,
          "the pipeline knobs were not probed")
    best, win = min(r.probes, key=lambda cs: cs[1])
    check((best.design, best.group_size)
          == (r.config.design, r.config.group_size),
          "the winner is not the fastest program probe")
    check(win <= r.probes[0][1], f"winner {win} s slower than the default "
          f"{r.probes[0][1]} s")
    print(f"winner's program probe {win:.4f} s <= default's "
          f"{r.probes[0][1]:.4f} s", flush=True)
    # each probed design's encoder ran in the program probes; the read
    # probes decode the winner's design
    encoders = {"register_block": "rb_encode", "locality": "loc_encode",
                "shuffle": "shuffle_encode"}
    read_launches(bp, {encoders[c.design] for c, _ in r.probes} | {
        "rb_decode" if r.config.design == "register_block"
        else "loc_decode"}, "phase-11 launches")
    r2 = ts.tune(ISABEL_SHAPE, cache_root=root)
    check(r2.cache_hit and r2.config == r.config
          and ts.STATS.snapshot()["searches"] == st["searches"],
          "the second tune() call was not a cache hit")
    print(f"second tune(): cache hit in {r2.tune_s * 1e3:.2f} ms, searches "
          f"unchanged ({st['searches']})", flush=True)

    # the pipelines look the cache up by their chunk shape and levels: tune
    # that problem (Isabel written in DatasetWriter's default chunks), then
    # a pipeline with the cache on must pick its winner up
    rc = ts.tune((TUNE_CHUNK,), levels=PIPE_LEVELS, cache_root=root)
    _print_tune(rc, f"tune ({TUNE_CHUNK},) float32 levels {PIPE_LEVELS}")
    check(ts.STATS.snapshot()["probes_failed"] == 0,
          "chunk-problem tuner probes failed")
    os.environ["REPRO_TUNE_CACHE"] = root
    tcache.invalidate_memo()
    hits = tcache.STATS.snapshot()["hits"]
    cached = pipe.ChunkedRefactorPipeline(chunk_elems=TUNE_CHUNK,
                                          levels=PIPE_LEVELS, device="cuda")
    check(tcache.STATS.snapshot()["hits"] == hits + 1
          and cached.config == rc.config.replace(chunk_elems=TUNE_CHUNK),
          "the pipeline did not pick the cached winner")
    t0 = time.perf_counter()
    blobs = cached.refactor(x_np, "isabel")
    wall = time.perf_counter() - t0
    explicit = pipe.ChunkedRefactorPipeline(
        chunk_elems=TUNE_CHUNK, levels=PIPE_LEVELS, config=rc.config,
        use_tune_cache=False, device="cuda").refactor(x_np, "isabel")
    check(blobs == explicit, "tune-cache and config=winner blobs differ")
    print(f"pipeline with the tune cache on: picked the winner, {len(blobs)} "
          f"chunks in {wall:.3f} s, blobs == a config=winner write",
          flush=True)


# --------------------------------------------------------------- phase 12 --

MIRANDA_SHAPE = (256, 384, 384)    # data.fields.DATASETS["miranda"]
EXACT_RELS = (1e-2, 1e-4, 1e-8, 1e-12, None)
# one decoder layer of qwen2-7b (src/repro/configs/qwen2_7b.py: d_model
# 3584, 28 heads, 4 KV heads of 128, d_ff 18944, QKV bias), leaves named as
# src/repro/models/layers.py gqa_abstract / mlp_abstract and
# src/repro/models/transformer.py block_abstract name them
QWEN_D, QWEN_H, QWEN_KV, QWEN_DH, QWEN_FF = 3584, 28, 4, 128, 18944


def qwen_layer(torch, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def leaf(*shape):
        return (0.02 * torch.randn(shape, generator=g, device="cuda")
                ).to(dtype)
    d, h, kv, dh, ff = QWEN_D, QWEN_H, QWEN_KV, QWEN_DH, QWEN_FF
    return {"norm1": leaf(d), "norm2": leaf(d),
            "attn": {"wq": leaf(d, h, dh), "wk": leaf(d, kv, dh),
                     "wv": leaf(d, kv, dh), "wo": leaf(h, dh, d),
                     "bq": leaf(h, dh), "bk": leaf(kv, dh),
                     "bv": leaf(kv, dh)},
            "mlp": {"w1": leaf(d, ff), "w3": leaf(d, ff), "w2": leaf(ff, d)}}


def _max_rel(torch, out, x):
    """Largest |out - x| / |x| over x != 0 (float64 on the card); a zero
    must come back as zero."""
    a, b = out.double().reshape(-1), x.double().reshape(-1)
    nz = b != 0
    check(bool((a[~nz] == 0).all()), "a zero came back non-zero")
    return ((a[nz] - b[nz]).abs() / b[nz].abs()).max().item() \
        if bool(nz.any()) else 0.0


def ckpt_phase(torch, bp):
    import shutil
    root = os.path.join(REPO, "build", "ckpt_smoke")
    shutil.rmtree(root, ignore_errors=True)
    try:
        miranda_phase(torch, bp)
        # bfloat16 at 1e-1 needs 13 of its 16 planes, so every 4-plane
        # group; at 0.125 it needs 12, so 3 of the 4 groups
        for dtype, rels in ((torch.float32, (1e-2,)),
                            (torch.bfloat16, (1e-1, 0.125))):
            checkpoint_phase(torch, bp, root, dtype, rels)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def miranda_phase(torch, bp):
    import numpy as np
    from repro_torch.ckpt import bitcast_codec as bc
    from repro_torch.data.fields import gaussian_field
    from repro_torch.obs import trace as obs_trace

    t0 = time.perf_counter()
    x = gaussian_field(MIRANDA_SHAPE, slope=-3.0, seed=0, dtype=np.float64)
    print(f"Miranda-shaped field {MIRANDA_SHAPE} float64 ({x.nbytes / 1e6:.1f}"
          f" MB): {time.perf_counter() - t0:.2f} s to make", flush=True)
    x_dev = torch.from_numpy(x).cuda()
    bp.reset_launches()
    plain = _PlainCalls(targets=_plain_lossless_targets())
    plain.__enter__()
    with obs_trace.tracing() as tr:
        t0 = time.perf_counter()
        r = bc.exact_refactor(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print_spans(tr, "exact_refactor")
    blob = bc.exact_to_bytes(r)
    r2 = bc.exact_from_bytes(blob)
    check(bc.exact_to_bytes(r2) == blob, "codec blob does not round-trip")
    print(f"exact_refactor on the card: {wall:.3f} s, "
          f"{x.nbytes / wall / 1e9:.3f} GB/s, {len(blob)} bytes (ratio "
          f"{x.nbytes / len(blob):.3f}), {len(r.groups)} groups of "
          f"{r.group_planes[0]} planes, {r.groups[0].meta['n_words']} words "
          f"a plane", flush=True)
    prev = 0
    for rel in EXACT_RELS:
        with obs_trace.tracing() as tr:
            t0 = time.perf_counter()
            out, nb = bc.exact_retrieve(r2, rel)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print_spans(tr, f"exact_retrieve rel {rel}")
        check(out.dtype == torch.float64 and tuple(out.shape) == MIRANDA_SHAPE
              and out.device.type == "cuda", f"rel {rel}: {out.dtype} "
              f"{tuple(out.shape)} on {out.device}")
        check(nb >= prev, f"rel {rel}: bytes decreased")
        prev = nb
        if rel is None:
            check(torch.equal(out.view(torch.int64), x_dev.view(torch.int64)),
                  "the full retrieve is not bit-exact")
            err = 0.0
        else:
            err = _max_rel(torch, out, x_dev)
            check(err <= rel, f"rel {rel}: max relative error {err}")
        print(f"exact_retrieve rel {rel}: {wall:.3f} s, {nb} bytes "
              f"({nb / len(blob):.3f} of the blob), max relative error "
              f"{err:.3g}{' (bit-exact)' if rel is None else ''}", flush=True)
    plain.__exit__(None, None, None)
    lossless_launches(bp, plain.n, ("rb_encode", "rb_decode", "huffman_pack",
                                    "huffman_decode"),
                      "phase-12 Miranda launches (32-plane limbs)")
    xs = x[:64, :96, :96].copy()
    check(bc.exact_to_bytes(bc.exact_refactor(xs)) ==
          bc.exact_to_bytes(bc.exact_refactor(xs, device="cpu")),
          "card and CPU codec blobs differ on the (64, 96, 96) slice")
    print("card == CPU codec blob on the (64, 96, 96) float64 slice",
          flush=True)


def _groups_for(name, rel, group_size=4):
    """(plane groups a load at ``rel`` needs, groups in all) for a dtype:
    the sign and exponent planes plus ceil(-log2 rel) mantissa planes."""
    from repro_torch.ckpt import bitcast_codec as bc
    fmt = bc._FMT[name]
    planes = min(1 + fmt["n_exp"] + max(math.ceil(-math.log2(rel)), 0),
                 fmt["bits"])
    return -(-planes // group_size), fmt["bits"] // group_size


def checkpoint_phase(torch, bp, root, dtype, rels):
    from repro_torch.ckpt import manager as ck
    from repro_torch.obs import trace as obs_trace

    name = str(dtype).rsplit(".", 1)[-1]
    tree = qwen_layer(torch, dtype)
    leaves = [v for _, v in ck._paths(tree)]
    raw = sum(t.numel() * t.element_size() for t in leaves)
    print(f"qwen2-7b layer tree, {name}: {len(leaves)} leaves, "
          f"{sum(t.numel() for t in leaves)} values, {raw / 1e9:.3f} GB",
          flush=True)
    bp.reset_launches()
    torch.cuda.synchronize()
    with obs_trace.tracing() as tr:
        t0 = time.perf_counter()
        ck.save(os.path.join(root, name), 1, tree)
        wall = time.perf_counter() - t0
    print_spans(tr, f"save ({name})")
    with open(os.path.join(root, name, "step_00000001",
                           "manifest.json")) as f:
        man = json.load(f)["leaves"]
    stored = sum(e["stored_bytes"] for e in man.values())
    check(man["attn.bk"]["codec"] == man["attn.bv"]["codec"] == "raw"
          and man["mlp.w1"]["codec"] == "mdr", "codec choice per leaf")
    print(f"save ({name}): {wall:.3f} s, {raw / wall / 1e9:.3f} GB/s, "
          f"{stored / 1e9:.3f} GB stored (ratio {raw / stored:.3f})",
          flush=True)
    t0 = time.perf_counter()
    a = ck.AsyncCheckpointer(os.path.join(root, name + "_async"))
    a.save(2, tree)
    t_snap = time.perf_counter() - t0
    a.wait()
    wall = time.perf_counter() - t0
    check(ck.latest_step(os.path.join(root, name + "_async")) == 2,
          "the async checkpoint is not the latest step")
    print(f"AsyncCheckpointer ({name}): save() returned in {t_snap:.3f} s "
          f"(host snapshot), done in {wall:.3f} s, "
          f"{raw / wall / 1e9:.3f} GB/s", flush=True)
    fracs = {}
    for where, r in (("", None), ("_async", None)) + tuple(
            ("", rel) for rel in rels):
        torch.cuda.synchronize()
        with obs_trace.tracing() as tr:
            t0 = time.perf_counter()
            out, st = ck.load(os.path.join(root, name + where),
                              2 if where else 1, tree, rel_error=r)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if not where:
            print_spans(tr, f"load ({name}, rel {r})")
        got = [v for _, v in ck._paths(out)]
        worst = 0.0
        for (path, want), g in zip(ck._paths(tree), got):
            check(g.dtype == want.dtype and g.shape == want.shape
                  and g.device.type == "cuda", f"leaf {path}")
            if r is None:
                check(torch.equal(g.view(torch.int16 if dtype ==
                                         torch.bfloat16 else torch.int32),
                                  want.view(torch.int16 if dtype ==
                                            torch.bfloat16 else torch.int32)),
                      f"leaf {path} is not bit-exact")
            else:
                worst = max(worst, _max_rel(torch, g, want))
        if r is not None:
            check(worst <= r, f"{name} rel {r}: max relative error {worst}")
            check(st["read_fraction"] < 1, f"{name} rel {r}: read all")
            need, total = _groups_for(name, r)
            check((st["read_fraction"] < fracs[("", None)])
                  == (need < total), f"{name} rel {r}: needs {need} of "
                  f"{total} groups, read_fraction {st['read_fraction']}")
        fracs[(where, r)] = st["read_fraction"]
        print(f"load{where or ''} ({name}, rel {r}): {wall:.3f} s, "
              f"{raw / wall / 1e9:.3f} GB/s, read_fraction "
              f"{st['read_fraction']:.4f}, "
              + ("every leaf bit-exact" if r is None else
                 f"max relative error {worst:.3g}"), flush=True)
    planes = 32 if dtype == torch.float32 else 16
    read_launches(bp, ("rb_encode", "rb_decode"),
                  f"phase-12 {name} checkpoint launches ({planes}-plane "
                  f"bitplanes)")


# --------------------------------------------------------------- phase 13 --

# card against CPU at the smoke sizes (float32 compute, TF32 off), relative
# to max|logit|; jamba's smoke Mamba state reaches 1e7 and its float32
# rounding differences grow through 8 layers
SMOKE_TOL = {"jamba-v0.1-52b": 1e-3}
# qwen2-7b, bfloat16 compute over 28 layers: prefill(x[:-1]) +
# decode_step(x[-1]) against forward(x) at the last position, relative to
# max|logit| (two different bfloat16 paths to the same logits)
FULL_TOL = 5e-2
SERVE_BATCH, SERVE_PROMPT = 4, 256


def _rel(torch, a, b):
    a, b = a.double(), b.double().to(a.device)
    return ((a - b).abs().max() / a.abs().max()).item()


def _tree_bytes(tree, skip=("embed",)):
    """Bytes of a tree's leaves, the embedding table left out (a decode
    step gathers B of its rows)."""
    total = 0
    for k, v in tree.items():
        if isinstance(v, dict):
            total += _tree_bytes(v, ())
        elif k not in skip:
            total += v.numel() * v.element_size()
    return total


def _cache_bytes(model, batch, max_len):
    from repro_torch.models.params import tree_leaves
    return sum(t.numel() * t.element_size() for t in
               tree_leaves(model.init_cache_structs(batch, max_len)))


def _free(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def smoke_archs(torch):
    """Every arch at its SMOKE size: one tree_init on the CPU copied to the
    card; logits, greedy tokens and prefill + decode against forward."""
    from repro_torch.configs.base import list_archs, smoke_config
    from repro_torch.launch import driver
    from repro_torch.models.model import Model
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    for arch in list_archs():
        cfg = smoke_config(arch)
        tol = SMOKE_TOL.get(arch, 1e-4)
        cpu = Model(cfg, device="cpu", seed=0)
        card = Model(cfg, cpu.params, device="cuda")
        with torch.inference_mode():
            if cfg.encoder_only:
                emb = torch.randn(2, 24, cfg.d_model,
                                  generator=torch.Generator().manual_seed(1))
                a = cpu.forward(None, embeds=emb)
                b = card.forward(None, embeds=emb.cuda())
                err = _rel(torch, a, b)
                check(err <= tol and bool(torch.isfinite(b).all()),
                      f"{arch}: card forward off by {err}")
                print(f"{arch}: forward card vs CPU {err:.2e} (<= {tol:g})",
                      flush=True)
                continue
            toks, vis = driver.build_inputs(cfg, 2, 24, seed=1, device="cpu")
            vis_c = None if vis is None else vis.cuda()
            full = card.forward(None, tokens=toks.cuda(), vision_states=vis_c)
            err = _rel(torch, cpu.forward(None, tokens=toks,
                                          vision_states=vis), full)
            _, cache = card.prefill(None, tokens=toks[:, :-1].cuda(),
                                    vision_states=vis_c, max_len=28)
            out, _ = card.decode_step(None, cache, 23, toks[:, -1:].cuda(),
                                      vision_states=vis_c)
            dec = _rel(torch, full[:, -1], out[:, 0])
        a = driver.greedy_decode(cpu, None, toks[:, :8], 6, vis)
        b = driver.greedy_decode(card, card.compute_params(),
                                 toks[:, :8].cuda(), 6, vis_c)
        gl = _rel(torch, a.logits, b.logits)
        check(err <= tol and dec <= tol and gl <= tol,
              f"{arch}: card vs CPU {err}, decode vs forward {dec}, "
              f"greedy logits {gl} (tolerance {tol})")
        check(torch.equal(a.tokens, b.tokens.cpu()),
              f"{arch}: greedy tokens differ between card and CPU")
        print(f"{arch}: forward card vs CPU {err:.2e}, decode vs forward "
              f"{dec:.2e}, greedy logits {gl:.2e} (<= {tol:g}); tokens "
              f"equal", flush=True)


def _serve(torch, model, params, what, new_tokens, warm=True):
    """Greedy-serve the phase's prompts (one warm-up call first): prints
    prefill s, ms/token and the weight + cache read bound."""
    from repro_torch.launch import driver
    cfg = model.cfg
    prompts, _ = driver.build_inputs(cfg, SERVE_BATCH, SERVE_PROMPT, seed=1,
                                     device="cuda")
    if warm:
        driver.greedy_decode(model, params, prompts, 3)
    res = driver.greedy_decode(model, params, prompts, new_tokens)
    check(tuple(res.tokens.shape) == (SERVE_BATCH, new_tokens)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all())
          and bool(torch.isfinite(res.logits).all()),
          f"{what}: tokens or logits out of range")
    w = _tree_bytes(params if params is not None else model.params)
    c = _cache_bytes(model, SERVE_BATCH, SERVE_PROMPT + new_tokens)
    bound_ms = (w + c) / HBM_BYTES_PER_S * 1e3
    print(f"{what}: prefill {res.prefill_s:.4f} s (batch {SERVE_BATCH} x "
          f"{SERVE_PROMPT}), {new_tokens - 1} decode steps "
          f"{res.ms_per_token:.3f} ms/token; bound {bound_ms:.3f} ms/token "
          f"({w / 1e9:.3f} GB of weights + {c / 1e9:.4f} GB of cache over "
          f"3.35 TB/s), {bound_ms / res.ms_per_token:.2f} of it", flush=True)
    return res, prompts


def qwen_full(torch, profile=False):
    """qwen2-7b at its published widths and full depth; with ``profile``,
    a torch.profiler pass over its decode steps."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model, count_params
    cfg = get_config("qwen2-7b")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    fp32 = _tree_bytes(model.params, ())
    t0 = time.perf_counter()
    held = model.compute_params()
    torch.cuda.synchronize()
    print(f"qwen2-7b: {cfg.n_layers} layers, {count_params(cfg)} params, "
          f"float32 {fp32 / 1e9:.3f} GB, tree_init on the card "
          f"{t_init:.3f} s; bfloat16 copy {_tree_bytes(held, ()) / 1e9:.3f}"
          f" GB in {time.perf_counter() - t0:.3f} s", flush=True)
    res, prompts = _serve(torch, model, held, "qwen2-7b bf16 cache, held "
                          "bf16 weights", 32)
    _serve(torch, model, None, "qwen2-7b bf16 cache, float32 weights cast "
           "on every call", 32, warm=False)

    cfg8 = dataclasses.replace(cfg, kv_cache_int8_scale=8.0)
    m8 = Model(cfg8, model.params, device="cuda")   # the same tensors
    res8, _ = _serve(torch, m8, held, "qwen2-7b int8 cache, held bf16 "
                     "weights", 32)
    b16 = _cache_bytes(model, SERVE_BATCH, SERVE_PROMPT + 32)
    b8 = _cache_bytes(m8, SERVE_BATCH, SERVE_PROMPT + 32)
    print(f"KV cache at {SERVE_PROMPT + 32} positions: int8 {b8} B "
          f"(codes + bf16 scales) vs bf16 {b16} B, {b8 / b16:.4f}",
          flush=True)
    # the int8 cache fed the bf16 run's tokens (teacher-forced): both runs'
    # logits at the same 32 positions
    with torch.inference_mode():
        logits, cache = m8.prefill(held, tokens=prompts,
                                   max_len=SERVE_PROMPT + 32)
        steps = [logits[:, -1]]
        for i in range(31):
            logits, cache = m8.decode_step(held, cache, SERVE_PROMPT + i,
                                           res.tokens[:, i:i + 1])
            steps.append(logits[:, -1])
        l8 = torch.stack(steps, dim=1)
    agree = (l8.argmax(-1) == res.tokens).float().mean().item()
    rel = _rel(torch, res.logits, l8)
    check(math.isfinite(rel) and agree > 0, "int8 cache logits")
    print(f"int8 vs bf16 cache over 32 steps (teacher-forced): top-1 "
          f"agreement {agree:.4f}, max relative logit difference {rel:.4f}; "
          f"free-running tokens equal on "
          f"{(res8.tokens == res.tokens).float().mean().item():.4f}",
          flush=True)
    with torch.inference_mode():
        full = model.forward(held, tokens=prompts)
        _, cache = model.prefill(held, tokens=prompts[:, :-1],
                                 max_len=SERVE_PROMPT)
        out, _ = model.decode_step(held, cache, SERVE_PROMPT - 1,
                                   prompts[:, -1:])
        err = _rel(torch, full[:, -1], out[:, 0])
        agree = (full[:, -1].argmax(-1) == out[:, 0].argmax(-1)
                 ).float().mean().item()
    check(err <= FULL_TOL, f"qwen2-7b: decode vs forward at the last "
          f"position {err} > {FULL_TOL}")
    print(f"qwen2-7b decode vs forward at position {SERVE_PROMPT - 1}: "
          f"{err:.4f} of max|logit| (<= {FULL_TOL:g}), argmax equal on "
          f"{agree:.2f}", flush=True)
    print(f"qwen2-7b peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB", flush=True)
    if profile:
        _profile_decode(torch, model, held, prompts)


def _profile_decode(torch, model, params, prompts, n=4):
    """``n`` decode steps under torch.profiler: wall and device busy time a
    step, the device's idle share, kernel launches a step and the top ops
    by self CPU time."""
    with torch.inference_mode():
        _, cache = model.prefill(params, tokens=prompts,
                                 max_len=SERVE_PROMPT + n)
        tok = prompts[:, -1:]

        def steps():
            for i in range(n):
                model.decode_step(params, cache, SERVE_PROMPT + i, tok)
        steps()
        prof, walls = _profile(torch, steps)
    evs = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    busy = _busy_ms(evs)
    launches = sum(e.count for e in evs if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    wall = walls[1] * 1e3
    print(f"qwen2-7b decode (profiled, {n} steps): {wall / n:.3f} ms a step "
          f"wall, device busy {busy / n:.3f} ms a step, idle share "
          f"{1 - busy / wall:.3f}, {launches / n:.0f} kernel launches a "
          f"step", flush=True)
    for e in evs[:8]:
        print(f"  decode op {e.key}: {e.count / n:.0f} calls a step, self "
              f"cpu {e.self_cpu_time_total / 1e3 / n:.3f} ms a step, self "
              f"device {_dev_us(e) / 1e3 / n:.3f} ms a step", flush=True)


def deepseek_cut(torch):
    """deepseek-v2-236b (MLA + MoE) at its published widths, cut to its
    first two layers: the dense layer and one MoE layer."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model, count_params
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), n_layers=2)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"deepseek-v2-236b cut to 2 layers: {count_params(cfg)} params, "
          f"{_tree_bytes(model.params, ()) / 1e9:.3f} GB bf16, tree_init "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    _serve(torch, model, model.compute_params(), "deepseek-v2-236b/2", 16)
    m = cfg.moe
    routed = min(m.n_experts, SERVE_BATCH * m.top_k)
    expert = 3 * cfg.d_model * m.d_expert * 2
    print(f"  (a decode step's {SERVE_BATCH} tokens route to at most "
          f"{routed} of {m.n_experts} experts; the capacity dispatch runs "
          f"all {m.n_experts}: {(m.n_experts - routed) * expert / 1e9:.3f} GB"
          f" a step beyond the routed experts)", flush=True)
    print(f"deepseek-v2-236b/2 peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB", flush=True)


def rwkv_full(torch):
    """rwkv6-3b at its published widths and full depth; the ``ssm.scan``
    spans' host share of prefill."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model, count_params
    from repro_torch.obs import trace as obs_trace
    cfg = get_config("rwkv6-3b")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0)
    held = model.compute_params()
    torch.cuda.synchronize()
    print(f"rwkv6-3b: {cfg.n_layers} layers, {count_params(cfg)} params, "
          f"float32 {_tree_bytes(model.params, ()) / 1e9:.3f} GB, init and "
          f"bf16 copy {time.perf_counter() - t0:.3f} s", flush=True)
    with obs_trace.tracing() as tr:
        res, _ = _serve(torch, model, held, "rwkv6-3b", 32)
    scan = [s for s in tr.spans() if s.name == "ssm.scan"]
    pre = [s for s in scan if s.attrs.get("steps") == SERVE_PROMPT]
    scan_s = sum(s.duration_s for s in pre[-cfg.n_layers:])
    print(f"rwkv6-3b prefill: the ssm.scan spans ({cfg.n_layers} wkv6_fwd "
          f"launches of {SERVE_PROMPT} steps; host wall, the kernels run "
          f"asynchronously) {scan_s:.4f} s of {res.prefill_s:.4f} s, "
          f"{scan_s / res.prefill_s:.3f}", flush=True)
    print(f"rwkv6-3b peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB", flush=True)


def serve_phase(torch, profile=False):
    print(f"device memory allocated at the phase's start (earlier phases' "
          f"objects): {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB",
          flush=True)
    t0 = time.perf_counter()
    smoke_archs(torch)
    print(f"smoke archs: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, run in (("qwen2-7b", lambda: qwen_full(torch, profile)),
                      ("deepseek-v2-236b/2", lambda: deepseek_cut(torch)),
                      ("rwkv6-3b", lambda: rwkv_full(torch))):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        run()
        _free(torch)
        print(f"{name}: {time.perf_counter() - t0:.2f} s", flush=True)


# --------------------------------------------------------------- phase 14 --

TRAIN_ROOT = os.path.join(REPO, "build", "train_smoke")
TRAIN_STEPS = 4
SMOKE_LR = 1e-3
# card against CPU after 4 Trainer steps at the smoke sizes (float32
# compute, TF32 off, one CPU tree_init, the same batches).  Step 1's loss
# (the same parameters) within phase 13's logit tolerance, relative to the
# CPU's; the later steps' within 5e-3, since by then parameters have
# stepped apart: Adam moves a parameter by about lr * sign(m) a step, and
# one whose gradient is at the rounding noise's level (after the 8-plane
# compression, a leaf whose gradient is all noise) may step the other way.
# So each parameter within 2 x lr a step, and the mean over all parameters
# within 0.1 x lr (no more than 5% of them stepping apart).  jamba's smoke
# Mamba state reaches 1e7: its later losses within 5e-2 and the mean
# within lr.
TRAIN_LOSS_TOL = {"jamba-v0.1-52b": (1e-3, 5e-2)}    # (step 1, later)
TRAIN_MEAN_TOL = {"jamba-v0.1-52b": 1.0}             # x lr
DANUBE_LAYERS, DANUBE_BATCH, DANUBE_SEQ = 2, 2, 4096  # SHAPES["train_4k"]
BF16_FLOPS = 989e12             # H100 SXM, dense bf16 on the tensor cores
FP32_FLOPS = 67e12              # H100 SXM, float32 outside the tensor cores


class _PlainCalls:
    """Counts calls of plain versions while active, by name: by default
    those on the trainer's path, the plain bitplane encode and decode
    (``kernels.ops`` reaches them through ``kernels.ref``'s attributes),
    ``ef_quantize``'s plane path, AdamW's ``_upd`` and the global norm's
    float64 chain; else ``targets``
    ({name: (module, attribute)}, such as the lossless codec's,
    ``_plain_lossless_targets``)."""

    def __init__(self, ref=None, targets=None):
        if targets is None:
            from repro_torch.distributed import grad_compress as gc
            from repro_torch.optim import adamw
            targets = {"ref.encode": (ref, "encode"),
                       "ref.decode": (ref, "decode"),
                       "ef_quantize planes": (gc, "_encode_planes"),
                       "ef_quantize decode": (gc, "_decode_planes"),
                       "adamw._upd": (adamw, "_upd"),
                       "adamw._sumsq_plain": (adamw, "_sumsq_plain")}
        self.targets = targets
        self.n = dict.fromkeys(self.targets, 0)

    def __enter__(self):
        self.orig = {k: getattr(m, a) for k, (m, a) in self.targets.items()}

        def counted(k):
            def call(*a, **kw):
                self.n[k] += 1
                return self.orig[k](*a, **kw)
            return call
        for k, (m, a) in self.targets.items():
            setattr(m, a, counted(k))
        return self.n

    def __exit__(self, *exc):
        for k, (m, a) in self.targets.items():
            setattr(m, a, self.orig[k])


@contextlib.contextmanager
def _patched(obj, name, value):
    was = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, was)


def _rb_launches(bp):
    return {"rb_encode": bp.encode_register_block_cuda.launches,
            "rb_decode": bp.decode_register_block_cuda.launches}


OPT_KERNELS = ("ef_amax", "ef_apply", "adamw_update", "global_sumsq")
OPT_SOURCE = "src/repro_torch/kernels/csrc/optim.cu"
# what each replaces: the reference's jitted code that XLA fuses (no
# Pallas kernel)
OPT_REPLACES = {"ef_amax": "src/repro/distributed/grad_compress.py:65",
                "ef_apply": "src/repro/distributed/grad_compress.py:65",
                "adamw_update": "src/repro/optim/adamw.py:68",
                "global_sumsq": "src/repro/optim/adamw.py:54"}
FP64_FLOPS = 34e12              # H100 SXM, float64 outside the tensor cores


def _opt_launches(bp):
    """The trainer path's kernels' launches: the optimizer path's and the
    register_block pair's."""
    got = bp.launches()
    return {k: got[k] for k in OPT_KERNELS + ("rb_encode", "rb_decode")}


def _trainer(model, ckpt_dir, ckpt_every, lr, data_fn):
    """The reference launcher's Trainer settings: AdamW, warmup
    max(steps // 10, 1), 8-plane gradient compression, every step logged."""
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    return loop.Trainer(
        model, adamw.AdamWConfig(lr=lr, warmup_steps=max(TRAIN_STEPS // 10, 1),
                                 total_steps=TRAIN_STEPS),
        loop.TrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=ckpt_every,
                           ckpt_dir=ckpt_dir, log_every=1,
                           grad_compress_planes=8), data_fn)


def _state_leaves(tree):
    """A training state's leaves: params, AdamW step, m and v, EF residual
    (a Trainer result, or the checkpoint tree)."""
    from repro_torch.models.params import tree_leaves
    opt = tree.get("opt", tree.get("opt_state"))
    return (tree_leaves(tree["params"]) + [opt.step] + tree_leaves(opt.m)
            + tree_leaves(opt.v) + tree_leaves(tree["ef"]))


def train_smoke_archs(torch):
    """Every arch at SMOKE: the Trainer on the card against the CPU from one
    CPU tree_init, then a card run crashed at step 2 and resumed against
    the uncrashed card run, bit for bit."""
    from repro_torch.configs.base import list_archs, smoke_config
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import loop
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    failed = []
    for arch in list_archs():
        t0 = time.perf_counter()
        cfg = smoke_config(arch)
        cpu = Model(cfg, device="cpu", seed=0)
        card = Model(cfg, cpu.params, device="cuda")

        def run(model, name, dev):
            return _trainer(model, os.path.join(TRAIN_ROOT, arch, name), 2,
                            SMOKE_LR, loop.synthetic_data(cfg, 2, 16, seed=1,
                                                          device=dev))
        want = run(cpu, "cpu", "cpu").run()
        got = run(card, "card", "cuda").run()
        tol = TRAIN_LOSS_TOL.get(arch, (1e-4, 5e-3))
        mean_tol = TRAIN_MEAN_TOL.get(arch, 0.1) * SMOKE_LR
        loss_err = [abs(a["loss"] - b["loss"]) / abs(a["loss"])
                    for a, b in zip(want["metrics"], got["metrics"])]
        d = torch.cat([(a.double() - b.double().cpu()).abs().reshape(-1)
                       for a, b in zip(tree_leaves(want["params"]),
                                       tree_leaves(got["params"]))])
        p_max, p_mean = d.max().item(), d.mean().item()
        try:
            run(card, "crash", "cuda").run(crash_at=2)
            crashed = False
        except RuntimeError as e:
            crashed = "injected crash" in str(e)
        resumed = run(card, "crash", "cuda").run()
        exact = (crashed and resumed["final_step"] == TRAIN_STEPS
                 and [m["step"] for m in resumed["metrics"]] == [3, 4]
                 and all(torch.equal(a, b) for a, b in
                         zip(_state_leaves(resumed), _state_leaves(got))))
        ok = (all(math.isfinite(m["loss"]) for m in got["metrics"])
              and loss_err[0] <= tol[0] and max(loss_err) <= tol[1]
              and p_max <= 2 * TRAIN_STEPS * SMOKE_LR
              and p_mean <= mean_tol and exact)
        print(f"{arch}: {TRAIN_STEPS} steps card vs CPU: losses "
              + " ".join(f"{e:.2e}" for e in loss_err)
              + f" (<= {tol[0]:g}, then {tol[1]:g}), "
              f"final params max {p_max:.2e} (<= "
              f"{2 * TRAIN_STEPS * SMOKE_LR:g}), mean {p_mean:.2e} "
              f"(<= {mean_tol:g}); crashed at 2 and resumed "
              + ("== uncrashed bit for bit (params, AdamW state, EF "
                 "residual)" if exact else "DIFFERS from uncrashed")
              + f"; {'ok' if ok else 'FAILED'}; "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        if not ok:
            failed.append(arch)
    check(not failed, f"training card vs CPU or crash/resume failed: {failed}")


def step_bound(cfg, n_params, batch, seq):
    """The least time one training step could take: (ms, what bounds it,
    details).  Operations: the bf16 matmuls (forward, the remat
    re-forward of the layers, backward at twice the forward) over 989
    TFLOP/s, plus the attention products, float32 in the port, over 67
    TFLOP/s, counting the (query, key) pairs the causal window needs.
    Bytes: AdamW (read p, g, m, v; write p, m, v), the EF pass (read g, r;
    write q, r) and one read of the float32 weights, over 3.35 TB/s."""
    tokens = batch * seq
    layer = cfg.d_model * (cfg.head_dim * (2 * cfg.n_heads
                                           + 2 * cfg.n_kv_heads)
                           + 3 * cfg.d_ff)
    head = cfg.d_model * cfg.vocab_size
    window = cfg.attn_window or seq
    pairs = batch * cfg.n_heads * sum(min(q + 1, window) for q in range(seq))
    bf16 = (4 * 2 * tokens * layer * cfg.n_layers + 3 * 2 * tokens * head)
    fp32 = 4 * 2 * 2 * pairs * cfg.head_dim * cfg.n_layers
    ops_ms = (bf16 / BF16_FLOPS + fp32 / FP32_FLOPS) * 1e3
    nbytes = 12 * 4 * n_params
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms
            else "bytes", f"{bf16 / 1e12:.2f} TFLOP bf16 + {fp32 / 1e12:.2f} "
            f"TFLOP float32 = {ops_ms:.2f} ms; {nbytes / 1e9:.2f} GB = "
            f"{bytes_ms:.2f} ms")


def _timing_row(torch, name, case, n, call, plain, nbytes, ops_ms=0.0,
                library=None, inner=20, of="the embedding's"):
    """A kernel's times at one shape: ``ms`` back to back through its
    wrapper, ``device_ms`` from a replayed CUDA graph of ``inner`` calls,
    the plain version's, the library call's (or None) and the bound."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    r = dict(name=name, case=case, n=n, ms=time_ms(call, inner=inner),
             device_ms=time_ms(call, inner=inner, graph=True),
             plain_ms=time_ms(plain, reps=3, inner=1, warmup=1),
             library_ms=(None if library is None else
                         time_ms(library, reps=5, inner=1, warmup=2)),
             bound_ms=max(bytes_ms, ops_ms),
             bound_by="bytes" if bytes_ms >= ops_ms else "operations",
             bytes=nbytes)
    print(f"{name} {case} (N={n}, {of}): kernel "
          f"{r['ms'] * 1e3:.1f} us a call back to back, device "
          f"{r['device_ms'] * 1e3:.1f} us "
          f"({nbytes / r['device_ms'] / 1e6:.0f} GB/s), plain "
          f"{r['plain_ms'] * 1e3:.1f} us"
          + ("" if library is None else
             f", library {r['library_ms'] * 1e3:.1f} us")
          + f", bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}), "
          f"{r['device_ms'] / r['bound_ms']:.2f}x", flush=True)
    return r


def ef_kernel_timings(torch, bp, ref, n):
    """rb_encode and rb_decode at the embedding gradient's N, the shapes
    ``ef_quantize`` gave them before its own kernels (8 magnitude planes
    and the sign plane; checkpoints and ``compressed_psum`` still do):
    kernel and plain time and the byte bound, as phase 2 times them."""
    words = -(-n // 4096) * 128
    rows = []
    for what, p, hi in (("8 planes", 8, 2 ** 8), ("1 sign plane", 1, 2)):
        x = torch.randint(0, hi, (1, n), dtype=torch.int32, device="cuda")
        planes = ref.encode_register_block(x, p)
        for name, call, plain, arg, nbytes in (
                ("rb_encode", lambda a: bp.encode_register_block_cuda(a, p),
                 lambda: ref.encode_register_block(x, p), x,
                 4 * n + 4 * p * words),
                ("rb_decode",
                 lambda a: bp.decode_register_block_cuda(a, p, n),
                 lambda: ref.decode_register_block(planes, p, n), planes,
                 4 * p * words + 4 * n)):
            check(torch.equal(call(arg), plain()),
                  f"{name} {what} at N={n}")
            rows.append(_timing_row(torch, name, what, n,
                                    lambda: call(arg), plain, nbytes))
        del x, planes
    return rows


def _fused_adamw(torch, cfg, p, g, m, v, step):
    """``torch._fused_adamw_`` over the leaves (in place, on copies): a
    different function from the port's update (its own rounding, no
    flushes), timed as the library's yardstick for ``adamw_update``."""
    p, g, m, v = ([t.clone() for t in ts] for ts in (p, g, m, v))
    steps = [torch.tensor(float(step), device="cuda") for _ in p]
    return lambda: torch._fused_adamw_(
        p, g, m, v, [], steps, lr=cfg.lr, beta1=cfg.b1, beta2=cfg.b2,
        weight_decay=cfg.weight_decay, eps=cfg.eps, amsgrad=False,
        maximize=False)


def optimizer_kernel_timings(torch, n):
    """ef_amax, ef_apply and adamw_update at the embedding gradient's N
    (h2o-danube-3-4b's, 122,880,000 values; the update in float32 and in
    bfloat16 state): each against its plain version, the update also
    against ``torch._fused_adamw_`` on the same leaf, and its bound.  Bytes:
    ef_amax reads x and r (8 a value), ef_apply reads them and writes q
    and r (16), adamw_update reads p, g, m, v and writes p, m, v (28 in
    float32, 20 with a bfloat16 state); its operations, 7 float64 and
    about 15 float32 a value, stay under a tenth of that."""
    from repro_torch.distributed.grad_compress import ef_quantize
    from repro_torch.kernels import optim as ko
    from repro_torch.optim import adamw
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(n, generator=gen, device="cuda") * 1e-4
    r = torch.randn(n, generator=gen, device="cuda") * 1e-8
    part = ko.ef_amax(x, r)
    rows = [_timing_row(torch, "ef_amax", "x, r -> maxima", n,
                        lambda: ko.ef_amax(x, r),
                        lambda: ko.ef_amax_ref(x, r), 8 * n, inner=5),
            _timing_row(torch, "ef_apply", "8 planes", n,
                        lambda: ko.ef_apply(x, r, part, 8),
                        lambda: ef_quantize(x, r, 8, backend="torch"),
                        16 * n, inner=5)]
    ops_ms = (7 * n / FP64_FLOPS + 15 * n / FP32_FLOPS) * 1e3
    p = torch.randn(n, generator=gen, device="cuda") * 2e-2
    for sname in ("float32", "bfloat16"):
        cfg = adamw.AdamWConfig(state_dtype=sname)
        sdt = adamw.DTYPES[sname]
        m = (x * 1e-2).to(sdt)
        v = (x * x).to(sdt)
        sc = adamw.step_scalars(cfg, torch.tensor(150, dtype=torch.int32,
                                                  device="cuda"),
                                adamw.global_norm({"g": x}))
        args = (p, x, m, v, *sc, cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay)
        library = (_fused_adamw(torch, cfg, [p], [x], [m], [v], 150)
                   if sname == "float32" else None)
        rows.append(_timing_row(
            torch, "adamw_update", f"{sname} state", n,
            lambda: ko.adamw_update(*args),
            lambda: adamw._upd(p, x, m, v, *sc, cfg, sdt),
            (12 + 2 * 2 * m.element_size()) * n, ops_ms,
            library=library, inner=5))
        del m, v, library
    return rows


def optimizer_stages(torch, bp, trainer, res, batch):
    """Trainer._step's stages on the device's timeline (CUDA events) and
    the step's wall, with the optimizer path's kernels ("kernels") and
    without them ("eager": ``ef_quantize``'s plane path through
    rb_encode/rb_decode and AdamW's ``_upd``, the path before these
    kernels), in turns eager, kernels, kernels, eager in this one process:
    loss and gradient, ef_quantize over the leaves, the global norm, and
    the update less the norm; then ``torch._fused_adamw_`` over the same
    leaves.  Returns each mode's two readings."""
    from repro_torch.distributed.grad_compress import ef_quantize
    from repro_torch.kernels import optim as ko
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.optim import adamw
    from repro_torch.train.step import value_and_grad
    state = (res["params"], res["opt_state"], res["ef"])
    out = {"eager": [], "kernels": []}
    for mode in ("eager", "kernels", "kernels", "eager"):
        with (_patched(ko, "_on_operators", lambda t: False)
              if mode == "eager" else contextlib.nullcontext()):
            before = _opt_launches(bp)
            trainer._step(*state, batch)            # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer._step(*state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            _, grads = value_and_grad(
                lambda p: trainer.model.loss(p, batch), state[0])
            ev[1].record()
            qs = tree_unflatten(grads, [
                ef_quantize(g, r, 8)[0] for g, r in
                zip(tree_leaves(grads), tree_leaves(state[2]))])
            ev[2].record()
            adamw.global_norm(qs)
            ev[3].record()
            adamw.update(qs, state[1], state[0], trainer.opt_cfg)
            ev[4].record()
            torch.cuda.synchronize()
            used = {k: v - before[k] for k, v in
                    _opt_launches(bp).items()}
        t = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        row = dict(wall_ms=wall, grad_ms=t[0], ef_ms=t[1], norm_ms=t[2],
                   adamw_ms=t[3], update_ms=t[3] - t[2])
        out[mode].append(row)
        kernels = mode == "kernels"
        check(all((used[k] > 0) == kernels for k in OPT_KERNELS)
              and (used["rb_encode"] > 0) != kernels,
              f"{mode} steps launched {used}")
        print(f"danube/2 step, {mode}: wall {wall:.1f} ms; stages (CUDA "
              f"events) loss and gradient {t[0]:.1f} ms, ef_quantize "
              f"{t[1]:.1f} ms, AdamW {t[3]:.1f} ms = global norm "
              f"{t[2]:.1f} ms + update {t[3] - t[2]:.1f} ms", flush=True)
        del grads, qs
    print("global norm stage (CUDA events): " + "; ".join(
        f"{mode} " + " / ".join(f"{r['norm_ms']:.3f}" for r in out[mode])
        + " ms, step wall " + " / ".join(f"{r['wall_ms']:.1f}"
                                          for r in out[mode]) + " ms"
        for mode in ("eager", "kernels")), flush=True)
    opt = state[1]
    leaves = tree_leaves(state[0])      # the parameters as the gradients
    fused = _fused_adamw(torch, trainer.opt_cfg, leaves, leaves,
                         tree_leaves(opt.m), tree_leaves(opt.v),
                         int(opt.step) + 1)
    out["fused_ms"] = time_ms(fused, reps=5, inner=1, warmup=2)
    print(f"torch._fused_adamw_ over the same {len(leaves)} leaves (a "
          f"different function: its own rounding, no flushes): "
          f"{out['fused_ms']:.2f} ms", flush=True)
    del fused
    return out


def _profile_step(torch, trainer, res, batch):
    """One more danube training step under torch.profiler: its wall, the
    device's busy time and idle share, kernel launches, and the top ops by
    self device time (``optimizer_stages`` times its stages)."""
    state = (res["params"], res["opt_state"], res["ef"])
    trainer._step(*state, batch)        # warm: the profiled step's twin
    prof, walls = _profile(torch, lambda: trainer._step(*state, batch))
    evs = sorted(prof.key_averages(), key=lambda e: -_dev_us(e))
    busy = _busy_ms(evs)
    launches = sum(e.count for e in evs if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    wall = walls[1] * 1e3
    print(f"danube step (profiled): {wall:.1f} ms wall, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}, {launches} "
          f"kernel launches", flush=True)
    for e in [e for e in evs if e.key.startswith("aten::")][:10]:
        print(f"  danube op {e.key}: {e.count} calls, self device "
              f"{_dev_us(e) / 1e3:.1f} ms, self cpu "
              f"{e.self_cpu_time_total / 1e3:.1f} ms", flush=True)
    from torch.autograd import DeviceType
    kernels = [e for e in evs if e.device_type == DeviceType.CUDA]
    for e in kernels[:10]:
        print(f"  danube kernel {e.key[:90]}: {e.count} launches, device "
              f"{_dev_us(e) / 1e3:.1f} ms", flush=True)


def danube_train(torch, bp, ref, profile=False):
    """h2o-danube-3-4b at its published widths, depth cut from 24 to 2:
    4 Trainer steps of batch 2 x 4096 with the reference launcher's
    settings, one checkpoint at step 4, loaded back bit-exact; ef_quantize
    on the card against its plain path on every gradient leaf.  With
    ``profile``, one more step under torch.profiler."""
    import dataclasses
    from repro_torch.ckpt import manager as ck
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.grad_compress import ef_quantize
    from repro_torch.models.model import Model, count_params
    from repro_torch.models.params import tree_leaves
    from repro_torch.obs import trace as obs_trace
    from repro_torch.train import loop
    from repro_torch.train.step import value_and_grad

    cfg = dataclasses.replace(get_config("h2o-danube-3-4b"),
                              n_layers=DANUBE_LAYERS)
    check(cfg.remat and cfg.compute_dtype == "bfloat16"
          and cfg.param_dtype == "float32", "danube's training settings")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = count_params(cfg)
    leaves = tree_leaves(model.params)
    print(f"h2o-danube-3-4b, {cfg.n_layers} of 24 layers: {n_params} params "
          f"in {len(leaves)} leaves (largest {max(t.numel() for t in leaves)}"
          f"), tree_init on the card {time.perf_counter() - t0:.3f} s; "
          f"batch {DANUBE_BATCH} x {DANUBE_SEQ}, bf16 compute, remat, "
          f"float32 params and AdamW state, 8-plane EF compression",
          flush=True)
    bound_ms, bound_by, detail = step_bound(cfg, n_params, DANUBE_BATCH,
                                            DANUBE_SEQ)
    print(f"step bound {bound_ms:.2f} ms ({bound_by}): {detail}", flush=True)

    data = loop.synthetic_data(cfg, DANUBE_BATCH, DANUBE_SEQ, seed=1,
                               device="cuda")
    marks = []

    def data_fn(step):
        marks.append(_opt_launches(bp))   # launches before each step
        return data(step)
    root = os.path.join(TRAIN_ROOT, "danube")
    trainer = _trainer(model, root, TRAIN_STEPS, 3e-4, data_fn)
    bp.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _PlainCalls(ref) as plain, obs_trace.tracing() as tr:
        t0 = time.perf_counter()
        res = trainer.run()
        wall = time.perf_counter() - t0
    end = _opt_launches(bp)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(not any(plain.values()),
          f"the training run called a plain version: {plain}")
    per_step = [{k: b[k] - a[k] for k in a} for a, b in zip(marks, marks[1:])]
    last = {k: end[k] - marks[-1][k] for k in end}
    ckpt_launches = {k: last[k] - per_step[0][k] for k in last}
    n_leaves = len(leaves)
    check(len(per_step) == TRAIN_STEPS - 1
          and all(s == per_step[0] for s in per_step)
          and per_step[0] == {"ef_amax": n_leaves, "ef_apply": n_leaves,
                              "adamw_update": n_leaves, "global_sumsq": 1,
                              "rb_encode": 0, "rb_decode": 0}
          and ckpt_launches["rb_encode"] > 0
          and not any(ckpt_launches[k] for k in OPT_KERNELS),
          f"launches: per step {per_step}, last step and checkpoint {last}")
    for m in res["metrics"]:
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"danube step {m['step']}: loss {m['loss']}, grad norm "
              f"{m['grad_norm']}")
        print(f"danube step {m['step']}: wall {m['dt'] * 1e3:.1f} ms "
              f"({bound_ms / (m['dt'] * 1e3):.3f} of the {bound_ms:.2f} ms "
              f"bound), loss {m['loss']:.4f}, grad norm "
              f"{m['grad_norm']:.4f}", flush=True)
    print(f"danube run {wall:.2f} s; launches a step: {per_step[0]} "
          f"(ef_amax and ef_apply a leaf for ef_quantize, adamw_update a "
          f"leaf, one global_sumsq); the checkpoint's: {ckpt_launches}; plain versions' "
          f"calls: {plain}; peak device memory {peak:.3f} GiB", flush=True)

    tree = {"params": res["params"], "opt": res["opt_state"], "ef": res["ef"]}
    raw = sum(t.numel() * t.element_size() for t in _state_leaves(tree))
    spans = tr.summary()["spans"]
    snap_s = spans["ckpt.snapshot"]["total_s"]
    save_s = spans["ckpt.save"]["total_s"]
    stored = sum(e["stored_bytes"] for e in json.load(open(os.path.join(
        root, f"step_{TRAIN_STEPS:08d}", "manifest.json")))["leaves"].values())
    print_spans(tr, "danube run")
    print(f"danube checkpoint at step {TRAIN_STEPS}: {raw / 1e9:.3f} GB "
          f"(params, AdamW m and v, EF residual), snapshot to the host "
          f"{snap_s:.3f} s ({raw / snap_s / 1e9:.3f} GB/s), encode and write "
          f"{save_s:.3f} s ({raw / save_s / 1e9:.3f} GB/s), "
          f"{stored / 1e9:.3f} GB stored (ratio {raw / stored:.3f})",
          flush=True)
    torch.cuda.synchronize()
    with obs_trace.tracing() as tr:
        t0 = time.perf_counter()
        out, _ = ck.load(root, TRAIN_STEPS, tree, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    print_spans(tr, "danube load")
    check(all(a.dtype == b.dtype and a.device.type == "cuda"
              and torch.equal(a, b) for a, b in
              zip(_state_leaves(out), _state_leaves(tree))),
          "the danube checkpoint does not load back bit-exact")
    print(f"danube checkpoint load: {load_s:.3f} s "
          f"({raw / load_s / 1e9:.3f} GB/s), every leaf bit-exact",
          flush=True)
    del out

    # the gradient leaves at the final params on step 4's batch, with the
    # final residual and state: each optimizer kernel against its plain
    # version, then the step's stages with and without them
    batch = data(TRAIN_STEPS - 1)
    if profile:
        _profile_step(torch, trainer, res, batch)
    _, grads = value_and_grad(lambda p: model.loss(p, batch), res["params"])
    errs = optimizer_kernels_check(torch, bp, grads, res, trainer.opt_cfg)
    g_leaves = tree_leaves(grads)
    # the kernels line's error is the main path's; the special leaves'
    # sums reach 1e75, held by the relative bound alone
    errs["global_sumsq"] = sumsq_check(torch, g_leaves,
                                       "danube/2's gradient leaves")
    sumsq_check(torch, sumsq_specials(torch), "special leaves")
    sumsq_row = sumsq_timing(torch, g_leaves)
    del grads, g_leaves
    stages = optimizer_stages(torch, bp, trainer, res, batch)
    n_emb = model.params["embed"].numel()
    del res, tree, trainer, model, batch
    _free(torch)
    rows = ef_kernel_timings(torch, bp, ref, n_emb)
    _free(torch)
    rows += optimizer_kernel_timings(torch, n_emb) + [sumsq_row]
    return {"launches": {k: end[k] for k in OPT_KERNELS}, "errs": errs,
            "stages": stages,
            "rows": {r["name"]: r for r in rows if r["name"] in OPT_KERNELS
                     and r["case"] != "bfloat16 state"}}


def optimizer_kernels_check(torch, bp, grads, res, opt_cfg):
    """Each optimizer-path kernel against its plain version on the card, on
    every gradient leaf of danube/2 (the embedding's 122,880,000 values
    included): ef_amax's blocks' largest against torch's maximum;
    ``ef_quantize`` through ef_amax and ef_apply (one launch each, no
    rb_*) against its plane path (``backend="torch"``); adamw_update
    against ``_upd`` at the final parameters and state, in float32 and in
    bfloat16 state, on the quantized gradients at the next step's scalars.
    All bit for bit; returns each kernel's largest |kernel - plain|."""
    import dataclasses
    from repro_torch.distributed.grad_compress import ef_quantize
    from repro_torch.kernels import optim as ko
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.optim import adamw

    def same(a, b):
        iv = {2: torch.int16, 4: torch.int32}[a.element_size()]
        return a.dtype == b.dtype and torch.equal(a.view(iv), b.view(iv))

    def err(a, b):
        return (a.double() - b.double()).abs().max().item()
    errs = dict.fromkeys(OPT_KERNELS, 0.0)
    qs = []
    for g, r in zip(tree_leaves(grads), tree_leaves(res["ef"])):
        amax = ko.ef_amax(g, r).view(torch.int32).max().view(torch.float32)
        want = ko.ef_amax_ref(g, r)
        check(same(amax, want), f"ef_amax at N={g.numel()}: "
              f"{amax.item()} != {want.item()}")
        errs["ef_amax"] = max(errs["ef_amax"], err(amax, want))
        before = _opt_launches(bp)
        q, nr = ef_quantize(g, r, 8)
        after = _opt_launches(bp)
        check(after == dict(before, ef_amax=before["ef_amax"] + 1,
                            ef_apply=before["ef_apply"] + 1),
              f"ef_quantize launches at N={g.numel()}: {before} -> {after}")
        qp, nrp = ef_quantize(g, r, 8, backend="torch")
        check(same(q, qp) and same(nr, nrp),
              f"ef_quantize through ef_amax/ef_apply differs from its "
              f"plane path at N={g.numel()}")
        errs["ef_apply"] = max(errs["ef_apply"], err(q, qp), err(nr, nrp))
        qs.append(q)
        del nr, qp, nrp
    opt = res["opt_state"]
    gnorm = adamw.global_norm(tree_unflatten(grads, qs))
    for sname in ("float32", "bfloat16"):
        cfg = dataclasses.replace(opt_cfg, state_dtype=sname)
        sdt = adamw.DTYPES[sname]
        sc = adamw.step_scalars(cfg, opt.step + 1, gnorm)
        for p, q, m, v in zip(tree_leaves(res["params"]), qs,
                              tree_leaves(opt.m), tree_leaves(opt.v)):
            m, v = m.to(sdt), v.to(sdt)
            n0 = ko.adamw_update.launches
            got = ko.adamw_update(p, q, m, v, *sc, cfg.b1, cfg.b2, cfg.eps,
                                  cfg.weight_decay)
            check(ko.adamw_update.launches == n0 + 1,
                  f"adamw_update launches at N={p.numel()}")
            want = adamw._upd(p, q, m, v, *sc, cfg, sdt)
            check(all(same(a, b) for a, b in zip(got, want)),
                  f"adamw_update differs from _upd at N={p.numel()}, "
                  f"{sname} state")
            errs["adamw_update"] = max(errs["adamw_update"],
                                       *(err(a, b) for a, b in
                                         zip(got, want)))
            del got, want, m, v
    print(f"ef_amax, ef_apply (ef_quantize, 8 planes) and adamw_update "
          f"(float32 and bfloat16 state) == their plain versions, bit for "
          f"bit, on all {len(qs)} gradient leaves (N up to "
          f"{max(q.numel() for q in qs)})", flush=True)
    return errs


def sumsq_check(torch, leaves, what):
    """``global_sumsq`` on the card against its plain version (the float64
    chain): the same bits on two calls, each leaf's sum within 1e-12
    relative (zeros exact), the norm within one float32 ulp; prints the
    norms and their difference.  Returns the largest |kernel - plain| of
    the sums."""
    from repro_torch.kernels import optim as ko
    from repro_torch.optim import adamw
    got, again = ko.global_sumsq(leaves), ko.global_sumsq(leaves)
    check(torch.equal(got.view(torch.int64), again.view(torch.int64)),
          f"global_sumsq on {what}: two calls differ")
    want = ko.global_sumsq_ref(leaves)
    zero = want == 0
    check(torch.equal(got[zero], want[zero]),
          f"global_sumsq on {what}: a zero sum is not zero")
    rel = ((got - want).abs()[~zero] / want[~zero]).max().item() \
        if bool((~zero).any()) else 0.0
    check(rel <= 1e-12, f"global_sumsq on {what}: {rel} relative")
    tree = {f"{i:04d}": g for i, g in enumerate(leaves)}
    norm = adamw.global_norm(tree)
    chain = adamw.global_norm(tree, backend="torch")
    ulps = abs(int(norm.view(torch.int32)) - int(chain.view(torch.int32)))
    check(ulps <= 1, f"global_sumsq on {what}: norm {norm.item()!r} against "
          f"the chain's {chain.item()!r}")
    print(f"global_sumsq on {what}: {len(leaves)} leaves, the same bits on "
          f"two calls; sums within {rel:.3e} relative of the float64 chain; "
          f"norm {norm.item()!r} against the chain's {chain.item()!r} "
          f"({ulps} ulp)", flush=True)
    return (got - want).abs().max().item()


def sumsq_specials(torch):
    """Special leaves for ``global_sumsq``: zeros, subnormals, squares past
    float32, bfloat16, empty, one value, either side of a chunk, one that
    starts off a 16-byte boundary."""
    from repro_torch.kernels import optim as ko
    gen = torch.Generator(device="cuda").manual_seed(9)
    c = ko.SUM_CHUNK
    return [torch.zeros(1000, device="cuda"),
            torch.full((70_000,), 1e-40, device="cuda"),
            torch.full((c + 3,), 3e35, device="cuda"),
            torch.tensor([1e19, -1e-45, 0.0, -0.0], device="cuda"),
            torch.randn(200_003, generator=gen, device="cuda").to(
                torch.bfloat16),
            torch.empty(0, device="cuda"),
            torch.randn(1, generator=gen, device="cuda"),
            torch.randn(c - 1, generator=gen, device="cuda"),
            torch.randn(c + 2, generator=gen, device="cuda")[1:]]


def sumsq_timing(torch, leaves):
    """``global_sumsq`` over the gradient leaves: wrapper and replayed
    graph, the plain chain, ``torch.nn.utils.get_total_norm`` (the library
    call for the same function, accumulating in float32) and the bound:
    every value read once (its dtype's bytes) and L float64 sums written,
    or one float64 multiply and add a value, the larger."""
    from repro_torch.kernels import optim as ko
    n = sum(g.numel() for g in leaves)
    nbytes = sum(g.numel() * g.element_size() for g in leaves) \
        + 8 * len(leaves)
    return _timing_row(
        torch, "global_sumsq", f"{len(leaves)} leaves", n,
        lambda: ko.global_sumsq(leaves),
        lambda: ko.global_sumsq_ref(leaves), nbytes,
        2 * n / FP64_FLOPS * 1e3,
        library=lambda: torch.nn.utils.get_total_norm(leaves), inner=5,
        of="danube/2's gradient leaves")


def train_phase(torch, bp, ref, profile=False):
    import shutil
    shutil.rmtree(TRAIN_ROOT, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        train_smoke_archs(torch)
        print(f"smoke archs: {time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        out = danube_train(torch, bp, ref, profile)
        _free(torch)
        print(f"h2o-danube-3-4b/2: {time.perf_counter() - t0:.2f} s",
              flush=True)
    finally:
        shutil.rmtree(TRAIN_ROOT, ignore_errors=True)
    return out


# --------------------------------------------------------------- phase 15 --

MESH_ROOT = os.path.join(REPO, "build", "mesh_smoke")
SEQ_BATCH, SEQ_PROMPT, SEQ_NEW = 4, 256, 16   # decode_32k cut to batch 4


def _wire(shd):
    snap = shd.WIRE.snapshot()
    return {k: v for k, v in snap.items() if v}


def compressed_allreduce_check(torch, bp, mesh):
    """``make_compressed_allreduce`` over 'data' on vectors of the sizes of
    h2o-danube-3-4b/2's gradient leaves: at one rank the output is
    ``ef_quantize(x, 0)``'s q bit for bit and the residual x - q; the
    kernels equal their plain versions (``backend="torch"``) bit for bit;
    rb_encode/rb_decode launches and the payload's bytes."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import grad_compress as gc
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import model_abstract
    from repro_torch.models.params import tree_leaves
    cfg = dataclasses.replace(get_config("h2o-danube-3-4b"),
                              n_layers=DANUBE_LAYERS)
    sizes = [ps.size for ps in tree_leaves(model_abstract(cfg))]
    f = gc.make_compressed_allreduce(mesh, "data", planes=8)
    f_plain = gc.make_compressed_allreduce(mesh, "data", planes=8,
                                           backend="torch")
    gen = torch.Generator(device="cuda").manual_seed(5)
    bp.reset_launches()
    launches = {"rb_encode": 0, "rb_decode": 0}
    wire = {}
    t_kernel = 0.0
    for n in sizes:
        x = torch.randn((n,), generator=gen, device="cuda") * 1e-3
        before = _rb_launches(bp)
        shd.WIRE.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, res = f(x)
        torch.cuda.synchronize()
        t_kernel += time.perf_counter() - t0
        for k, v in shd.WIRE.snapshot().items():
            wire[k] = wire.get(k, 0) + v
        after = _rb_launches(bp)
        for k in launches:
            launches[k] += after[k] - before[k]
        check(after["rb_encode"] - before["rb_encode"] == 2
              and after["rb_decode"] - before["rb_decode"] == 2,
              f"compressed_psum launches at N={n}: {before} -> {after}")
        ef0 = _opt_launches(bp)
        q, q_res = gc.ef_quantize(x, torch.zeros_like(x), 8)
        ef1 = _opt_launches(bp)
        check(ef1["ef_amax"] - ef0["ef_amax"] == 1
              and ef1["ef_apply"] - ef0["ef_apply"] == 1
              and ef1["rb_encode"] == ef0["rb_encode"],
              f"ef_quantize's launches at N={n}: {ef0} -> {ef1}")
        check(torch.equal(out.view(torch.int32), q.view(torch.int32)),
              f"compressed_psum at one rank != ef_quantize's q at N={n}")
        check(torch.equal(res[:n].view(torch.int32),
                          (x - q).view(torch.int32))
              and torch.equal(res[:n].view(torch.int32),
                              q_res.view(torch.int32)),
              f"compressed_psum's residual != x - q, ef_quantize's "
              f"residual, at N={n}")
        out_p, res_p = f_plain(x)
        check(torch.equal(out.view(torch.int32), out_p.view(torch.int32))
              and torch.equal(res.view(torch.int32), res_p.view(torch.int32)),
              f"compressed_psum through the kernels != its plain path at "
              f"N={n}")
        del x, out, res, q, q_res, out_p, res_p
    payload = sum(4 * (1 + 8) * (-(-n // 4096) * 128) + 4 for n in sizes)
    print(f"compressed all-reduce, 8 planes, over {len(sizes)} vectors of "
          f"danube/2's gradient leaf sizes (N up to {max(sizes)}): output "
          f"== ef_quantize's q (ef_amax/ef_apply) and residual == x - q == "
          f"its residual bit for bit, kernels "
          f"== plain bit for bit; {t_kernel:.3f} s through the kernels; "
          f"launches {launches}; gathered payload {payload} B "
          f"({payload / (4 * sum(sizes)):.4f} of the float32 gradients); "
          f"collectives at one rank {wire} (ring model: no byte on the "
          f"wire at n = 1)", flush=True)
    return launches


def _decode(torch, model, params, prompts, n_new, max_len, mesh=None,
            policy=None, shardings=None):
    """Prefill to a ``max_len``-deep cache, then ``n_new - 1`` greedy decode
    steps; under ``mesh`` the caches are cut by ``cache_shardings``;
    ``shardings``: ``params`` holds blocks of these specs.  Returns
    (tokens, logits, prefill s, decode ms/token)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.step import cache_shardings
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, tokens=prompts,
                                      max_len=max_len, shardings=shardings)
        if mesh is not None and policy is not None:
            named = cache_shardings(cache, policy, mesh)

            def cut(c, n):
                return ({k: cut(c[k], n[k]) for k in c} if isinstance(c, dict)
                        else shd.local_shard(c, n.spec, n.mesh))
            cache = cut(cache, named)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        toks, steps = [tok], [logits[:, -1]]
        t0 = time.perf_counter()
        for i in range(n_new - 1):
            logits, cache = model.decode_step(params, cache,
                                              prompts.shape[1] + i, tok,
                                              shardings=shardings)
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            toks.append(tok)
            steps.append(logits[:, -1])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (n_new - 1)
    return torch.cat(toks, 1), torch.stack(steps, 1), prefill_s, ms


def seqshard_decode_check(torch, mesh):
    """qwen2-7b at its published widths and full depth, bf16 weights held,
    decode_32k's policy on the mesh (cache 32,768 deep, seq-sharded), batch
    4 of its 128, a 256-token prompt and 16 new tokens with
    ``seq_shard_decode`` against the plain decode at the same cache
    length: greedy tokens equal, logits bit-identical at one rank."""
    import dataclasses
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.driver import build_inputs
    from repro_torch.launch.policy import cell_policy
    from repro_torch.models.model import Model
    cfg = get_config("qwen2-7b")
    policy = cell_policy(cfg, SHAPES["decode_32k"], mesh)
    check(policy.seq_shard and policy.cache_len == 32768,
          f"decode_32k's policy on {mesh}: {policy}")
    model = Model(cfg, device="cuda", seed=0)
    held = model.compute_params()
    sharded = Model(dataclasses.replace(cfg, seq_shard_decode=True), held,
                    device="cuda")
    prompts, _ = build_inputs(cfg, SEQ_BATCH, SEQ_PROMPT, device="cuda")
    plain = _decode(torch, model, held, prompts, SEQ_NEW, policy.cache_len)
    _free(torch)
    shd.WIRE.reset()
    with shd.use_mesh(mesh):
        got = _decode(torch, sharded, held, prompts, SEQ_NEW,
                      policy.cache_len, mesh, policy)
    wire = _wire(shd)
    check(torch.equal(got[0], plain[0]), "seq-sharded decode's greedy "
          "tokens differ from the plain decode's")
    exact = torch.equal(got[1].view(torch.int32), plain[1].view(torch.int32))
    rel = _rel(torch, plain[1], got[1])
    check(exact, f"seq-sharded decode's logits are not the plain decode's "
          f"bits at one rank (max relative difference {rel})")
    weights = _tree_bytes(held)
    cache = _cache_bytes(model, SEQ_BATCH, policy.cache_len)
    bound_ms = (weights + cache) / HBM_BYTES_PER_S * 1e3
    print(f"qwen2-7b seq-sharded flash decode, cache {policy.cache_len} deep "
          f"(decode_32k, batch {SEQ_BATCH} of 128), prompt {SEQ_PROMPT}, "
          f"{SEQ_NEW} new tokens: greedy tokens equal, logits bit-identical "
          f"to the plain decode; {got[3]:.2f} ms/token (plain {plain[3]:.2f})"
          f", prefill {got[2]:.3f} s; bound {bound_ms:.2f} ms/token (bf16 "
          f"weights {weights / 1e9:.3f} GB + cache {cache / 1e9:.3f} GB at "
          f"3.35 TB/s); collectives {wire}", flush=True)
    del model, sharded, held, plain, got
    _free(torch)


def mesh_train_check(torch, mesh):
    """One make_train_step step under the mesh for every smoke arch against
    the same step without it, on the card: loss, AdamW state and new
    parameters bit for bit."""
    from repro_torch.configs.base import ShapeConfig, list_archs, smoke_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.policy import cell_policy
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    from repro_torch.train.step import make_train_step
    for arch in list_archs():
        cfg = smoke_config(arch)
        model = Model(cfg, device="cuda", seed=0)
        policy = cell_policy(cfg, ShapeConfig("t", 16, 2, "train"), mesh)
        opt_cfg = adamw.AdamWConfig(lr=SMOKE_LR, warmup_steps=1,
                                    total_steps=4)
        fn = make_train_step(model, opt_cfg, policy)
        batch = loop.synthetic_data(cfg, 2, 16, seed=1, device="cuda")(0)
        opt = adamw.init(model.params, opt_cfg)
        p1, o1, m1 = fn(model.params, opt, batch)
        with shd.use_mesh(mesh):
            p2, o2, m2 = fn(model.params, opt, batch)
        same = (torch.equal(m1["loss"], m2["loss"])
                and all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(p1) + tree_leaves(o1.m) + tree_leaves(o1.v),
                    tree_leaves(p2) + tree_leaves(o2.m) + tree_leaves(o2.v))))
        check(same, f"{arch}: the step under the mesh differs from the step "
              f"without one")
    print(f"make_train_step under the mesh == without it, bit for bit (loss, "
          f"AdamW m and v, new parameters), for all {len(list_archs())} "
          f"smoke archs", flush=True)


def mesh_ckpt_check(torch, mesh):
    """A tree saved under the mesh (rank 0 writes) gives the files of a
    save without one; ``load(shardings=)`` restores each rank's block
    bit-exact."""
    from repro_torch.ckpt import manager as ck
    from repro_torch.configs.base import smoke_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.policy import CellPolicy
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train.step import train_shardings
    import shutil
    shutil.rmtree(MESH_ROOT, ignore_errors=True)
    try:
        model = Model(smoke_config("deepseek-v2-236b"), device="cuda", seed=0)
        opt_cfg = adamw.AdamWConfig()
        tree = {"params": model.params, "opt": adamw.init(model.params,
                                                          opt_cfg)}
        p_sh, o_sh = train_shardings(model, CellPolicy(("data",), 1,
                                                       "float32", 16),
                                     mesh, opt_cfg)
        named = {"params": p_sh, "opt": o_sh}
        a, b = os.path.join(MESH_ROOT, "mesh"), os.path.join(MESH_ROOT,
                                                             "plain")
        with shd.use_mesh(mesh):
            ck.save(a, 1, tree, device="cuda", shardings=named)
        ck.save(b, 1, tree, device="cuda")
        da, db = os.path.join(a, "step_00000001"), os.path.join(b,
                                                                "step_00000001")
        ma = json.load(open(os.path.join(da, "manifest.json")))
        mb = json.load(open(os.path.join(db, "manifest.json")))
        ma.pop("time"), mb.pop("time")
        check(ma == mb, "manifests differ between a save under the mesh "
              "and one without")
        for e in ma["leaves"].values():
            check(open(os.path.join(da, e["file"]), "rb").read()
                  == open(os.path.join(db, e["file"]), "rb").read(),
                  f"{e['file']} differs between the saves")
        with shd.use_mesh(mesh):
            got, _ = ck.load(a, 1, tree, device="cuda", shardings=named)
        check(all(torch.equal(x, y) for x, y in zip(
            tree_leaves(got["params"]) + tree_leaves(got["opt"].m),
            tree_leaves(tree["params"]) + tree_leaves(tree["opt"].m))),
            "load(shardings=) is not bit-exact")
        print(f"checkpoint under the mesh: {len(ma['leaves'])} leaf files "
              f"byte-identical to a save without it; load(shardings=) "
              f"bit-exact", flush=True)
    finally:
        shutil.rmtree(MESH_ROOT, ignore_errors=True)


def mesh_cards_check(select: str = "cards and not fsdp and not tp") -> None:
    """With two or more cards, the card tests that ``-k select`` picks (one
    NCCL rank per card, worlds of 2 and up to 4): phase 15's by default,
    phase 16's with ``"fsdp and cards"``, phase 17's with ``"tp and
    cards and not jamba"``, phase 18's with ``"jamba and cards"``; each card
    test runs in exactly one of them."""
    import torch
    n = torch.cuda.device_count()
    if n < 2:
        print("one card: the mesh-bound paths ran at world size 1 (the "
              "multi-rank checks are the -k cards tests, which need two "
              "or more cards)", flush=True)
        return
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-s", "-m",
                        "cuda", "-k", select, "-p", "no:cacheprovider",
                        os.path.join(REPO, "tests", "test_torch_cuda.py")],
                       cwd=REPO, capture_output=True, text=True, timeout=900,
                       env=dict(os.environ, PYTHONPATH=os.path.join(
                           REPO, "src")))
    lines = r.stdout.strip().splitlines()
    for line in lines:
        if " cards" in line and ("rank" in line or "served" in line):
            print(f"  {line.strip()}", flush=True)
    tail = lines[-1] if lines else ""
    print(f"{n} cards: the -k '{select}' tests: {tail}", flush=True)
    check(r.returncode == 0, f"the -k '{select}' tests failed:\n"
          f"{r.stdout[-3000:]}")


def mesh_phase(torch, bp):
    """Phase 15: a NCCL world of one rank, a (1, 1) ('data', 'model') mesh,
    and the mesh-bound paths through it; then, with more cards, the
    multi-rank card tests.  Returns the rb_encode/rb_decode launches of the
    compressed all-reduce."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 1, device="cuda")
    try:
        print(f"mesh {mesh}: NCCL world of {dist.get_world_size()} on "
              f"{torch.cuda.get_device_name(0)}", flush=True)
        launches = compressed_allreduce_check(torch, bp, mesh)
        _free(torch)
        seqshard_decode_check(torch, mesh)
        mesh_train_check(torch, mesh)
        mesh_ckpt_check(torch, mesh)
    finally:
        dist.destroy_process_group()
    _free(torch)
    mesh_cards_check()
    return launches


# --------------------------------------------------------------- phase 16 --

FSDP_STEPS = 4


def _bits(torch, t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_state(torch, a, b):
    """Loss and every parameter, m and v leaf of two (params, opt, metrics)
    step results bit for bit."""
    from repro_torch.models.params import tree_leaves
    return torch.equal(_bits(torch, a[2]["loss"]), _bits(torch, b[2]["loss"])) \
        and all(torch.equal(_bits(torch, x), _bits(torch, y)) for x, y in zip(
            tree_leaves(a[0]) + tree_leaves(a[1].m) + tree_leaves(a[1].v),
            tree_leaves(b[0]) + tree_leaves(b[1].m) + tree_leaves(b[1].v)))


def fsdp_train_check(torch, mesh):
    """h2o-danube-3-4b at its published widths, cut to 2 layers, phase 14's
    settings (batch 2 x 4096, bf16 compute, remat, AdamW lr 3e-4): 4 steps
    of ``make_train_step`` from blocks placed by ``train_shardings``
    (``shardings=``) against 4 steps of the same step on the whole tree,
    bit for bit at every step (loss, parameters, m, v); each step's wall,
    the bytes a rank stores and ``WIRE``'s parameter gathers.  The
    policy's batch axes leave 'model' out, so the steps from blocks take
    the tensor-parallel path: ``WIRE``'s ``tp_all_reduce`` calls must be
    the layer plan's (``tp_plan``), which shows that the path ran, and no
    parameter is gathered."""
    import dataclasses
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.policy import cell_policy
    from repro_torch.models.model import Model, count_params
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    from repro_torch.train.step import make_train_step, train_shardings
    cfg = dataclasses.replace(get_config("h2o-danube-3-4b"),
                              n_layers=DANUBE_LAYERS)
    policy = cell_policy(cfg, dataclasses.replace(
        SHAPES["train_4k"], global_batch=DANUBE_BATCH), mesh)
    check(policy.n_micro == 1, f"danube/2's policy on {mesh}: {policy}")
    model = Model(cfg, device="cuda", seed=0)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=max(TRAIN_STEPS // 10,
                                                          1),
                                total_steps=TRAIN_STEPS)
    named = train_shardings(model, policy, mesh, opt_cfg)
    data = loop.synthetic_data(cfg, DANUBE_BATCH, DANUBE_SEQ, seed=1,
                               device="cuda")
    steps = {"whole": make_train_step(model, opt_cfg, policy),
             "blocks": make_train_step(model, opt_cfg, policy, named)}
    opt = adamw.init(model.params, opt_cfg)
    state = {"whole": (model.params, opt),
             "blocks": (shd.shard_tree(model.params, named[0]),
                        shd.shard_tree(opt, named[1]))}
    del opt
    stored = (fsdp.stored_bytes(state["blocks"][0])
              + fsdp.stored_bytes(state["blocks"][1]))
    walls = {k: [] for k in steps}
    wire = {}
    for s in range(FSDP_STEPS):
        batch = data(s)
        out = {}
        for k, fn in steps.items():
            shd.WIRE.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[k] = fn(*state[k], batch)
            torch.cuda.synchronize()
            walls[k].append((time.perf_counter() - t0) * 1e3)
            if k == "blocks":
                for key, v in shd.WIRE.snapshot().items():
                    wire[key] = wire.get(key, 0) + v
        check(math.isfinite(float(out["blocks"][2]["loss"])),
              f"danube/2 from blocks, step {s + 1}: loss "
              f"{float(out['blocks'][2]['loss'])}")
        check(_same_state(torch, out["blocks"], out["whole"]),
              f"danube/2 step {s + 1} from blocks differs from the "
              f"whole-tree step")
        state = {k: (v[0], v[1]) for k, v in out.items()}
        loss = float(out["blocks"][2]["loss"])
        print(f"danube/2 step {s + 1}: loss {loss:.4f}, bit-identical from "
              f"blocks; walls from blocks "
              f"{walls['blocks'][-1]:.1f} ms, whole tree "
              f"{walls['whole'][-1]:.1f} ms", flush=True)
    reduces, gathers = tp_plan(cfg, "train")
    check(wire.get("tp_all_reduce", 0) == FSDP_STEPS * reduces,
          f"danube/2 on the tensor-parallel path: {wire.get('tp_all_reduce')}"
          f" tp_all_reduce calls over {FSDP_STEPS} steps, the plan "
          f"{FSDP_STEPS * reduces}")
    check(wire.get("tp_all_gather", 0) == FSDP_STEPS * gathers
          and wire.get("param_gather_bytes", 0) == 0,
          f"danube/2 on the tensor-parallel path gathered: {wire}")
    n_params = count_params(cfg)
    gathers = {k: v for k, v in wire.items()
               if k.startswith(("param_", "grad_", "tp_")) and v}
    print(f"h2o-danube-3-4b/2 from blocks ({mesh}, policy batch axes "
          f"{policy.batch_axes}): {FSDP_STEPS} steps bit-identical to the "
          f"whole-tree step; steps 2-{FSDP_STEPS} walls "
          f"{[round(w, 1) for w in walls['blocks'][1:]]} ms from blocks, "
          f"{[round(w, 1) for w in walls['whole'][1:]]} ms whole (phase 14's "
          f"Trainer steps add the 8-plane EF pass); a rank stores "
          f"{stored / 1e9:.3f} GB of parameters and AdamW state "
          f"({stored / (12 * n_params):.4f} of the whole {12 * n_params / 1e9:.3f} "
          f"GB); tensor-parallel path: tp_all_reduce {reduces} calls a step, "
          f"the layer plan's; collectives over {FSDP_STEPS} steps (0 B at "
          f"n = 1): {gathers}", flush=True)
    del state, out, steps, model
    _free(torch)


def fsdp_serve_check(torch, mesh):
    """qwen2-7b at its published widths and full depth (bf16 weights held)
    served from blocks placed by ``param_shardings``: batch 4, prompt 256,
    16 new tokens; greedy tokens equal and logits bit-identical to the
    plain decode of the whole tree."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.driver import build_inputs
    from repro_torch.models.model import Model
    from repro_torch.train.step import param_shardings
    cfg = get_config("qwen2-7b")
    held = Model(cfg, device="cuda", seed=0).compute_params()
    _free(torch)
    model = Model(cfg, held, device="cuda")
    named = param_shardings(model, mesh)
    blocks = shd.shard_tree(held, named)
    prompts, _ = build_inputs(cfg, SEQ_BATCH, SEQ_PROMPT, device="cuda")
    max_len = SEQ_PROMPT + SEQ_NEW
    plain = _decode(torch, model, held, prompts, SEQ_NEW, max_len)
    shd.WIRE.reset()
    with shd.use_mesh(mesh):
        got = _decode(torch, model, blocks, prompts, SEQ_NEW, max_len,
                      shardings=named)
    wire = _wire(shd)
    check(torch.equal(got[0], plain[0]), "qwen2-7b from blocks: greedy "
          "tokens differ from the plain decode's")
    check(torch.equal(got[1].view(torch.int32), plain[1].view(torch.int32)),
          f"qwen2-7b from blocks: logits are not the plain decode's bits "
          f"(max relative difference {_rel(torch, plain[1], got[1])})")
    print(f"qwen2-7b served from blocks ({mesh}, partition_specs()): batch "
          f"{SEQ_BATCH}, prompt {SEQ_PROMPT}, {SEQ_NEW} new tokens: greedy "
          f"tokens equal, logits bit-identical to the plain decode; "
          f"{got[3]:.2f} ms/token (plain {plain[3]:.2f}), prefill "
          f"{got[2]:.3f} s (plain {plain[2]:.3f}); a rank stores "
          f"{fsdp.stored_bytes(blocks) / 1e9:.3f} GB of weights; collectives "
          f"{wire or 'none (n = 1)'}", flush=True)
    del model, held, blocks, plain, got
    _free(torch)


def fsdp_phase(torch):
    """Phase 16: sharded parameter and AdamW-state storage in a NCCL world
    of one rank on a (1, 1) mesh; then, with more cards, the ``fsdp``
    card tests."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 1, device="cuda")
    try:
        for what, fn in (("(a) danube/2 from blocks", fsdp_train_check),
                         ("(b) qwen2-7b from blocks", fsdp_serve_check)):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fn(torch, mesh)
            print(f"{what}: {time.perf_counter() - t0:.2f} s, peak device "
                  f"memory {_peak_gib(torch):.2f} GiB", flush=True)
    finally:
        dist.destroy_process_group()
    _free(torch)
    mesh_cards_check("fsdp and cards")


# --------------------------------------------------------------- phase 17 --

def tp_plan(cfg, kind: str):
    """(``tp_all_reduce``, ``tp_all_gather``) calls of one step of a dense
    GQA arch whose heads and vocabulary are cut over 'model'
    (h2o-danube-3-4b), by its layer plan.  A train step under remat: per
    layer the 2 row-parallel exits (attention, MLP) in the forward, the
    attention's again in the recompute (``torch.utils.checkpoint`` stops
    once the last tensor the backward saved is back, before the MLP's
    exit, whose output nothing saves) and 4 entries summed in the backward
    (the attention's x, K and V, the MLP's x); outside the stack the
    embedding's sum, the head's entry, and the loss's maximum, sum of
    exponentials and target logit.  A serving step (the prefill or a
    decode step): the 2 exits a layer and the embedding's sum, and the
    logits gathered once."""
    if kind == "train":
        return 7 * cfg.n_layers + 5, 0
    return 2 * cfg.n_layers + 1, 1


def _peak_gib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def tp_serve_check(torch, mesh):
    """h2o-danube-3-4b at its published widths and all 24 layers (bf16
    weights held) served from ``param_shardings(drop_fsdp=True)`` blocks on
    the tensor-parallel path: batch 4, prompt 256, 16 new tokens; greedy
    tokens equal and logits bit-identical to the plain decode of the whole
    tree, ``WIRE``'s tp counts the layer plan's."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.driver import build_inputs
    from repro_torch.models.model import Model
    from repro_torch.train.step import param_shardings
    cfg = get_config("h2o-danube-3-4b")
    held = Model(cfg, device="cuda", seed=0).compute_params()
    _free(torch)
    model = Model(cfg, held, device="cuda")
    named = param_shardings(model, mesh, drop_fsdp=True)
    blocks = shd.shard_tree(held, named)
    prompts, _ = build_inputs(cfg, SEQ_BATCH, SEQ_PROMPT, device="cuda")
    max_len = SEQ_PROMPT + SEQ_NEW
    plain = _decode(torch, model, held, prompts, SEQ_NEW, max_len)
    shd.WIRE.reset()
    with shd.use_mesh(mesh):
        got = _decode(torch, model, blocks, prompts, SEQ_NEW, max_len,
                      shardings=named)
    wire = _wire(shd)
    check(torch.equal(got[0], plain[0]), "danube served on the "
          "tensor-parallel path: greedy tokens differ from the plain decode's")
    check(torch.equal(got[1].view(torch.int32), plain[1].view(torch.int32)),
          f"danube served on the tensor-parallel path: logits are not the "
          f"plain decode's bits (max relative difference "
          f"{_rel(torch, plain[1], got[1])})")
    reduces, gathers = tp_plan(cfg, "serve")
    check(wire.get("tp_all_reduce", 0) == SEQ_NEW * reduces
          and wire.get("tp_all_gather", 0) == SEQ_NEW * gathers
          and not wire.get("param_gather_bytes", 0),
          f"danube served on the tensor-parallel path: WIRE {wire}, the plan "
          f"{SEQ_NEW} x ({reduces}, {gathers})")
    print(f"h2o-danube-3-4b (24 layers) served from blocks ({mesh}, "
          f"param_shardings(drop_fsdp=True)), tensor-parallel: batch "
          f"{SEQ_BATCH}, prompt {SEQ_PROMPT}, {SEQ_NEW} new tokens: greedy "
          f"tokens equal, logits bit-identical to the plain decode; "
          f"{got[3]:.2f} ms/token (plain {plain[3]:.2f}), prefill "
          f"{got[2]:.3f} s (plain {plain[2]:.3f}); a rank stores "
          f"{fsdp.stored_bytes(blocks) / 1e9:.3f} GB of weights; WIRE over "
          f"the prefill and {SEQ_NEW - 1} decode steps {wire}", flush=True)
    del model, held, blocks, plain, got
    _free(torch)


def tp_phase(torch):
    """Phase 17: tensor-parallel compute over 'model' in a NCCL world of one
    rank on a (1, 1) mesh; then, with more cards, the ``tp`` card tests."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 1, device="cuda")
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tp_serve_check(torch, mesh)
        print(f"danube served tensor-parallel: "
              f"{time.perf_counter() - t0:.2f} s, peak device memory "
              f"{_peak_gib(torch):.2f} GiB", flush=True)
    finally:
        dist.destroy_process_group()
    _free(torch)
    mesh_cards_check("tp and cards and not jamba")


# --------------------------------------------------------------- phase 18 --

JAMBA_PERIOD = 8            # one attention layer and seven Mamba layers
REMAT_SEQ = 4096            # SHAPES["train_4k"]'s sequence


def jamba_serve_plan(cfg):
    """(``tp_all_reduce``, ``tp_all_gather``, ``tp_all_to_all``) calls of one
    serving step (the prefill or a decode step) of a jamba config on the
    tensor-parallel path, by its layer plan: a Mamba layer's output and its
    three sums (the delta's low rank, B, C), its conv and SSM states
    gathered whole for the cache, its ``in_proj`` re-cut once; an
    attention layer's output where its heads are cut; each MLP's or MoE's
    combine (and shared experts'); the embedding's sum and the logits
    gathered, where the vocabulary is cut."""
    from repro_torch.models.layers import heads_cut
    from repro_torch.models.transformer import stack_plan
    vocab = int(cfg.vocab_size % 16 == 0)
    reduces, gathers, recuts = vocab, vocab, 0
    for g in stack_plan(cfg):
        for kind in g.kinds:
            if kind.startswith("mamba"):
                reduces += 4 * g.repeats
                gathers += 2 * g.repeats
                recuts += g.repeats
            elif heads_cut(cfg):
                reduces += g.repeats
            shared = kind.endswith("_moe") and cfg.moe.n_shared
            reduces += (2 if shared else 1) * g.repeats
    return reduces, gathers, recuts


def unstack_fan_in(tree, stacked: bool = False):
    """A parameter tree (``Model.params``' nesting) with every stacked leaf
    of 3 or more dims (under ``blocks``) divided in place by the square
    root of its first per-layer dim; returns ``tree``.  ``tree_init``
    takes a stacked leaf's fan-in from its leading, repeat axis (the
    reference's rule), so at one repeat every stacked weight is drawn with
    a standard deviation of 1; divided so, the draw has the fan-in of the
    layer's own leaf.  Not the reference's init: for runs of a model at
    its published widths that must stay finite (jamba's 8-layer period
    drawn by the rule overflows float32 in its norms)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            unstack_fan_in(v, stacked or k == "blocks")
        elif stacked and v.dim() >= 3:
            v.data.div_(v.shape[1] ** 0.5)
    return tree


def jamba_serve_check(torch, mesh):
    """jamba-v0.1-52b at its published widths, one period of 8 layers, bf16
    weights (seed 0, the stacked leaves rescaled to the fan-in of the
    layer's own by ``unstack_fan_in``: drawn by the stacked rule, std
    1 at one repeat, the norms overflow and every logit is the same),
    finite logits that differ, served from
    ``param_shardings(drop_fsdp=True)`` blocks on the
    tensor-parallel path (Mamba on its blocks of ``d_inner``, ``in_proj``
    re-cut): batch 4, prompt 256, 16 new tokens; greedy tokens equal and
    logits bit-identical to the plain decode of the whole tree, ``WIRE``'s
    tp counts the layer plan's."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.driver import build_inputs
    from repro_torch.models.model import Model, count_params
    from repro_torch.train.step import param_shardings
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              n_layers=JAMBA_PERIOD)
    model = Model(cfg, device="cuda", seed=0)
    unstack_fan_in(model.params)
    held = model.compute_params()
    prompts, _ = build_inputs(cfg, SEQ_BATCH, SEQ_PROMPT, device="cuda")
    max_len = SEQ_PROMPT + SEQ_NEW
    plain = _decode(torch, model, held, prompts, SEQ_NEW, max_len)
    spread = float(plain[1].float().std())
    check(bool(torch.isfinite(plain[1]).all()) and spread > 0,
          f"jamba's plain decode: logits not finite or all equal (std "
          f"{spread})")
    named = param_shardings(model, mesh, drop_fsdp=True)
    blocks = shd.shard_tree(held, named)
    del model, held
    _free(torch)
    model = Model(cfg, blocks, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    shd.WIRE.reset()
    with shd.use_mesh(mesh):
        got = _decode(torch, model, blocks, prompts, SEQ_NEW, max_len,
                      shardings=named)
    wire = _wire(shd)
    check(torch.equal(got[0], plain[0]), "jamba served on the "
          "tensor-parallel path: greedy tokens differ from the plain decode's")
    check(torch.equal(got[1].view(torch.int32), plain[1].view(torch.int32)),
          f"jamba served on the tensor-parallel path: logits are not the "
          f"plain decode's bits (max relative difference "
          f"{_rel(torch, plain[1], got[1])})")
    plan = jamba_serve_plan(cfg)
    counts = tuple(shd.WIRE.snapshot()[k] for k in (
        "tp_all_reduce", "tp_all_gather", "tp_all_to_all"))
    check(counts == tuple(SEQ_NEW * x for x in plan)
          and not wire.get("param_gather_bytes", 0),
          f"jamba served on the tensor-parallel path: (tp_all_reduce, "
          f"tp_all_gather, tp_all_to_all) {counts}, the plan {SEQ_NEW} x "
          f"{plan}; WIRE {wire}")
    print(f"jamba-v0.1-52b, one period ({JAMBA_PERIOD} of 32 layers, "
          f"{count_params(cfg):,} params), served from blocks ({mesh}, "
          f"param_shardings(drop_fsdp=True)), tensor-parallel with Mamba on "
          f"its blocks: batch {SEQ_BATCH}, prompt {SEQ_PROMPT}, {SEQ_NEW} new "
          f"tokens: greedy tokens equal, logits bit-identical to the plain "
          f"decode; {got[3]:.2f} ms/token (plain {plain[3]:.2f}), prefill "
          f"{got[2]:.3f} s (plain {plain[2]:.3f}); a rank stores "
          f"{fsdp.stored_bytes(blocks) / 1e9:.3f} GB of weights; peak device "
          f"memory of the block run {_peak_gib(torch):.2f} GiB; (tp_all_reduce, "
          f"tp_all_gather, tp_all_to_all) a step {plan}, the layer plan's; "
          f"WIRE over the prefill and {SEQ_NEW - 1} decode steps {wire}",
          flush=True)
    del model, blocks, plain, got
    _free(torch)


# the loop's figures for phase 18 (b) before the scans were kernels: a
# layer's peak over its parameters and inputs with the chunks, and the wall
# of its forward and backward, 1 x 4096 (chip_smoke.py, NVIDIA H100 80GB
# HBM3, 700.00 W)
LOOP_PEAK_GIB = {"Mamba": 1.447, "RWKV6": 0.997}
LOOP_WALL_S = {"Mamba": 6.37, "RWKV6": 5.21}
SCAN_GRAD_TOL = 1e-4        # of a gradient's largest |value|


class _LoopScans:
    """Within it the SSM layers run their scans as the CPU's loop
    (``ssm._scan``, chunked) on the card too: the yardstick the kernels'
    layer path is held against here, by patching the layers' dispatch."""

    def __enter__(self):
        from repro_torch.models import ssm
        self.ssm, self.was = ssm, ssm._on_operators
        ssm._on_operators = lambda t: False

    def __exit__(self, *exc):
        self.ssm._on_operators = self.was


def _requested(torch, which: str) -> int:
    """The caching allocator's bytes requested by tensors (``current`` or
    ``peak``): the program's own demand, without the rounding of the
    blocks that serve it."""
    return torch.cuda.memory_stats()[f"requested_bytes.all.{which}"]


def _max_rel(torch, a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / max(float(b.double().abs().max()), 1e-30))


def scan_layers_check(torch):
    """One Mamba layer at jamba-v0.1-52b's widths and one RWKV6 time mix at
    rwkv6-3b's, 1 x 4096 tokens, the loss ``sum(out * cot)`` and its
    gradients (x and every leaf), forward and backward through the scan
    kernels (the card's path) and through the loop (``_LoopScans``):
    at the config's dtypes the kernels' peak over what was allocated
    before, in bytes requested (held at or below the loop's figures,
    ``LOOP_PEAK_GIB``; the allocated peak, which moves by the caching
    allocator's rounding with the blocks earlier phases leave live, and
    the loop's in this run are printed beside it) and
    wall beside the loop's, and the gradients' largest difference (bf16
    compute: reported, a float32 difference in the scan may move a bf16
    rounding by one ulp); in float32 compute and parameters every gradient
    within ``SCAN_GRAD_TOL`` of its largest |value| (after a warm-up of
    both paths at 128 tokens)."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import ssm as SSM
    from repro_torch.models.layers import compute_dtype
    from repro_torch.models.params import tree_init, tree_leaves
    from repro_torch.train.step import value_and_grad
    layers = (("Mamba", "jamba-v0.1-52b", SSM.mamba_abstract,
               SSM.mamba_apply),
              ("RWKV6", "rwkv6-3b", SSM.rwkv_time_mix_abstract,
               SSM.rwkv_time_mix_apply))
    for what, arch, abstract, apply in layers:
        for f32 in (False, True):
            cfg = get_config(arch)
            if f32:
                cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                          param_dtype="float32")
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = tree_init(abstract(cfg), gen, cfg.param_dtype, "cuda")
            x, cot = (torch.randn((1, REMAT_SEQ, cfg.d_model), generator=gen,
                                  device="cuda").to(compute_dtype(cfg))
                      for _ in range(2))

            def grads(t):
                return value_and_grad(lambda q: torch.sum(
                    apply(q["p"], q["x"], cfg)[0].float() * q["c"].float()),
                    {"p": params, "x": t, "c": cot[:, :t.shape[1]]})[1]
            paths = {"kernels": contextlib.nullcontext(),
                     "loop": _LoopScans()}
            for ctx in paths.values():         # warm-up at 128 tokens
                with ctx:
                    grads(x[:, :128])
            runs = {}
            for path, ctx in paths.items():
                _free(torch)
                torch.cuda.synchronize()
                base = (torch.cuda.memory_allocated(),
                        _requested(torch, "current"))
                torch.cuda.reset_peak_memory_stats()
                with ctx:
                    t0 = time.perf_counter()
                    g = grads(x)
                    torch.cuda.synchronize()
                runs[path] = (tree_leaves(g), time.perf_counter() - t0,
                              (_requested(torch, "peak") - base[1]) / 2 ** 30,
                              (torch.cuda.max_memory_allocated() - base[0])
                              / 2 ** 30)
                del g
            errs = [_max_rel(torch, a, b) for a, b in
                    zip(runs["kernels"][0], runs["loop"][0])]
            dtypes = (f"{cfg.compute_dtype} compute, {cfg.param_dtype} "
                      f"parameters")
            if f32:
                check(max(errs) <= SCAN_GRAD_TOL,
                      f"{what} ({dtypes}): kernel gradients differ from the "
                      f"loop's by up to {max(errs):.3g} of their largest")
            else:
                check(runs["kernels"][2] <= LOOP_PEAK_GIB[what],
                      f"{what}: the kernels' peak {runs['kernels'][2]:.4f} "
                      f"GiB requested over the loop's {LOOP_PEAK_GIB[what]} "
                      f"GiB")
            print(f"{what} ({arch}, {dtypes}), 1 x {REMAT_SEQ} tokens, "
                  f"forward and backward: kernels {runs['kernels'][1]:.3f} "
                  f"s, peak {runs['kernels'][2]:.4f} GiB requested "
                  f"({runs['kernels'][3]:.4f} allocated) over the parameters "
                  f"and inputs; loop {runs['loop'][1]:.3f} s, "
                  f"{runs['loop'][2]:.4f} GiB ({runs['loop'][3]:.4f}; "
                  f"recorded {LOOP_WALL_S[what]} s, {LOOP_PEAK_GIB[what]} "
                  f"GiB allocated); "
                  f"gradients (x and {len(errs) - 1} leaves) within "
                  f"{max(errs):.3g} of their largest |value| of the loop's"
                  + (f" (held at {SCAN_GRAD_TOL:g})" if f32 else
                     " (reported)"), flush=True)
            del params, x, cot, runs
            _free(torch)


def jamba_phase(torch):
    """Phase 18: jamba's period served from TP blocks in a NCCL world of one
    rank on a (1, 1) mesh, the scan layers at full width through the
    kernels against the loop; then, with more cards, the ``jamba and
    cards`` card tests."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 1, device="cuda")
    try:
        for what, fn in (("(a) jamba's period served tensor-parallel",
                          lambda: jamba_serve_check(torch, mesh)),
                         ("(b) the scan layers: kernels against the loop",
                          lambda: scan_layers_check(torch))):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fn()
            print(f"{what}: {time.perf_counter() - t0:.2f} s, peak device "
                  f"memory {_peak_gib(torch):.2f} GiB", flush=True)
    finally:
        dist.destroy_process_group()
    _free(torch)
    mesh_cards_check("jamba and cards")


# --------------------------------------------------------------- phase 19 --

def _op_diff(a, b):
    """The operators whose count or bytes differ between two
    ``ops_by_name`` tables: {name: (a's, b's)}."""
    return {k: (a.get(k), b.get(k)) for k in sorted(set(a) | set(b))
            if a.get(k) != b.get(k)}


def fused_program_check(torch, bp, x_np):
    """The fused write program (``fused_encode_plan(...).run``) for Isabel's
    chunk at the default config, counted twice: on the card, run for real
    under ``OpAnalysis``, and by ``CostModel`` on ``meta`` (nothing
    executed).  FLOPs, bytes and every operator's count and bytes equal;
    the kernels' operators equal the launches ``bp``'s counters saw; the
    byte bound at 3.35 TB/s no more than the measured wall."""
    from repro_torch.core import decompose as dc
    from repro_torch.core import refactor as rf
    from repro_torch.core import refactor_fused as rff
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.tune import cost as tc
    from repro_torch.tune.config import DEFAULT_CONFIG as cfg
    mag_bits = cfg.resolved_mag_bits()
    plan = rff.fused_encode_plan(
        ISABEL_SHAPE, dc.num_levels(ISABEL_SHAPE), cfg.design, mag_bits,
        tuple(rf._group_plane_split(mag_bits, cfg.group_size)), cfg.backend)
    x = torch.from_numpy(x_np).to("cuda")
    walls = []
    for _ in range(4):                       # the first is a warmup
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan.run(x)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls[1:])
    bp.reset_launches()
    t0 = time.perf_counter()
    with OpAnalysis() as ana:
        plan.run(x)
    torch.cuda.synchronize()
    wall_counted = time.perf_counter() - t0
    card = ana.summary()
    launches = read_launches(bp, ("rb_encode",), "phase-19 (a) launches")
    t0 = time.perf_counter()
    model = tc.CostModel(ISABEL_SHAPE)
    cost = model.cost(cfg)
    meta = tc.program_analysis(ISABEL_SHAPE, None, cfg)
    meta_s = time.perf_counter() - t0
    diff = _op_diff(card["ops_by_name"], meta["ops_by_name"])
    check(not diff, f"fused program: card and meta operators differ: {diff}")
    check(card["flops_per_device"] == meta["flops_per_device"] == cost.flops
          and card["hbm_bytes_per_device"] == meta["hbm_bytes_per_device"]
          == cost.hbm_bytes, f"fused program: card {card['flops_per_device']}"
          f" FLOP / {card['hbm_bytes_per_device']} B, meta "
          f"{meta['flops_per_device']} / {meta['hbm_bytes_per_device']}, "
          f"model {cost}")
    kernels = {k.split(".")[1]: v["count"] for k, v in
               card["ops_by_name"].items() if k.startswith("repro_torch.")}
    check(kernels and all(launches[k] == n for k, n in kernels.items())
          and sum(launches.values()) == sum(kernels.values()),
          f"kernel operators {kernels} against launches {launches}")
    predicted = cost.seconds(tc.NOMINAL_PEAKS["gpu"])
    check(predicted <= wall, f"the byte bound {predicted} s exceeds the "
          f"measured wall {wall} s")
    print(f"fused write program {ISABEL_SHAPE} (default config): "
          f"{sum(v['count'] for v in card['ops_by_name'].values())} "
          f"operators, {card['hbm_bytes_per_device'] / 1e9:.4f} GB, "
          f"{card['flops_per_device']} FLOP, temp "
          f"{card['temp_bytes'] / 1e9:.4f} GB; card == meta operator by "
          f"operator (meta counted in {meta_s:.2f} s); kernel operators "
          f"{kernels} == launches; predicted {predicted * 1e3:.3f} ms at "
          f"3.35 TB/s, measured {wall * 1e3:.3f} ms (median of 3 warm; "
          f"{wall_counted * 1e3:.3f} ms under the analysis): measured / "
          f"predicted {wall / predicted:.2f}", flush=True)
    top = sorted(card["ops_by_name"].items(), key=lambda kv: -kv[1]["bytes"])
    print("  top operators by bytes: " + ", ".join(
        f"{k} x{v['count']} {v['bytes'] / 1e9:.3f} GB" for k, v in top[:6]),
        flush=True)


def train_step_check(torch, mesh):
    """danube/2's one-rank train step at phase 14's settings (2 x 4096, bf16
    compute, remat, a (1, 1) mesh), counted two ways: ``dryrun.measure``'s
    fake count on ``meta`` and a real step on the card under
    ``OpAnalysis``.  FLOPs and bytes within 1% (the operators that
    dispatch differently listed), the allocator's peak over the step
    within [0.80, 1.25] x (arguments + temp bytes), and neither bound
    (FLOPs at 989 TFLOP/s, bytes at 3.35 TB/s) above the step's wall."""
    from repro_torch.launch import dryrun
    spec = dryrun.cell_spec(
        "h2o-danube-3-4b", "train_4k", "single",
        overrides={"n_layers": DANUBE_LAYERS},
        shape_dims=("train", DANUBE_SEQ, DANUBE_BATCH),
        mesh_dims=((1, 1), ("data", "model")))
    t0 = time.perf_counter()
    fake = dryrun.measure(spec, mesh, fake=True)
    fake_s = time.perf_counter() - t0
    _free(torch)
    held = torch.cuda.memory_allocated()
    real = dryrun.measure(spec, mesh, fake=False, device="cuda")
    _free(torch)
    diff = _op_diff(real["ops_by_name"], fake["ops_by_name"])
    for k, (r, f) in diff.items():
        print(f"  card {r} / meta {f}: {k}", flush=True)
    fl, fb = real["flops_per_device"], real["hbm_bytes_per_device"]
    ml, mb = fake["flops_per_device"], fake["hbm_bytes_per_device"]
    check(abs(fl - ml) <= 0.01 * ml and abs(fb - mb) <= 0.01 * mb,
          f"danube/2 step: card {fl} FLOP / {fb} B, meta {ml} / {mb}")
    mem, dev = fake["memory"], real["memory"]["device"]
    ratio = dev["max_allocated"] / mem["peak_bytes"]
    check(0.80 <= ratio <= 1.25, f"danube/2 step: the card's peak "
          f"{dev['max_allocated']} B is {ratio:.3f} x the predicted "
          f"{mem['peak_bytes']} B")
    wall = real["wall_s"]
    check(fl / BF16_FLOPS <= wall and fb / HBM_BYTES_PER_S <= wall,
          f"a bound above the wall {wall} s: {fl / BF16_FLOPS} s (FLOP), "
          f"{fb / HBM_BYTES_PER_S} s (bytes)")
    print(f"danube/2 train step, 2 x 4096: FLOP card {fl} / meta {ml} "
          f"({'equal' if fl == ml else f'{fl / ml - 1:+.2e}'}), bytes card "
          f"{fb / 1e9:.3f} GB / meta {mb / 1e9:.3f} GB "
          f"({'equal' if fb == mb else f'{fb / mb - 1:+.2e}'}), "
          f"{len(diff)} operator(s) dispatched differently; arguments "
          f"{mem['argument_bytes'] / 1e9:.3f} GB, temp (meta) "
          f"{mem['temp_bytes'] / 1e9:.3f} GB, temp (card count) "
          f"{real['memory']['temp_bytes'] / 1e9:.3f} GB; allocated before "
          f"the run {held / 1e9:.3f} GB, at the "
          f"step's start {dev['allocated_at_start'] / 1e9:.3f} GB, peak "
          f"{dev['max_allocated'] / 1e9:.3f} GB = {ratio:.3f} x predicted "
          f"{mem['peak_bytes'] / 1e9:.3f} GB; wall {wall * 1e3:.1f} ms "
          f"(first step, under the analysis) against "
          f"{fl / BF16_FLOPS * 1e3:.2f} ms (FLOP at 989 TFLOP/s) and "
          f"{fb / HBM_BYTES_PER_S * 1e3:.2f} ms (bytes at 3.35 TB/s); the "
          f"meta count took {fake_s:.1f} s", flush=True)


def scan_workspace_check(torch):
    """One ``wkv6_bwd`` call at rwkv6-3b's widths and one ``mamba_scan_bwd``
    call at jamba's, 1 x 4096 (the training path's chunk of 64), counted
    by ``OpAnalysis`` on ``meta`` (its outputs and its declared workspace,
    ``bitplane.WORKSPACE``) and run on the card: the caching allocator's
    peak rise over the call in bytes requested equals the ``meta`` temp,
    and in bytes allocated exceeds it by no more than the allocator's
    rounding (512 bytes an allocation)."""
    from repro_torch.kernels import bitplane as bp
    from repro_torch.kernels import scan as sc
    from repro_torch.launch.op_analysis import OpAnalysis
    gen = torch.Generator(device="cuda").manual_seed(19)
    for kind, fwd, bwd, op in (
            ("wkv6", sc.wkv6_fwd, sc.wkv6_bwd,
             torch.ops.repro_torch.wkv6_bwd.default),
            ("mamba", sc.mamba_scan_fwd, sc.mamba_scan_bwd,
             torch.ops.repro_torch.mamba_scan_bwd.default)):
        args = _scan_inputs(torch, kind, 1, SCAN_SEQ, gen)
        out, fin, states = fwd(*args, 64, True)
        call = (*args[:5], states,
                torch.randn(out.shape, generator=gen, device="cuda"),
                torch.randn(fin.shape, generator=gen, device="cuda"))
        del out, fin
        meta = [t.to("meta") for t in call]
        with OpAnalysis() as ana:
            grads = bwd(*meta, 64)
        temp = ana.summary()["temp_bytes"]
        workspace = bp.WORKSPACE[op](*meta, 64)
        n_alloc = len(grads) + len(workspace)
        del grads
        _free(torch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = (torch.cuda.memory_allocated(), _requested(torch, "current"))
        grads = bwd(*call, 64)
        torch.cuda.synchronize()
        requested = _requested(torch, "peak") - base[1]
        allocated = torch.cuda.max_memory_allocated() - base[0]
        check(requested == temp and 0 <= allocated - temp <= 512 * n_alloc,
              f"{kind} backward: the card's peak rise {requested} B "
              f"requested, {allocated} B allocated, against the meta "
              f"count's temp {temp} B")
        print(f"{kind} backward, 1 x {SCAN_SEQ} (workspace "
              f"{', '.join(f'{k} {tuple(v)}' for k, v in workspace.items())}"
              f"): meta temp {temp} B (outputs and workspace) == the card's "
              f"peak rise in bytes requested {requested} B; allocated "
              f"{allocated} B (+{allocated - temp} B of the allocator's "
              f"rounding, {n_alloc} allocations)", flush=True)
        del args, states, call, meta, grads
        _free(torch)


def analysis_phase(torch, bp, x_np):
    """Phase 19: the dispatched-op analysis and the cost model against the
    card: (a) the fused write program, card and ``meta``; (b) danube/2's
    train step in a NCCL world of one rank on a (1, 1) mesh, card and the
    dry run's fake count.  (c), the scan backwards' workspace, runs first,
    after the build (``main``)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    fused_program_check(torch, bp, x_np)
    print(f"(a) the fused write program: {time.perf_counter() - t0:.2f} s",
          flush=True)
    mesh = make_host_mesh(1, 1, device="cuda")
    try:
        t0 = time.perf_counter()
        train_step_check(torch, mesh)
        print(f"(b) danube/2's train step: {time.perf_counter() - t0:.2f} s",
              flush=True)
    finally:
        dist.destroy_process_group()
    _free(torch)


# --------------------------------------------------------------- phase 20 --

SCAN_SEQ = 4096                # SHAPES["train_4k"]'s sequence
SCAN_EDGES = (1, 63, 64, 200)  # either side of a chunk, a ragged last one
RWKV_HEADS = 40                # rwkv6-3b: d_model 2560 in heads of 64
MAMBA_D, MAMBA_N = 8192, 16    # jamba-v0.1-52b: expand 2 x 4096, d_state 16
MAMBA_BLOCK_D = MAMBA_D // 4   # its 'model' block of channels on (1, 4)
F32_FLOP_PER_S = 67e12         # H100 SXM data sheet, outside the tensor cores
EXP_PER_S = 4.18e12            # 132 SMs x 16 SFU lanes x 1.98 GHz boost
SCAN_OUT_TOL = 1e-5            # of max|out|: sums over k or s in another order
SCAN_STEPS = 3
SPLIT_BATCHES = (2, 4)         # mamba_scan_fwd's batches past B = 1
SCAN_KERNELS = r"(wkv6|mamba|sum_middle)_\w*kernel"   # their device names
SCAN_TPU = "src/repro/models/ssm.py"
# flops of each (b, t, h, k, v) of a wkv and each (b, t, d, s) of a scan
# (a multiply-add counts two), and the scans' expf
WKV_FWD_OPS, WKV_BWD_OPS = 7, 20     # fwd: k v, u kv, + S, r *, + y, w S, +
MAMBA_FWD_OPS, MAMBA_BWD_OPS = 6, 19  # bwd: the recompute and the gradients


def _scan_inputs(torch, kind, b, s, gen, d=MAMBA_D, m=MAMBA_N):
    """A scan's inputs in their models' ranges, float32 on the card: RWKV's
    decay exp(-exp(.)) over the clamp's [-8, 4]; Mamba's A in [-16, -1],
    dt a softplus (``d`` channels, ``m`` states)."""
    def n(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def uni(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device="cuda")
    if kind == "wkv6":
        h = RWKV_HEADS
        return (n(b, s, h, 64), n(b, s, h, 64), n(b, s, h, 64),
                torch.exp(-torch.exp(uni(-8.0, 4.0, b, s, h, 64))),
                n(h, 64), n(b, h, 64, 64))
    return (n(b, s, d), torch.nn.functional.softplus(n(b, s, d) - 3.0),
            n(b, s, m), n(b, s, m), -torch.exp(uni(0.0, math.log(16.0), d, m)),
            n(b, d, m))


def _ulps(torch, a, b) -> int:
    """The largest distance in float32 ulps between ``a`` and ``b``."""
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    # map the sign-magnitude bits onto a line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def _scan_bound(kind, args, keep, backward):
    """(bound ms, bound_by, bytes, flops, expf) of one call: each input
    read once and each output written once over 3.35 TB/s, against the
    flops over the float32 rate and the expf over the SFUs'."""
    nbytes = sum(t.numel() * 4 for t in args)
    b, s = args[0].shape[:2]
    states = -(-s // 64) * args[5][0].numel() * b
    if kind == "wkv6":
        elems = args[0].numel() * 64
        flops = (WKV_BWD_OPS if backward else WKV_FWD_OPS) * elems
        exps = 0
    else:
        elems = args[0].numel() * args[4].shape[1]
        flops = (MAMBA_BWD_OPS if backward else MAMBA_FWD_OPS) * elems
        exps = elems
    if backward:         # + the states and both upstream gradients in, one
        nbytes += 4 * states + 4 * (args[0].numel() + args[5].numel())
    else:                # gradient out an input; out, the final state
        nbytes += 4 * (args[0].numel() + args[5].numel()) + (
            4 * states if keep else 0)
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": max(flops / F32_FLOP_PER_S, exps / EXP_PER_S)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by, nbytes, flops, exps


def _scan_case(torch, sc, kind, args, gen, chunk=64):
    """One scan kernel pair against its plain versions on ``args``: the
    states' ulps (Mamba's must be 0, wkv6's at most 2), the output's and
    the gradients' errors, checked; for Mamba a second backward call must
    give the same bits.  Returns what the timings need."""
    names = ("wkv6_fwd", "wkv6_bwd") if kind == "wkv6" else (
        "mamba_scan_fwd", "mamba_scan_bwd")
    fwd, bwd = getattr(sc, names[0]), getattr(sc, names[1])
    pf, pb = sc.PLAIN[names[0]], sc.PLAIN[names[1]]
    what = f"{names[0]} {tuple(args[0].shape)}"
    got, want = fwd(*args, chunk, True), pf(*args, chunk, True)
    torch.cuda.synchronize()
    ulps = max(_ulps(torch, got[i], want[i]) for i in (1, 2))
    check(ulps <= (2 if kind == "wkv6" else 0),
          f"{what}: states {ulps} ulp from the plain loop's")
    out_err = _max_rel(torch, got[0], want[0])
    check(out_err <= SCAN_OUT_TOL, f"{what}: out within {out_err:.3g} of "
          f"max|out|")
    cot = (torch.randn(got[0].shape, generator=gen, device="cuda"),
           torch.randn(got[1].shape, generator=gen, device="cuda"))
    gk = bwd(*args[:5], want[2], *cot, chunk)
    gp = pb(*args[:5], want[2], *cot, chunk)
    errs = [_max_rel(torch, x, y) for x, y in zip(gk, gp)]
    check(max(errs) <= SCAN_GRAD_TOL, f"{names[1]} {tuple(args[0].shape)}: "
          f"gradients within {[f'{e:.3g}' for e in errs]} of their largest "
          f"|value|")
    same = ""
    if kind == "mamba":
        again = bwd(*args[:5], want[2], *cot, chunk)
        check(all(torch.equal(x, y) for x, y in zip(gk, again)),
              f"{names[1]} {tuple(args[0].shape)}: two calls differ")
        same = ", two backward calls bit-identical"
    print(f"{kind} {tuple(args[0].shape)}: states "
          + ("bit-identical" if ulps == 0 else f"within {ulps} ulp")
          + f" to the loop's, out within {out_err:.3g} of max|out|, "
          f"gradients within {max(errs):.3g}{same}", flush=True)
    return names, got, want, cot, gk, gp


def _scan_times(torch, sc, kind, args, case, chunk=64):
    """The kernels' times at ``args`` (the training path's calls, keep):
    through the wrapper back to back, a replayed CUDA graph (the working
    sets exceed the L2), the plain versions', and the bound."""
    names, got, want, cot, gk, gp = case
    fwd, bwd = getattr(sc, names[0]), getattr(sc, names[1])
    pf, pb = sc.PLAIN[names[0]], sc.PLAIN[names[1]]
    rows = {}
    for name, call, plain, back in (
            (names[0], lambda: fwd(*args, chunk, True),
             lambda: pf(*args, chunk, True), False),
            (names[1], lambda: bwd(*args[:5], want[2], *cot, chunk),
             lambda: pb(*args[:5], want[2], *cot, chunk), True)):
        bound, by, nbytes, flops, exps = _scan_bound(kind, args, True, back)
        err = (max(float((x - y).abs().max()) for x, y in zip(gk, gp))
               if back else float((got[0] - want[0]).abs().max()))
        rows[name] = dict(
            ms=time_ms(call, reps=5, inner=3, warmup=2),
            device_ms=time_ms(call, reps=5, inner=3, warmup=2, graph=True),
            plain_ms=time_ms(plain, reps=1, inner=1, warmup=1),
            bound_ms=bound, bound_by=by, max_abs_err=err, bytes=nbytes,
            flops=flops, exps=exps, shape=tuple(args[0].shape))
    return rows


def _print_scan_row(name, r):
    print(f"{name} at {r['shape']}: wrapper {r['ms']:.3f} ms back to "
          f"back, device {r['device_ms']:.3f} ms (graph replay), plain "
          f"loop {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}: {r['bytes'] / 1e6:.1f} MB, "
          f"{r['flops'] / 1e9:.2f} GFLOP, {r['exps'] / 1e6:.0f}M expf), "
          f"device / bound {r['device_ms'] / r['bound_ms']:.1f}, max abs "
          f"err {r['max_abs_err']:.3g}", flush=True)


def scan_kernels_check(torch, sc):
    """Phase 20 (a): each scan kernel against its plain version on the card
    at rwkv6-3b's and jamba's widths, 1 x 4096 and 2 x each edge length,
    and Mamba's also at 1 x 4096 on a (1, 4) block of jamba's channels
    (``MAMBA_BLOCK_D``): the final and kept states bit-identical (wkv6's
    else at most 2 ulp, named), the outputs within ``SCAN_OUT_TOL`` of
    max|out|, every gradient within ``SCAN_GRAD_TOL`` of its largest
    |value|, Mamba's backward the same bits on a second call; then each
    kernel's time at 1 x 4096 (``_scan_times``), Mamba's at both widths.
    Returns the rows by kernel name (the block's under ``"block"``)."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    rows = {}
    for kind in ("wkv6", "mamba"):
        for b, s in ((1, SCAN_SEQ),) + tuple((2, e) for e in SCAN_EDGES):
            args = _scan_inputs(torch, kind, b, s, gen)
            case = _scan_case(torch, sc, kind, args, gen)
            if s == SCAN_SEQ:
                rows.update(_scan_times(torch, sc, kind, args, case))
            del args, case
    args = _scan_inputs(torch, "mamba", 1, SCAN_SEQ, gen, d=MAMBA_BLOCK_D)
    block = _scan_times(torch, sc, "mamba", args,
                        _scan_case(torch, sc, "mamba", args, gen))
    del args
    for name, r in rows.items():
        _print_scan_row(name, r)
        if name in block:
            r["block"] = block[name]
            _print_scan_row(name, block[name])
    rows["mamba_scan_fwd"]["splits"] = split_times(torch, sc, gen)
    return rows


def split_times(torch, sc, gen):
    """``mamba_scan_fwd`` at jamba's widths, B x 4096 for B in
    ``SPLIT_BATCHES``, at one and at two states a thread
    (``mamba_scan_fwd_at_split``) beside the kernel's own pick: the states
    and the final state the same bits at both splits, y within
    ``SCAN_OUT_TOL``; each split's device time (graph replay).  Returns
    {batch: {"pick": split, 1: ms, 2: ms}}."""
    out = {}
    for b in SPLIT_BATCHES:
        args = _scan_inputs(torch, "mamba", b, SCAN_SEQ, gen)
        got = {k: sc.mamba_scan_fwd_at_split(k, *args, 64, True)
               for k in (1, 2)}
        check(all(torch.equal(got[1][i], got[2][i]) for i in (1, 2))
              and _max_rel(torch, got[2][0], got[1][0]) <= SCAN_OUT_TOL,
              f"mamba_scan_fwd at B = {b}: splits 1 and 2 differ")
        del got
        ms = {k: time_ms(lambda k=k: sc.mamba_scan_fwd_at_split(
            k, *args, 64, True), reps=5, inner=3, warmup=2, graph=True)
            for k in (1, 2)}
        pick = sc._lib().mamba_scan_fwd_pick(b, MAMBA_D, MAMBA_N)
        out[b] = {"pick": pick, **ms}
        print(f"mamba_scan_fwd at ({b}, {SCAN_SEQ}, {MAMBA_D}): split 1 "
              f"{ms[1]:.3f} ms, split 2 {ms[2]:.3f} ms (device, graph "
              f"replay); fwd_split picks {pick}", flush=True)
        del args
        _free(torch)
    return out


class _ScanClock:
    """CUDA events around every call of the scan wrappers (the models reach
    them through ``sc.wkv6`` and ``sc.mamba_scan``, which look them up at
    each call): the milliseconds between each call's two events, summed.
    The events bracket the wrapper's host work as well as its kernels, so
    where the stream is idle when a call starts, that host work counts too:
    an upper bound on the kernels' device time.  The wrappers' launch
    counts are theirs alone."""

    def __init__(self, torch, sc):
        self.torch, self.sc, self.events = torch, sc, []

    def __enter__(self):
        self.saved = {n: getattr(self.sc, n) for n in self.sc.SYMBOLS}
        for name, fn in self.saved.items():
            def timed(*args, _fn=fn):
                start = self.torch.cuda.Event(enable_timing=True)
                end = self.torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*args)
                end.record()
                self.events.append((start, end))
                return out
            setattr(self.sc, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.sc, name, fn)

    def take_ms(self) -> float:
        """The summed milliseconds of the calls since the last take."""
        self.torch.cuda.synchronize()
        ms = sum(s.elapsed_time(e) for s, e in self.events)
        self.events = []
        return ms


def _scan_layers(cfg) -> int:
    """The layers of ``cfg`` that scan: every RWKV layer's time mix, each
    Mamba layer of a hybrid's plan."""
    from repro_torch.models.transformer import stack_plan
    if cfg.ssm.kind == "rwkv6":
        return cfg.n_layers
    return sum(g.repeats * sum(k.startswith("mamba") for k in g.kinds)
               for g in stack_plan(cfg))


def _scan_train(torch, bp, sc, arch, layers, unstacked, **overrides):
    """``arch`` at its published widths cut to ``layers`` layers, its
    config's ``overrides`` replaced (its stacked leaves rescaled by
    ``unstack_fan_in`` with ``unstacked``):
    ``SCAN_STEPS`` ``make_train_step`` steps of 1 x ``SCAN_SEQ`` on one
    batch, AdamW; the launches of the scan kernels (counters zeroed just
    before), the losses, the step walls, the scan calls' event time a
    step (``_ScanClock``), the ``ssm.scan`` span's host seconds and the
    peak."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.launch.policy import CellPolicy
    from repro_torch.models.model import Model, count_params
    from repro_torch.obs import trace as obs_trace
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    from repro_torch.train.step import make_train_step
    from torch.autograd import DeviceType
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              **overrides)
    model = Model(cfg, device="cuda", seed=0)
    if unstacked:
        unstack_fan_in(model.params)
    policy = CellPolicy(batch_axes=(), n_micro=1, opt_state_dtype="float32",
                        cache_len=0)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                total_steps=SCAN_STEPS)
    fn = make_train_step(model, opt_cfg, policy)
    batch = loop.synthetic_data(cfg, 1, SCAN_SEQ, seed=1, device="cuda")(0)
    params, opt = model.params, adamw.init(model.params, opt_cfg)
    losses, walls = [], []
    _free(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scan_ms = []
    bp.reset_launches()
    with obs_trace.tracing() as tr, _ScanClock(torch, sc) as clock:
        for _ in range(SCAN_STEPS):
            t0 = time.perf_counter()
            params, opt, m = fn(params, opt, batch)
            losses.append(float(m["loss"]))
            walls.append(time.perf_counter() - t0)
            scan_ms.append(clock.take_ms())
    launches = bp.launches()
    span = tr.summary()["spans"].get("ssm.scan", {}).get("total_s", 0.0)
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"{arch}/{layers}: losses {losses} not finite and falling")
    # one more warm step under torch.profiler: the scan kernels' own device
    # time beside the events' bound for the same step
    with _ScanClock(torch, sc) as clock:
        box = {}

        def step():
            box["out"] = fn(params, opt, batch)
        prof, pwalls = _profile(torch, step)
        event_ms = clock.take_ms()
    params, opt, m = box.pop("out")
    evs = prof.key_averages()
    kern = {}
    for e in evs:
        name = re.search(SCAN_KERNELS, e.key)
        if e.device_type == DeviceType.CUDA and name:
            kern[name[0]] = kern.get(name[0], 0.0) + _dev_us(e) / 1e3
    kernel_ms = sum(kern.values())
    busy = _busy_ms(evs)
    check(kernel_ms > 0, f"{arch}/{layers}: the profiler saw no scan kernel")
    print(f"{arch}/{layers}, one more warm step under torch.profiler "
          f"({pwalls[1]:.3f} s of host wall): the scan kernels' own device "
          f"time {kernel_ms:.2f} ms ("
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(kern.items()))
          + f"), {kernel_ms / 1e3 / pwalls[1]:.3f} of the wall and "
          f"{kernel_ms / busy:.3f} of the device's busy {busy:.1f} ms; "
          f"the scan calls' event time (the upper bound) {event_ms:.2f} ms",
          flush=True)
    print(f"{arch} cut to {layers} layers"
          f"{''.join(f', {k}={v}' for k, v in overrides.items())} "
          f"({count_params(cfg):,} params, remat {cfg.remat}), {SCAN_STEPS} "
          f"make_train_step steps of 1 x "
          f"{SCAN_SEQ}: losses {[round(v, 4) for v in losses]}, step walls "
          f"{[round(w, 3) for w in walls]} s, the scan calls' event time "
          f"{[round(v, 2) for v in scan_ms]} ms a step (CUDA events around "
          f"each wrapper call, an upper bound on the kernels' device time; "
          f"{[round(v / 1e3 / w, 3) for v, w in zip(scan_ms, walls)]} of "
          f"the wall), ssm.scan span {span:.3f} s of host time, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    del model, params, opt, m
    _free(torch)
    return cfg, launches


def scan_main_path(torch, bp, sc):
    """Phase 20 (b): the scan kernels on the models' main paths, each run
    with the counters zeroed just before and read just after: rwkv6-3b
    cut to 4 layers and jamba-v0.1-52b's 8-layer period without its MoE
    (seven Mamba layers and dense MLPs: the period with its experts and
    AdamW's state do not fit one card) each trained ``SCAN_STEPS`` steps
    of 1 x 4096, and jamba's period with its MoE prefilling 1 x 4096
    through ``make_prefill_step`` (bf16 weights, ``unstack_fan_in``): the
    loss finite and falling, the logits finite, each kernel's launches
    scanning layers x steps x passes (a forward, its remat recompute, a
    backward), ``adamw_update``'s parameter leaves x steps,
    ``global_sumsq``'s argument blocks of leaves x steps, and no other
    kernel's.  Returns the scan kernels' launches."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import optim as ko
    from repro_torch.models.model import Model, model_abstract
    from repro_torch.models.params import tree_leaves
    from repro_torch.obs import trace as obs_trace
    from repro_torch.train.step import make_prefill_step
    total = {}
    for arch, layers, unstacked, over, fwd, bwd in (
            ("rwkv6-3b", 4, False, {}, "wkv6_fwd", "wkv6_bwd"),
            ("jamba-v0.1-52b", JAMBA_PERIOD, True, {"moe": None},
             "mamba_scan_fwd", "mamba_scan_bwd")):
        cfg, got = _scan_train(torch, bp, sc, arch, layers, unstacked,
                               **over)
        passes = 2 if cfg.remat else 1
        n = _scan_layers(cfg)
        want = {fwd: n * SCAN_STEPS * passes, bwd: n * SCAN_STEPS}
        # and the step's AdamW update, one launch a parameter leaf, and
        # its global norm, one launch an argument block of leaves
        leaves = len(tree_leaves(model_abstract(cfg)))
        updates = leaves * SCAN_STEPS
        norms = -(-leaves // ko.SUM_LEAVES) * SCAN_STEPS
        check(got == dict(dict.fromkeys(got, 0), adamw_update=updates,
                          global_sumsq=norms, **want),
              f"{arch}/{layers} training launches {got}, expected {want}, "
              f"{updates} adamw_update and {norms} global_sumsq")
        print(f"{arch}/{layers} training launches: {want} ({n} scanning "
              f"layers x {SCAN_STEPS} steps x passes), adamw_update "
              f"{updates}, global_sumsq {norms}", flush=True)
        total.update(want)
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              n_layers=JAMBA_PERIOD)
    mamba = _scan_layers(cfg)
    model = Model(cfg, device="cuda", seed=0)
    unstack_fan_in(model.params)
    held = model.compute_params()
    tokens = torch.randint(0, cfg.vocab_size, (1, SCAN_SEQ), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    step = make_prefill_step(model)
    with torch.inference_mode():         # a warm-up at 256 tokens
        step(held, {"tokens": tokens[:, :256]})
    _free(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bp.reset_launches()
    with torch.inference_mode(), obs_trace.tracing() as tr, \
            _ScanClock(torch, sc) as clock:
        t0 = time.perf_counter()
        logits, _ = step(held, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        scan_ms = clock.take_ms()
    got = bp.launches()
    span = tr.summary()["spans"].get("ssm.scan", {}).get("total_s", 0.0)
    check(got["mamba_scan_fwd"] == mamba and not any(
        v for k, v in got.items() if k != "mamba_scan_fwd"),
        f"jamba's period prefill launches {got}, expected {mamba} "
        f"mamba_scan_fwd")
    check(bool(torch.isfinite(logits).all())
          and float(logits.float().std()) > 0,
          "jamba's period prefill: logits not finite or all equal")
    print(f"jamba-v0.1-52b, one period ({JAMBA_PERIOD} layers, {mamba} "
          f"Mamba), bf16 weights held, prefill of 1 x {SCAN_SEQ} through "
          f"make_prefill_step: {wall:.3f} s, the scan calls' event time "
          f"{scan_ms:.2f} ms (CUDA events around each wrapper call, an upper "
          f"bound on the kernels' device time; {scan_ms / 1e3 / wall:.3f} of "
          f"the wall), ssm.scan span {span:.3f} s of host time, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
          f"mamba_scan_fwd launches {got['mamba_scan_fwd']} (layers x "
          f"1 pass), logits finite", flush=True)
    total["mamba_scan_fwd"] += got["mamba_scan_fwd"]
    del model, held, logits
    _free(torch)
    return total


def scan_phase(torch, bp):
    from repro_torch.kernels import scan as sc
    rows = scan_kernels_check(torch, sc)
    _free(torch)
    return rows, scan_main_path(torch, bp, sc)


# --------------------------------------------------------------- phase 21 --

LOSSLESS = ("lossless_stats", "huffman_pack", "huffman_decode", "rle_scan",
            "rle_expand")
LOSSLESS_SOURCE = "src/repro_torch/kernels/csrc/lossless.cu"
# what each replaces: the reference's jitted passes (no Pallas kernel)
LOSSLESS_REPLACES = {"lossless_stats": "src/repro/core/lossless_batch.py:163",
                     "huffman_pack": "src/repro/core/lossless.py:216",
                     "huffman_decode": "src/repro/core/lossless.py:238",
                     "rle_scan": "src/repro/core/lossless.py:265",
                     "rle_expand": "src/repro/core/lossless.py:280"}
LOSSLESS_SIZES = (1, 2, 31, 4095, 4096, 4097, 32767, 32768, 32769, 65537)
LOSSLESS_CONTENTS = ("skewed", "zeros", "uniform", "runs", "one")
# (B, S) buckets of short rows (phase 9's kind), either side of the stats'
# tile rule (kernels.lossless.stats_tiling) and the pack's tickets of two
# and four chunks (kernels.lossless.pack_group)
LOSSLESS_BUCKETS = ((64, 4096), (64, 65537), (263, 16384), (264, 16384),
                    (199, 16385), (400, 16384))
WRITE_SIDE = ("lossless_stats", "huffman_pack")
# the least integer operations a symbol (of S, or of n decoded) each
# function needs: a bin's add and a neighbour's compare; a length's add
# to the offset, two shifts and an OR; a window's shift, a look-up, an add
# and a store; a compare and a count; a store
LOSSLESS_OPS = {"lossless_stats": 2, "huffman_pack": 4, "huffman_decode": 4,
                "rle_scan": 2, "rle_expand": 1}


def _plain_lossless_targets():
    from repro_torch.core import lossless as ll
    from repro_torch.core import lossless_batch as lb
    return {"group_stats": (lb, "_group_stats_plain"),
            "huffman_pack": (ll, "_huffman_pack_plain"),
            "huffman_unpack": (ll, "_huffman_unpack_plain"),
            "rle_scan": (ll, "_rle_scan_plain"),
            "rle_expand": (ll, "_rle_expand_plain")}


def lossless_launches(bp, plain, required, what):
    """The launches since the last reset (printed), the ``required`` ones
    > 0, and no plain lossless pass counted by ``plain`` (a
    ``_PlainCalls`` of ``_plain_lossless_targets``)."""
    got = read_launches(bp, required, what)
    check(not any(plain.values()),
          f"{what}: plain lossless passes ran on the card: {plain}")
    return got


def _lossless_rows(kind, b, s, rng):
    """(B, S) uint8 rows of one content: skewed, all-zero, uniform, runs,
    or one symbol."""
    import numpy as np
    if kind == "skewed":
        return (rng.geometric(0.3, (b, s)) % 256).astype(np.uint8)
    if kind == "zeros":
        return np.zeros((b, s), np.uint8)
    if kind == "uniform":
        return rng.integers(0, 256, (b, s)).astype(np.uint8)
    if kind == "runs":
        reps = rng.integers(1, 300, (b, s // 20 + 2))
        vals = rng.integers(0, 4, (b, s // 20 + 2))
        return np.stack([np.repeat(v, r)[:s] for v, r in zip(vals, reps)]
                        ).astype(np.uint8)
    return np.full((b, s), (7 + b) % 256, np.uint8)


def lossless_case(torch, x):
    """Each lossless kernel against its plain version on the card, on the
    (B, S) uint8 rows ``x``, byte for byte: the stats; the pack with each
    row's codebook from its histogram; the decode of that stream back to
    ``x``; the RLE scan (nruns, and each row's first nruns values and
    lengths); the expand of those runs back to ``x``.  Returns the
    kernels' inputs and each kernel's largest difference."""
    import numpy as np
    from repro_torch.core import lossless as ll
    from repro_torch.core import lossless_batch as lb
    from repro_torch.kernels import lossless as kl
    b, s = x.shape
    errs = {}

    def diff(name, got, want):
        d = max((a.to(torch.int64) - w.to(torch.int64)).abs().max().item()
                if a.numel() else 0 for a, w in zip(got, want))
        check(d == 0 and all(a.shape == w.shape for a, w in zip(got, want)),
              f"{name} (B={b}, S={s}) differs from its plain version by {d}")
        errs[name] = max(errs.get(name, 0), d)

    diff("lossless_stats", kl.lossless_stats(x), lb._group_stats_plain(x))
    hist = lb._group_stats_plain(x)[0].cpu().numpy()
    books = [ll.build_codebook(h) for h in hist]
    lt, ct = (torch.from_numpy(np.stack([bk[i] for bk in books]
                                        ).astype(np.int64)).cuda()
              for i in (0, 1))
    want = ll._huffman_pack_plain(x, lt, ct)
    diff("huffman_pack", kl.huffman_pack(x, lt, ct), want)
    # the stored words, padded to the bucket's longest row, as
    # ``decode_segments`` uploads them
    stored = int(((want[1] + 31) // 32 + 1).max())
    words, offs = want[0][:, :stored].contiguous(), want[2].contiguous()
    luts = [ll._build_decode_lut(*bk) for bk in books]
    ls, ln = (torch.from_numpy(np.stack([lu[i] for lu in luts])).cuda()
              for i in (0, 1))
    dec = ll._huffman_unpack_plain(words, offs, ls, ln, s)
    check(torch.equal(dec, x), f"plain decode (B={b}, S={s}) is not x")
    diff("huffman_decode", (kl.huffman_decode(words, offs, ls, ln, s),),
         (dec,))
    vals, lens, nruns = kl.rle_scan(x)
    pv, pl, pn = ll._rle_scan_plain(x)
    diff("rle_scan", (nruns,), (pn,))
    for r in range(b):
        k = int(pn[r])
        diff("rle_scan", (vals[r, :k], lens[r, :k].to(torch.int64) & 0xFFFF),
             (pv[r, :k], pl[r, :k]))
    rr = int(pn.max())
    rv, rl = pv[:, :rr].contiguous(), pl[:, :rr].to(torch.int32).contiguous()
    out = ll._rle_expand_plain(rv, rl, s)
    check(torch.equal(out, x), f"plain expand (B={b}, S={s}) is not x")
    diff("rle_expand", (kl.rle_expand(rv, rl, s),), (out,))
    return dict(x=x, lt=lt, ct=ct, words=words, offs=offs, ls=ls, ln=ln,
                rv=rv, rl=rl, nruns=pn, total_bits=want[1], errs=errs)


def lossless_edges(torch):
    """Phase 21 (a)'s sizes, buckets and contents: every kernel
    byte-identical to its plain version, and no chunk of these streams
    decoded serially; returns the cases checked and the largest
    differences (0)."""
    import numpy as np
    from repro_torch.kernels import lossless as kl
    rng = np.random.default_rng(21)
    n, errs = 0, {}
    kl.reset_decode_walks()
    shapes = [(b, s) for s in LOSSLESS_SIZES for b in (1, 3)]
    for b, s in shapes + list(LOSSLESS_BUCKETS):
        for kind in LOSSLESS_CONTENTS:
            x = torch.from_numpy(_lossless_rows(kind, b, s, rng)).cuda()
            for k, v in lossless_case(torch, x)["errs"].items():
                errs[k] = max(errs.get(k, 0), v)
            n += 1
    torch.cuda.synchronize()
    check_walks(kl, "phase 21's edge cases")
    return n, errs


def check_walks(kl, what):
    """The decode's walks since the last reset: printed, none serial."""
    walks = kl.decode_walks()
    check(walks["serial"] == 0, f"{what}: {walks['serial']} chunks decoded "
          "serially")
    print(f"{what}: the decode walked {walks['chunks']} chunks, none "
          f"serially, {walks['rounds']} synchronisation rounds (at most "
          f"{walks['max_rounds']} a chunk)", flush=True)


class _Buckets:
    """Records every bucket the batched encoder stacks (the (B, S) uint8
    rows of one group size) while active."""

    def __enter__(self):
        from repro_torch.core import lossless_batch as lb
        self.lb, self.was, self.seen = lb, lb._encode_buckets, []

        def rec(stacked, *args, **kw):
            self.seen.extend(stacked.values())
            return self.was(stacked, *args, **kw)
        lb._encode_buckets = rec
        return self.seen

    def __exit__(self, *exc):
        self.lb._encode_buckets = self.was


def main_path_groups(torch, rf, x_np, pipe, nyx):
    """Groups taken from real writes, one row each: a 4-plane group of
    Isabel's finest piece and its sign plane (phase 3's write), phase 8's
    largest group (a 2**24-value NYX chunk, ``shuffle``) and phase 9's
    kind (a 2**20-value chunk, ``register_block``, the store's write
    path; of the Isabel-shaped field)."""
    groups = {}
    with _Buckets() as seen:
        rf.refactor_array(x_np, "isabel", device="cuda")
    sizes = sorted({int(st.shape[1]) for st in seen})
    big = max(seen, key=lambda st: st.shape[1])
    # the bucket's rows are the piece's 4-plane groups, MSB first: the
    # middle one (planes 8-11 of 23) is neither all zero nor all noise
    groups["isabel 4-plane group"] = big[big.shape[0] // 2:][:1].contiguous()
    sign = [st for st in seen if st.shape[1] == big.shape[1] // 4]
    check(sign, f"no sign-plane bucket among sizes {sizes}")
    groups["isabel sign plane"] = sign[0][:1].contiguous()
    with _Buckets() as seen:
        pipe.ChunkedRefactorPipeline(
            chunk_elems=PIPE_CHUNK, levels=PIPE_LEVELS, design="shuffle",
            use_tune_cache=False, device="cuda").refactor(
                nyx.reshape(-1)[:PIPE_CHUNK], "nyx")
    groups["phase 8 largest group"] = max(
        seen, key=lambda st: st.shape[1])[:1].contiguous()
    u = x_np.reshape(-1)[:1 << 20]
    with _Buckets() as seen:
        pipe.ChunkedRefactorPipeline(
            chunk_elems=1 << 20, design="register_block",
            use_tune_cache=False, device="cuda").refactor(u, "U")
    groups["phase 9 largest group"] = max(
        seen, key=lambda st: st.shape[1])[:1].contiguous()
    for k, g in groups.items():
        print(f"{k}: S = {g.shape[1]}", flush=True)
    return groups


def _lossless_bytes(name, c, cap=False):
    """The bytes each function must move at ``c``'s inputs: inputs read
    once, outputs written once (rle_scan's: this data's runs; the pack's
    stored words, or with ``cap`` its whole (B, S * 16 / 32 + 2) words,
    the floor of a byte-identical output)."""
    b, s = c["x"].shape
    if name == "lossless_stats":
        return b * s + 8 * 257 * b
    if name == "huffman_pack":
        words = b * (s * 16 // 32 + 2) if cap else c["words"].numel()
        return b * s + 16 * 256 * b + 4 * words + 8 * b \
            + 8 * c["offs"].numel()
    if name == "huffman_decode":   # each row's stored words
        words = int(((c["total_bits"] + 31) // 32 + 1).sum())
        return 4 * words + 8 * c["offs"].numel() + 2 * 65536 * b + b * s
    if name == "rle_scan":
        return b * s + 3 * int(c["nruns"].sum()) + 8 * b
    return 5 * c["rv"].numel() + b * s


def lossless_timings(torch, c, what):
    """Each lossless kernel at the (1, S) group ``c`` (a ``lossless_case``):
    ``ms`` through the wrapper back to back, ``device_ms`` a replayed CUDA
    graph over input copies past the L2, the plain version, the bound
    (bytes at 3.35 TB/s or ``LOSSLESS_OPS`` at the INT32 rate), and for
    the histogram ``torch.bincount`` and for the expand
    ``torch.repeat_interleave`` (the same bytes where a row's run lengths
    sum to S, as every segment's do)."""
    from repro_torch.core import lossless as ll
    from repro_torch.core import lossless_batch as lb
    from repro_torch.kernels import lossless as kl
    s = c["x"].shape[1]
    x, words, offs, ls, ln = c["x"], c["words"], c["offs"], c["ls"], c["ln"]
    calls = {
        "lossless_stats": (kl.lossless_stats, lb._group_stats_plain, (x,)),
        "huffman_pack": (kl.huffman_pack, ll._huffman_pack_plain,
                         (x, c["lt"], c["ct"])),
        "huffman_decode": (lambda *a: kl.huffman_decode(*a, s),
                           lambda *a: ll._huffman_unpack_plain(*a, s),
                           (words, offs, ls, ln)),
        "rle_scan": (kl.rle_scan, ll._rle_scan_plain, (x,)),
        "rle_expand": (lambda *a: kl.rle_expand(*a, s),
                       lambda *a: ll._rle_expand_plain(*a, s),
                       (c["rv"], c["rl"]))}
    rows, copied = {}, {}
    for name, (fn, plain, args) in calls.items():
        nbytes = _lossless_bytes(name, c)
        copies = [args] + [tuple(a.clone() for a in args) for _ in range(
            -(-2 * L2_BYTES // max(nbytes, 1)) - 1)]
        copied[name] = copies
        it = itertools.cycle(copies)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = LOSSLESS_OPS[name] * s / INT32_OPS_PER_S * 1e3
        rows[name] = dict(
            case=what, s=s, bytes=nbytes, ms=time_ms(lambda: fn(*args)),
            device_ms=time_ms(lambda: fn(*next(it)), graph=True),
            plain_ms=time_ms(lambda: plain(*args), reps=3, inner=1,
                             warmup=1),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, max_abs_err=c["errs"][name],
            copies=len(copies))
    rows["lossless_stats"]["library_ms"] = time_ms(
        lambda: torch.bincount(x[0], minlength=256))
    write_side_at(torch, c, what, rows)
    rv, rl = c["rv"][0], c["rl"][0]
    check(torch.equal(torch.repeat_interleave(rv, rl, output_size=s), x[0]),
          f"torch.repeat_interleave on {what} is not the group")
    rows["rle_expand"]["library_ms"] = time_ms(
        lambda: torch.repeat_interleave(rv, rl, output_size=s))
    read_side(torch, c, what, rows, copied)
    for name, r in rows.items():
        extra = ""
        if name == "huffman_decode":
            extra = (f"; {r['device_ms'] * 1e6 / min(kl.CHUNK, s):.1f} ns "
                     f"a chunk's code")
        elif name == "lossless_stats":
            extra = f"; torch.bincount {r['library_ms'] * 1e3:.1f} us"
        elif name == "huffman_pack":
            extra = (f"; with the whole cap written: bound "
                     f"{r['floor_ms'] * 1e3:.2f} us "
                     f"({r['floor_bytes'] / 1e6:.2f} MB), device / that "
                     f"{r['device_ms'] / r['floor_ms']:.1f}")
        elif name == "rle_expand":
            extra = (f"; torch.repeat_interleave "
                     f"{r['library_ms'] * 1e3:.1f} us")
        print(f"{name} on {what} (S={s}): kernel {r['ms'] * 1e3:.1f} us "
              f"through the wrapper back to back, device "
              f"{r['device_ms'] * 1e3:.1f} us (graph replay over "
              f"{r['copies']} input copies), plain {r['plain_ms'] * 1e3:.1f}"
              f" us, bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}, "
              f"{r['bytes'] / 1e6:.2f} MB), device / bound "
              f"{r['device_ms'] / r['bound_ms']:.1f}{extra}", flush=True)
    return rows


def write_side_at(torch, c, what, rows):
    """The write side's kernels and ``rle_scan`` at the group ``c``: the
    pack's bound with its whole cap written, and each kernel's device
    activities a call: at most two, the pack's with no bit-count pass and
    no row scan, the scan's with no count kernel and no row scan."""
    from repro_torch.kernels import lossless as kl
    floor = _lossless_bytes("huffman_pack", c, cap=True)
    rows["huffman_pack"].update(floor_bytes=floor,
                                floor_ms=floor / HBM_BYTES_PER_S * 1e3)
    args = {"lossless_stats": (c["x"],),
            "huffman_pack": (c["x"], c["lt"], c["ct"]),
            "rle_scan": (c["x"],)}
    for name in WRITE_SIDE + ("rle_scan",):
        fn = getattr(kl, name)
        acts = _device_activities(torch, lambda: fn(*args[name]))
        check(0 < sum(acts.values()) <= 2
              and not any("huff_bits" in k or "row_scan" in k
                          or "rle_count" in k for k in acts),
              f"{name} on {what}: device activities {acts}")
        rows[name]["activities"] = acts
        print(f"{name} on {what}: device activities a call "
              f"{sum(acts.values())} ({', '.join(acts)})", flush=True)


class _WriteCalls:
    """Records every ``lossless_stats`` and ``huffman_pack`` launch (their
    CUDA implementations, ``kernels.lossless._LAUNCH``) while active: each
    call's inputs, cloned, by kernel."""

    def __enter__(self):
        from repro_torch.kernels import lossless as kl
        self.kl = kl
        self.was = {n: kl._LAUNCH[n] for n in WRITE_SIDE}
        self.calls = {n: [] for n in WRITE_SIDE}

        def rec(name):
            def call(*args):
                self.calls[name].append(tuple(a.clone() for a in args))
                return self.was[name](*args)
            return call
        for n in WRITE_SIDE:
            kl._LAUNCH[n] = rec(n)
        return self.calls

    def __exit__(self, *exc):
        self.kl._LAUNCH.update(self.was)



def _spread(calls):
    """The (B, S) spread of recorded calls: count, B and S least /
    median / most, symbols, and the median call by B * S."""
    shapes = sorted((int(a[0].shape[0]) * int(a[0].shape[1]),
                     tuple(a[0].shape), i) for i, a in enumerate(calls))
    bs = sorted(sh[1][0] for sh in shapes)
    ss = sorted(sh[1][1] for sh in shapes)
    mid = shapes[len(shapes) // 2]
    return dict(calls=len(calls), b=(bs[0], bs[len(bs) // 2], bs[-1]),
                s=(ss[0], ss[len(ss) // 2], ss[-1]),
                symbols=sum(sh[0] for sh in shapes), median=mid[1],
                median_call=mid[2])


def write_side(torch, nyx):
    """Phase 21 (c): every ``lossless_stats`` and ``huffman_pack`` call of
    one phase-8 pipelined write of ``nyx`` and of phase 9's store write of
    Isabel's U, V, W, recorded; their (B, S) spread; both kernels at phase
    9's median bucket (the median call by B * S: wrapper, replayed graph
    past the L2, bound); and the calls replayed under torch.profiler: the
    summed device time of each kernel's activities, memsets included, a
    phase.  Uses only what the port had before the write side's redesign,
    so that ``--write-side`` runs it on another tree."""
    import shutil
    from repro_torch.core import pipeline as pipe
    from repro_torch.data.fields import velocity_field
    from repro_torch.kernels import lossless as kl
    from repro_torch.store import DatasetWriter
    rec = {}
    with _WriteCalls() as calls:
        pipe.ChunkedRefactorPipeline(
            pipelined=True, chunk_elems=PIPE_CHUNK, levels=PIPE_LEVELS,
            design="shuffle", use_tune_cache=False,
            device="cuda").refactor(nyx, "nyx")
        torch.cuda.synchronize()
    rec["phase 8"] = calls
    root = os.path.join(REPO, "build", "write_side_smoke")
    shutil.rmtree(root, ignore_errors=True)
    vs = dict(zip(STORE_NAMES, velocity_field(ISABEL_SHAPE, seed=0)))
    try:
        with _WriteCalls() as calls, DatasetWriter(root, device="cuda") as w:
            for n in STORE_NAMES:
                w.write(n, vs[n])
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec["phase 9"] = calls
    del vs
    out = {}
    for phase, calls in rec.items():
        for name in WRITE_SIDE:
            sp = _spread(calls[name])

            def every(fn=kl._LAUNCH[name], args=calls[name]):
                return [fn(*a) for a in args]
            prof = _device_profile(torch, every)
            by = {k: us for k, (_, us) in prof.items()} or {
                "graph replay (the profile held nothing)":
                time_ms(every, reps=3, inner=1, warmup=1, graph=True) * 1e3}
            total = sum(by.values())
            out[(phase, name)] = dict(sp, device_us=total, by=by)
            print(f"{phase} write, {name}: {sp['calls']} calls, B "
                  f"{sp['b'][0]} / {sp['b'][1]} / {sp['b'][2]} (least / "
                  f"median / most), S {sp['s'][0]} / {sp['s'][1]} / "
                  f"{sp['s'][2]}, {sp['symbols']} symbols, median bucket "
                  f"(B, S) = {sp['median']}; summed device time "
                  f"{total:.1f} us (" + ", ".join(
                      f"{k[:40]} {v:.1f}" for k, v in by.items()) + ")",
                  flush=True)
    for name in WRITE_SIDE:
        sp = out[("phase 9", name)]
        args = rec["phase 9"][name][sp["median_call"]]
        b, s = args[0].shape
        res = kl._LAUNCH[name](*args)
        if name == "lossless_stats":
            nbytes = b * s + 8 * 257 * b
        else:
            stored = int(((res[1] + 31) // 32 + 1).sum())
            nbytes = b * s + 16 * 256 * b + 4 * stored + 8 * b \
                + 8 * res[2].numel()
        copies = [args] + [tuple(a.clone() for a in args) for _ in range(
            -(-2 * L2_BYTES // max(nbytes, 1)) - 1)]
        it = itertools.cycle(copies)
        fn = getattr(kl, name)
        sp.update(ms=time_ms(lambda: fn(*args)),
                  device_ms=time_ms(lambda: fn(*next(it)), graph=True),
                  bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes)
        print(f"{name} at phase 9's median bucket (B, S) = ({b}, {s}): "
              f"kernel {sp['ms'] * 1e3:.1f} us through the wrapper back to "
              f"back, device {sp['device_ms'] * 1e3:.1f} us (graph replay "
              f"over {len(copies)} input copies), bound "
              f"{sp['bound_ms'] * 1e3:.3f} us (bytes, {nbytes / 1e6:.3f} "
              f"MB)", flush=True)
        del copies
    for phase in rec:
        both = sum(out[(phase, n)]["device_us"] for n in WRITE_SIDE)
        print(f"{phase} write: the write side's summed device time "
              f"{both:.1f} us", flush=True)
    return out


def _device_profile(torch, fn) -> dict:
    """``fn()`` once, warm, then once under torch.profiler: its device
    activities (kernels, sets, copies) by name, as (count, device us).  A
    profile that holds no activity at all (the tracer's buffer lost; every
    call here launches something) is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        acts = {e.key: (e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.key != "Activity Buffer Request"}
        if acts:
            break
    return acts


def _device_activities(torch, fn) -> dict:
    """The device activities of one call of ``fn``: {name: count}, from a
    CUDA graph of the call (``kernels.bitplane.device_activities``).  A
    profile of one short call can lose activities: it showed the stats'
    kernel without its memset, and once nothing at all."""
    from repro_torch.kernels import bitplane as bp
    return bp.device_activities(fn)


def read_side(torch, c, what, rows, copied):
    """The read side's kernels at the group ``c``: the decode's walks over
    one call (none serial on an engine-made group), its device time at each
    lane count (graph replay over the timing's input copies), and each
    kernel's device activities a call (the expand's: at most two)."""
    from repro_torch.kernels import lossless as kl
    s = c["x"].shape[1]
    args = (c["words"], c["offs"], c["ls"], c["ln"])
    kl.reset_decode_walks()
    kl.huffman_decode(*args, s)
    walks = kl.decode_walks()
    check(walks["serial"] == 0 and walks["chunks"] == -(-s // kl.CHUNK),
          f"huffman_decode on {what}: walks {walks}")
    it = itertools.cycle(copied["huffman_decode"])
    lanes_ms = {m: time_ms(lambda: kl._launch_decode(*next(it), s, lanes=m),
                           graph=True) for m in kl.LANES}
    acts = {"huffman_decode": _device_activities(
        torch, lambda: kl.huffman_decode(*args, s)),
            "rle_expand": _device_activities(
        torch, lambda: kl.rle_expand(c["rv"], c["rl"], s))}
    n_exp = sum(acts["rle_expand"].values())
    check(0 < n_exp <= 2, f"rle_expand on {what}: device activities "
          f"{acts['rle_expand']}")
    rows["huffman_decode"].update(walks=walks, lanes_ms=lanes_ms,
                                  activities=acts["huffman_decode"])
    rows["rle_expand"]["activities"] = acts["rle_expand"]
    rl = c["rl"][0].to(torch.int64)
    tiles = torch.nn.functional.pad(rl, (0, -rl.numel() % kl.EXPAND_TILE))
    heaviest = int(tiles.view(-1, kl.EXPAND_TILE).sum(1).max())
    print(f"huffman_decode on {what}: one call walks {walks['chunks']} "
          f"chunks, {walks['serial']} serially, {walks['rounds']} "
          f"synchronisation rounds ({walks['rounds'] / walks['chunks']:.2f} "
          f"a chunk, at most {walks['max_rounds']}); device at "
          + " / ".join(f"{m}" for m in kl.LANES) + " lanes "
          + " / ".join(f"{v * 1e3:.1f}" for v in lanes_ms.values())
          + f" us; device activities a call "
          f"{sum(acts['huffman_decode'].values())} "
          f"({', '.join(acts['huffman_decode'])})", flush=True)
    print(f"rle_expand on {what}: device activities a call {n_exp} "
          f"({', '.join(acts['rle_expand'])}); {rl.numel()} runs in "
          f"{-(-rl.numel() // kl.EXPAND_TILE)} tiles, the largest tile "
          f"{heaviest} of the {s} bytes", flush=True)


def _peak_base(torch) -> int:
    """Start a read's peak: the allocator's peak from here, less what is
    allocated now, is the read's own rise."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _ladder(torch, rt, r, backend):
    """Phase 3's read ladder on a fresh reader: each step's values."""
    reader = rt.ProgressiveReader(r, backend=backend, device="cuda")
    return [reader.retrieve_device(tol, relative=True)[0] for tol in TOLS]


def lossless_stage_walls(torch, rf, rt, pipe, x_np, nyx):
    """Phase 21 (b): phase 3's write and ladder and phase 8's pipelined
    write and read, ``backend="torch"``, then the kernels (``"auto"``)
    twice, then ``"torch"``, in one process: the same blobs and values
    every turn; the walls, the spans ``encode.finish`` / ``encode.
    finish_many`` and ``codec.decode``, and each read's peak device memory
    above what was allocated when it began."""
    from repro_torch.obs import trace as obs_trace
    kw = dict(chunk_elems=PIPE_CHUNK, levels=PIPE_LEVELS, design="shuffle",
              use_tune_cache=False, device="cuda")
    first, turns = None, []
    for backend in ("torch", "auto", "auto", "torch"):
        t = {"backend": backend}
        with obs_trace.tracing() as tr:
            t0 = time.perf_counter()
            r = rf.refactor_array(x_np, "isabel", backend=backend,
                                  device="cuda")
            torch.cuda.synchronize()
            t["isabel write"] = time.perf_counter() - t0
            blob = rf.refactored_to_bytes(r)
            del r
            base = _peak_base(torch)
            t0 = time.perf_counter()
            vals = _ladder(torch, rt, rf.refactored_from_bytes(blob), backend)
            torch.cuda.synchronize()
            t["isabel ladder"] = time.perf_counter() - t0
            t["isabel ladder peak"] = torch.cuda.max_memory_allocated() - base
        spans = tr.summary()["spans"]
        t["isabel spans"] = {k: spans[k]["total_s"] for k in
                             ("encode.finish", "codec.decode") if k in spans}
        with obs_trace.tracing() as tr:
            t0 = time.perf_counter()
            blobs = pipe.ChunkedRefactorPipeline(
                pipelined=True, backend=backend, **kw).refactor(nyx, "nyx")
            t["nyx write"] = time.perf_counter() - t0
            base = _peak_base(torch)
            t0 = time.perf_counter()
            out = pipe.ChunkedReconstructPipeline(
                pipelined=True, backend=backend, device="cuda").reconstruct(
                    blobs, PIPE_TOL)
            t["nyx read"] = time.perf_counter() - t0
            t["nyx read peak"] = torch.cuda.max_memory_allocated() - base
        spans = tr.summary()["spans"]
        t["nyx spans"] = {k: spans[k]["total_s"] for k in
                          ("encode.finish_many", "codec.decode")
                          if k in spans}
        if first is None:
            first = (blob, vals, blobs, out.tobytes())
        else:
            check(blob == first[0] and blobs == first[2],
                  f"backend {backend!r}: blobs differ from the first turn's")
            check(all(torch.equal(a, b) for a, b in zip(vals, first[1]))
                  and out.tobytes() == first[3],
                  f"backend {backend!r}: values differ from the first turn's")
        print(f"turn {len(turns) + 1} (backend {backend!r}): Isabel write "
              f"{t['isabel write']:.3f} s, ladder {t['isabel ladder']:.3f} s "
              f"(peak rise {t['isabel ladder peak'] / 2 ** 30:.3f} GiB), "
              f"spans "
              + ", ".join(f"{k} {v:.3f} s" for k, v in
                          t["isabel spans"].items())
              + f"; NYX pipelined write {t['nyx write']:.3f} s, read "
              f"{t['nyx read']:.3f} s (peak rise "
              f"{t['nyx read peak'] / 2 ** 30:.3f} GiB), spans " + ", ".join(
                  f"{k} {v:.3f} s" for k, v in t["nyx spans"].items()),
              flush=True)
        turns.append(t)
        del vals, out
        _free(torch)
    print("kernels == backend='torch' in every turn: Isabel's blob and "
          "ladder values, NYX's chunk blobs and read values", flush=True)
    return turns


def rle_main_path(torch, bp, rf, rt, x_np):
    """Algorithm 2 with RLE forced (``HybridConfig(force="rle")``, the
    lossless strategies' RLE mode): Isabel's write and ladder on the card,
    counters zeroed before: every group through ``rle_scan`` and back
    through ``rle_expand``, no plain pass, the bound held at every step,
    and the same blob as with ``backend="torch"``."""
    from repro_torch.core import lossless as ll
    x_dev = torch.from_numpy(x_np).cuda()
    hybrid = ll.HybridConfig(force="rle")
    bp.reset_launches()
    with _PlainCalls(targets=_plain_lossless_targets()) as plain:
        t0 = time.perf_counter()
        r = rf.refactor_array(x_np, "isabel", hybrid=hybrid, device="cuda")
        torch.cuda.synchronize()
        t_write = time.perf_counter() - t0
        blob = rf.refactored_to_bytes(r)
        t0 = time.perf_counter()
        reader = rt.ProgressiveReader(rf.refactored_from_bytes(blob),
                                      device="cuda")
        for tol in TOLS:
            xh, bound, _ = reader.retrieve_device(tol, relative=True)
            err = (xh - x_dev).abs().max().item()
            check(err <= bound, f"rle tol {tol}: error {err} > {bound}")
        torch.cuda.synchronize()
        t_read = time.perf_counter() - t0
    launches = lossless_launches(
        bp, plain, ("lossless_stats", "rle_scan", "rle_expand"),
        "phase-21 forced-RLE main-path launches")
    check(launches["huffman_pack"] == 0, "forced RLE packed Huffman")
    plain_blob = rf.refactored_to_bytes(rf.refactor_array(
        x_np, "isabel", hybrid=hybrid, backend="torch", device="cuda"))
    check(plain_blob == blob, "forced-RLE blobs differ between the kernels "
          "and backend='torch'")
    print(f"forced RLE: write {t_write:.3f} s, ladder {t_read:.3f} s, "
          f"{len(blob)} wire bytes, == backend='torch''s blob", flush=True)
    return launches


def lossless_phase(torch, bp, rf, rt, x_np, nyx):
    """Phase 21: (a) the lossless kernels against their plain versions at
    the edge sizes and buckets and on real groups, timed there; the
    forced-RLE main path; (c) the write side over phases 8's and 9's
    writes; (b) the stage walls, kernels against plain, in turns.  Returns
    the timing rows by group and the forced-RLE path's launches.  ``nyx``:
    phase 8's field."""
    from repro_torch.core import pipeline as pipe
    n, errs = lossless_edges(torch)
    print(f"{n} lossless cases (S in {LOSSLESS_SIZES}, B 1 and 3; (B, S) in "
          f"{LOSSLESS_BUCKETS}; {', '.join(LOSSLESS_CONTENTS)}): every "
          f"kernel byte-identical to its plain version", flush=True)
    rows = {}
    for what, g in main_path_groups(torch, rf, x_np, pipe, nyx).items():
        rows[what] = lossless_timings(torch, lossless_case(torch, g), what)
        _free(torch)
    rle = rle_main_path(torch, bp, rf, rt, x_np)
    _free(torch)
    write_side(torch, nyx)
    _free(torch)
    lossless_stage_walls(torch, rf, rt, pipe, x_np, nyx)
    return rows, rle


def write_side_main(torch, src) -> int:
    """``--write-side SRC``: phase 21 (c) alone with SRC's port; prints
    the card and the summed device times as a JSON line."""
    import repro_torch
    from repro_torch.data.fields import gaussian_field
    from repro_torch.kernels import bitplane as bp
    where = os.path.dirname(os.path.abspath(repro_torch.__file__))
    check(where.startswith(os.path.abspath(src)),
          f"repro_torch imported from {where}, not from {src}")
    bp.load()
    card = card_line()
    print(f"write side of {where} on {card}", flush=True)
    nyx = gaussian_field(NYX_SHAPE, slope=-1.8, seed=0)
    out = write_side(torch, nyx)
    print(json.dumps({"write_side": src, "card": card, "device_us": {
        f"{p}, {n}": r["device_us"] for (p, n), r in out.items()},
        "median_device_ms": {n: out[("phase 9", n)]["device_ms"]
                             for n in WRITE_SIDE}}))
    return 0


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 6, the torch.profiler pass, and "
                         "profiled passes over qwen2-7b's decode steps and "
                         "a danube training step")
    ap.add_argument("--write-side", metavar="SRC",
                    help="run only phase 21 (c), the write side's kernels "
                         "over phases 8's and 9's writes, with the port "
                         "under SRC (a tree's src directory)")
    args = ap.parse_args(argv)
    if args.write_side:
        sys.path.insert(0, os.path.abspath(args.write_side))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.write_side:
        return write_side_main(torch, args.write_side)
    from repro_torch.core import refactor as rf
    from repro_torch.core import retrieve as rt
    from repro_torch.core.refactor_fused import piece_sizes
    from repro_torch.data.fields import gaussian_field
    from repro_torch.kernels import bitplane as bp
    from repro_torch.kernels import ref

    t_all = time.perf_counter()
    t0 = phase("1 build and device")
    bp.load()
    print(f"kernel build: {bp.BUILD_INFO['seconds']:.2f} s, "
          f"{len(bp.SOURCES)} sources at once")
    for src in bp.SOURCES:
        info = bp.BUILD_INFO[src.stem]
        print(f"  {src.name}: {info['seconds']:.2f} s "
              f"({'built' if info['built'] else 'reused'} {info['path']})")
        for line in info["log"].splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print("  ptxas:", line.strip())
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    done(t0, "phase 1")

    # before any other phase: the allocator gives a request a cached free
    # block up to 1 MB larger than it without splitting it, so the bytes
    # allocated over one call hold to the rounding only where no earlier
    # phase left such a block
    t0 = phase("19 (c) the scan backwards' workspace, card and meta, "
               "first")
    scan_workspace_check(torch)
    _free(torch)
    done(t0, "phase 19 (c)")

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
    registration_cost(torch, bp)
    done(t0, "phase 2")

    t0 = phase("3 main path at full size")
    from repro_torch.kernels import lossless as kl
    kl.reset_decode_walks()     # read after phase 12: every engine decode
    x_np = gaussian_field(ISABEL_SHAPE, slope=-2.0, seed=0)
    print(f"field {ISABEL_SHAPE}: {time.perf_counter() - t0:.2f} s to make")
    launches, blob = main_path(torch, bp, rf, rt, x_np)
    p3_lossless = {k: launches[k] for k in LOSSLESS}
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
    p8, nyx, nyx_blobs, nyx_values = pipeline_phase(torch, bp)
    launches["shuffle_encode"] = p8["shuffle_encode"]
    done(t0, "phase 8")

    t0 = phase("9 store and serving at full size")
    p9 = store_phase(torch, bp)
    print(f"phase-9 launches: rb_encode {p9['write']['rb_encode']} (write), "
          f"rb_decode {p9['serve']['rb_decode']} (shared serving)",
          flush=True)
    done(t0, "phase 9")

    t0 = phase("10 sharded engines, split over one card")
    sharded_phase(torch, bp, nyx, nyx_blobs, nyx_values)
    del nyx_blobs, nyx_values     # phase 21 writes nyx again
    done(t0, "phase 10")

    t0 = phase("11 the autotuner at the Isabel shape")
    tune_phase(torch, bp, x_np)
    done(t0, "phase 11")

    t0 = phase("12 exact codec (float64 Miranda) and checkpoints")
    ckpt_phase(torch, bp)
    check_walks(kl, "phases 3-12")
    done(t0, "phase 12")

    t0 = phase("13 serve: the LLM path (smoke archs, qwen2-7b, "
               "deepseek-v2/2, rwkv6-3b)")
    serve_phase(torch, args.profile)
    done(t0, "phase 13")

    t0 = phase("14 train: smoke archs card vs CPU and crash/resume; "
               "h2o-danube-3-4b at full width, 2 of 24 layers")
    p14 = train_phase(torch, bp, ref, args.profile)
    print(f"phase-14 launches (danube/2's 4 Trainer steps): "
          f"{p14['launches']}", flush=True)
    done(t0, "phase 14")

    t0 = phase("15 the mesh-bound paths (NCCL, a (1, 1) mesh; more cards: "
               "the -k cards tests)")
    p15 = mesh_phase(torch, bp)
    print(f"phase-15 launches: rb_encode {p15['rb_encode']}, rb_decode "
          f"{p15['rb_decode']} (compressed all-reduce)", flush=True)
    done(t0, "phase 15")

    t0 = phase("16 sharded parameter and AdamW-state storage (NCCL, a (1, 1) "
               "mesh; more cards: the fsdp card tests)")
    fsdp_phase(torch)
    done(t0, "phase 16")

    t0 = phase("17 tensor-parallel compute over 'model' (NCCL, a (1, 1) "
               "mesh; more cards: the tp card tests)")
    tp_phase(torch)
    done(t0, "phase 17")

    t0 = phase("18 Mamba on its 'model' blocks (jamba's period served, NCCL, "
               "a (1, 1) mesh) and the scan layers, kernels vs loop; more "
               "cards: the jamba card tests")
    jamba_phase(torch)
    done(t0, "phase 18")

    t0 = phase("19 analysis: the fused write program and danube/2's train "
               "step counted on the card and on meta ((c) ran first)")
    analysis_phase(torch, bp, x_np)
    done(t0, "phase 19")

    t0 = phase("20 the SSM scan kernels: against the plain loop at "
               "published widths; rwkv6-3b/4 and jamba's period without MoE "
               "trained, the period prefilled")
    scan_rows, scan_launches = scan_phase(torch, bp)
    print(f"phase-20 (b) launches: {scan_launches}", flush=True)
    done(t0, "phase 20")

    t0 = phase("21 the lossless codec's kernels: against the plain passes "
               "at the edges and on real groups, timed; forced RLE; the "
               "stage walls, kernels against backend='torch' in turns")
    ll_rows, rle_launches = lossless_phase(torch, bp, rf, rt, x_np, nyx)
    # launches: phase 3's main path, and the forced-RLE path's for RLE
    ll_launches = dict(p3_lossless, rle_scan=rle_launches["rle_scan"],
                       rle_expand=rle_launches["rle_expand"])
    print(f"phase-21 launches (phase 3's, RLE's forced path): "
          f"{ll_launches}", flush=True)
    done(t0, "phase 21")

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
    for name, r in scan_rows.items():
        entries.append({"name": name, "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/scan.cu",
                        "replaces": f"{SCAN_TPU}:"
                        + ("99" if name.startswith("wkv6") else "223"),
                        "launches": scan_launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "device_ms": r["device_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    for name in OPT_KERNELS:
        r = p14["rows"][name]
        entries.append({"name": name, "route": "cuda", "source": OPT_SOURCE,
                        "replaces": OPT_REPLACES[name],
                        "launches": p14["launches"][name],
                        "max_abs_err": p14["errs"][name], "ms": r["ms"],
                        "device_ms": r["device_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    for name in LOSSLESS:
        r = ll_rows["isabel 4-plane group"][name]
        entries.append({"name": name, "route": "cuda",
                        "source": LOSSLESS_SOURCE,
                        "replaces": LOSSLESS_REPLACES[name],
                        "launches": ll_launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "device_ms": r["device_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(f"total wall {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
