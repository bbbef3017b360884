// The SSM recurrences of the reference's models, hand-written for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes (kernels/scan.py).
//
// Replace the compiled `lax.scan`s of src/repro/models/ssm.py (no Pallas
// kernel: XLA makes each scan one device loop, chunked into 64 steps under
// `jax.checkpoint`):
//   wkv6_fwd, wkv6_bwd             <- RWKV6's wkv scan, `rwkv_time_mix_apply`
//                                     (:99-125)
//   mamba_scan_fwd, mamba_scan_bwd <- Mamba's selective scan, `mamba_apply`
//                                     (:223-245)
// Each forward keeps, when asked (`keep`), the state entering every chunk of
// `chunk` steps (ssm.REMAT_CHUNK, at most kMaxChunk), and each backward
// recomputes a chunk's steps from its kept state and walks back through
// them: the reference's memory rule (only the chunk boundaries are stored).
// The recurrence is never inverted: RWKV's decay reaches 1.8e-24 after the
// clamp and Mamba's exp(dt A) underflows, so dividing by either blows up.
//
// Rounding.  The state updates are written with __fmul_rn / __fadd_rn, so
// that each multiply and add rounds on its own, as torch's separate
// elementwise operators do, and `expf` is the accurate one (no fast math):
// the states, kept and final, are the plain loop's bits.  The outputs sum
// over k (RWKV) or the state (Mamba) in another order than torch's bmm.
//
// --- wkv6 (B batch, T steps, H heads of K = V = 64) ---------------------
//
//   S_{t+1}[k, v] = w_t[k] S_t[k, v] + k_t[k] v_t[v]
//   out_t[v]      = sum_k r_t[k] (S_t[k, v] + u[k] k_t[k] v_t[v])
//
// Each output column v of the state depends on that column alone, so
// wkv6_fwd gives one thread one (b, h, v) column in 64 registers and lets it
// sum over k itself, with no cross-thread reduction: a block of 64 threads
// per (b, h); r_t, k_t, w_t (and u) are staged in shared memory each step,
// read as broadcasts.
//
// wkv6_bwd (the gradient of every input, S_0 included, from d out and d
// S_T) splits the gradient by what each part sums over, the split of
// RWKV-LM's public wkv6_cuda.cu, with the state in registers:
//   * the column pass (blockIdx.y = 1, thread = column v) walks back over
//     all T steps carrying dS[:, v]; it needs no state:
//       dv_t[v] = d out_t[v] sum_k u r_t k_t + sum_k dS_{t+1}[k, v] k_t[k]
//       dS_t[k, v] = r_t[k] d out_t[v] + w_t[k] dS_{t+1}[k, v]
//     and writes dS_0;
//   * the row pass (blockIdx.y = 0, thread = row k) carries dS[k, :] and
//     needs S_t[k, :] in reverse order: for each chunk, last first, it
//     recomputes the chunk's states from the kept one into a global
//     scratch (chunk x 64 x 64 floats a (b, h), each thread writing and
//     reading back only its own row, coalesced over k, so no barrier
//     guards it; B H MB at chunk 64, which the L2 holds for B H <= ~48),
//     then walks back through it:
//       dr_t[k] = sum_v d out_t[v] (S_t[k, v] + u[k] k_t[k] v_t[v])
//       dk_t[k] = sum_v (u[k] r_t[k] d out_t[v] + dS_{t+1}[k, v]) v_t[v]
//       dw_t[k] = sum_v dS_{t+1}[k, v] S_t[k, v]
//       du[k]  += r_t[k] k_t[k] sum_v d out_t[v] v_t[v]
//     du is written per (b, h) and summed over b by sum_middle_kernel.
//
// --- selective scan (B batch, T steps, D channels, N <= 32 states) --------
//
//   h_t[d, s] = exp(dt_t[d] A[d, s]) h_{t-1}[d, s] + dt_t[d] x_t[d] B_t[s]
//   y_t[d]    = sum_s h_t[d, s] C_t[s]
//
// A channel's N states sit on a group of lanes (L = 8, 16 or 32 states, the
// power of two >= N; states past N hold 0).  Both kernels walk the
// sequence chunk by chunk (`chunk` steps, the kept states' spacing) and
// stage each chunk's inputs into shared memory, the next chunk's copies
// in flight while this one computes: a ring of kStages (2) stages, each
// thread's cp.asyncs (16-byte pieces where the rows are aligned) arriving
// on the stage's mbarrier, one block barrier a chunk freeing the stage.
// No step waits for global memory, no step has a barrier.
//
// mamba_scan_fwd: a thread holds K of a channel's states, K = 2 where
// that still runs kFwdMinWarps warps (8 an SM), else 1 (fwd_split): at
// B = 1 jamba's 8192 channels run two states a thread and its (1, 4)
// block of 2048 one, each the faster of the two there.  The sum over s is
// K terms in registers and then a reduce-scatter over the G = L / K lanes
// and G steps: about one shuffle a lane a step, and lane j of the group
// ends with y of the group's step j, written into a shared y tile that
// leaves as rows of the block's channels after the chunk's barrier.
//
// mamba_scan_bwd (a thread per (d, s), blocks of kBwdThreads, CH = 128 / L
// channels) stages x, dt, dy, B, C and the chunk's kept state, recomputes
// the chunk's states and exp(dt A) into registers (hb, ea: the loops over
// a chunk are unrolled), then walks back with g = dL/dh_t reading only
// shared memory and registers, with no second expf:
//   g += dy_t[d] C_t[s];  dC_t[s] += dy_t[d] h_t;  dB_t[s] += g dt_t x_t
//   e = sum_s g B_t[s];  q = g h_{t-1} exp(dt_t A)
//   dx_t = e dt_t;  d dt_t = e x_t + sum_s q A;  dA += q dt_t;  g *= exp(dt_t A)
// The sums over s (e, q A) are reduce-scatters over 4 steps; dx and ddt go
// through a shared tile like the forward's y.  dB and dC sum over all D
// channels: each step, over the warp's channels by one exchange (the low
// half-warp keeps dB, the high one dC) into the warp's rows of a shared
// [2][chunk][L] tile; after the chunk's barrier, over the block's warps;
// then over a cluster of kCluster (8) blocks through distributed shared
// memory (one cluster barrier a chunk, and the arrival that frees the
// block's tile for the next chunk, which is waited for a chunk later),
// into the cluster's partials of every step: B x D / (8 CH) x T x N floats
// each (2 x 32 MiB at jamba's widths and 1 x 4096), which sum_middle_kernel
// adds over the clusters.
// No grid-wide barrier, no atomics: every sum has a fixed order, so a
// call's gradients are the same bits every time.  dA is written per b and
// summed over b by sum_middle_kernel.
//
// What bounds them.  At B = 1, T = 4096: wkv6_fwd at rwkv6-3b's H = 40 moves
// r, k, v, w and out (5 x 42 MB) and, under autograd, 42 MB of kept states,
// ~75 us at 3.35 TB/s, against 4.7 GFLOP of float32 work (~70 us at 67
// TFLOP/s); it is latency-bound as written: a step's work per thread is one
// 64-long dependent chain, and only B H x 64 threads (2,560) run it.
// mamba_scan_fwd at jamba's D = 8192, N = 16 moves x, dt and y (3 x 134 MB,
// ~0.12 ms) and takes 537M expf (~0.13 ms on the SFUs); staged, it runs
// ~18 instructions a (d, s, t), the accurate expf 8 of them, and runs at
// ~4x that bound.  mamba_scan_bwd holds a chunk's 65 states and 64
// exp(dt A) of its (d, s) in registers (168 a thread, 3 blocks of 4 warps
// an SM: 384 states in flight an SM), so each warp's walk is bound by its
// own latency (a few hundred cycles a step for the recompute and the walk,
// against ~55 instructions it runs); more states in flight need a shorter
// recompute window, that is a second expf.  PERF.md has the times.

// The kernels allocate nothing (the wrapper passes outputs, partials and
// scratch) and launch on the caller's stream.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kHead = 64;          // RWKV6 head size (K = V)
constexpr int kMaxChunk = 64;      // most steps between two kept states
constexpr int kSumThreads = 256;
constexpr int kStages = 2;         // selective scan: chunks staged at once
constexpr int kFwdThreads = 128;   // its forward's block
constexpr int kFwdMinWarps = 1056; // 8 an SM: fwd_split's floor
constexpr int kBwdThreads = 128;   // its backward's block (a thread a state)
constexpr int kBwdBlocks = 3;      // resident a SM (<= 170 registers)
constexpr int kCluster = 8;        // blocks whose dB / dC meet on chip

// ------------------------------------------------------------------- wkv6 --

__global__ void __launch_bounds__(kHead) wkv6_fwd_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ out, float* __restrict__ s_final,
    float* __restrict__ states, int T, int H, int chunk, int keep) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H, i = threadIdx.x;
  __shared__ float rs[kHead], ks[kHead], ws[kHead], us[kHead];
  const int nc = (T + chunk - 1) / chunk;
  float S[kHead];                    // S[k][v = i]
  const float* s0p = s0 + (size_t)bh * kHead * kHead;
#pragma unroll
  for (int j = 0; j < kHead; ++j) S[j] = s0p[j * kHead + i];
  us[i] = u[h * kHead + i];
  const size_t tstride = (size_t)H * kHead;
  const size_t base = (size_t)b * T * tstride + (size_t)h * kHead + i;
  for (int t = 0; t < T; ++t) {
    const size_t o = base + (size_t)t * tstride;
    if (keep && t % chunk == 0) {
      float* st = states + (((size_t)b * nc + t / chunk) * H + h)
                               * kHead * kHead;
#pragma unroll
      for (int j = 0; j < kHead; ++j) st[j * kHead + i] = S[j];
    }
    __syncthreads();                 // the last step's reads are done
    rs[i] = r[o];
    ks[i] = k[o];
    ws[i] = w[o];
    __syncthreads();
    const float vv = v[o];
    float y = 0.f;
#pragma unroll
    for (int j = 0; j < kHead; ++j) {
      const float kv = __fmul_rn(ks[j], vv);
      y = __fadd_rn(y, __fmul_rn(rs[j],
                                 __fadd_rn(S[j], __fmul_rn(us[j], kv))));
      S[j] = __fadd_rn(__fmul_rn(ws[j], S[j]), kv);
    }
    out[o] = y;
  }
  float* sf = s_final + (size_t)bh * kHead * kHead;
#pragma unroll
  for (int j = 0; j < kHead; ++j) sf[j * kHead + i] = S[j];
}

__global__ void __launch_bounds__(kHead) wkv6_bwd_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ states,
    const float* __restrict__ dout, const float* __restrict__ ds_final,
    float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dw, float* __restrict__ du_part,
    float* __restrict__ ds0, float* __restrict__ scratch, int T, int H,
    int chunk) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H, i = threadIdx.x;
  const int nc = (T + chunk - 1) / chunk;
  const size_t tstride = (size_t)H * kHead;
  const size_t base = (size_t)b * T * tstride + (size_t)h * kHead + i;
  const float* dsf = ds_final + (size_t)bh * kHead * kHead;
  float dS[kHead];
  if (blockIdx.y == 1) {
    // ---- column pass: thread i owns dS[:, v = i]
    __shared__ float rs[kHead], ks[kHead], ws[kHead], us[kHead];
#pragma unroll
    for (int j = 0; j < kHead; ++j) dS[j] = dsf[j * kHead + i];
    us[i] = u[h * kHead + i];
    for (int t = T - 1; t >= 0; --t) {
      const size_t o = base + (size_t)t * tstride;
      __syncthreads();
      rs[i] = r[o];
      ks[i] = k[o];
      ws[i] = w[o];
      __syncthreads();
      const float gi = dout[o];
      float ruk = 0.f, acc = 0.f;
#pragma unroll
      for (int j = 0; j < kHead; ++j) {
        ruk += us[j] * rs[j] * ks[j];
        acc += dS[j] * ks[j];
        dS[j] = rs[j] * gi + ws[j] * dS[j];
      }
      dv[o] = gi * ruk + acc;
    }
    float* d0 = ds0 + (size_t)bh * kHead * kHead;
#pragma unroll
    for (int j = 0; j < kHead; ++j) d0[j * kHead + i] = dS[j];
    return;
  }
  // ---- row pass: thread i owns dS[k = i, :] and recomputes S[k = i, :]
  __shared__ float vs[kHead], gs[kHead];
  const float ui = u[h * kHead + i];
#pragma unroll
  for (int j = 0; j < kHead; ++j) dS[j] = dsf[i * kHead + j];
  float S[kHead];
  float du = 0.f;
  float* scr = scratch + (size_t)bh * chunk * kHead * kHead;  // [t][v][k]
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * chunk, n = min(chunk, T - t0);
    const float* st = states + (((size_t)b * nc + c) * H + h) * kHead * kHead;
#pragma unroll
    for (int j = 0; j < kHead; ++j) S[j] = st[i * kHead + j];
    for (int tt = 0; tt < n; ++tt) {
      const size_t o = base + (size_t)(t0 + tt) * tstride;
      float* sc = scr + (size_t)tt * kHead * kHead;
#pragma unroll
      for (int j = 0; j < kHead; ++j) sc[j * kHead + i] = S[j];
      __syncthreads();
      vs[i] = v[o];
      __syncthreads();
      const float wi = w[o], ki = k[o];
#pragma unroll
      for (int j = 0; j < kHead; ++j)
        S[j] = __fadd_rn(__fmul_rn(wi, S[j]), __fmul_rn(ki, vs[j]));
    }
    for (int tt = n - 1; tt >= 0; --tt) {
      const size_t o = base + (size_t)(t0 + tt) * tstride;
      const float* sc = scr + (size_t)tt * kHead * kHead;
      __syncthreads();
      vs[i] = v[o];
      gs[i] = dout[o];
      __syncthreads();
      const float ri = r[o], ki = k[o], wi = w[o];
      const float uri = ui * ri;
      float gr = 0.f, gk = 0.f, gw = 0.f, gv = 0.f;
#pragma unroll
      for (int j = 0; j < kHead; ++j) {
        const float s = sc[j * kHead + i];
        const float g = gs[j], vj = vs[j];
        gr += g * (s + ui * (ki * vj));
        gv += g * vj;
        gk += (uri * g + dS[j]) * vj;
        gw += dS[j] * s;
        dS[j] = ri * g + wi * dS[j];
      }
      dr[o] = gr;
      dk[o] = gk;
      dw[o] = gw;
      du += ri * ki * gv;
    }
  }
  du_part[(size_t)bh * kHead + i] = du;
}

// -------------------------------------------------------- selective scan --

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

// This thread's arrival on `bar`, made once its cp.asyncs so far have landed.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Waits for the phase of parity `parity` of `bar` to complete; a wait of
// ~8 s (2^34 cycles) traps, so that a fault ends the launch with an error
// rather than holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const long long t0 = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// Zeroes n floats of shared memory (n a multiple of 4, 16-byte aligned).
__device__ __forceinline__ void zero_shared(float* p, int n) {
  for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The cluster's barrier in two halves: an arrival (releasing this thread's
// shared-memory writes to the cluster, or ordering nothing), then a wait
// for every thread of the cluster's blocks to have arrived.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// rows x cols floats, rows `src_stride` apart in global memory, into shared
// rows `dst_stride` apart: the block's threads start one cp.async each per
// 16-byte piece where `vec` (aligned rows, cols a multiple of 4), per float
// otherwise.
__device__ __forceinline__ void stage_rows(float* dst, int dst_stride,
                                           const float* src,
                                           size_t src_stride, int rows,
                                           int cols, bool vec) {
  if (vec) {
    const int per = cols >> 2;
    for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
      const int r = i / per, q = (i - r * per) * 4;
      cp_async16(dst + r * dst_stride + q, src + r * src_stride + q);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, q = i - r * cols;
      cp_async4(dst + r * dst_stride + q, src + r * src_stride + q);
    }
  }
}

// The reverse of stage_rows, with plain stores (after a barrier).
__device__ __forceinline__ void store_rows(float* dst, size_t dst_stride,
                                           const float* src, int src_stride,
                                           int rows, int cols, bool vec) {
  if (vec) {
    const int per = cols >> 2;
    for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
      const int r = i / per, q = (i - r * per) * 4;
      *reinterpret_cast<float4*>(dst + r * dst_stride + q) =
          *reinterpret_cast<const float4*>(src + r * src_stride + q);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, q = i - r * cols;
      dst[r * dst_stride + q] = src[r * src_stride + q];
    }
  }
}

// K (1 or 2) consecutive floats of shared memory (8-byte aligned for 2).
template <int K>
__device__ __forceinline__ void load_k(float (&v)[K], const float* p) {
  static_assert(K == 1 || K == 2, "a thread holds 1 or 2 states");
  if constexpr (K == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// a where `up`, else b, as a bitwise select: a conditional operator on two
// elements of a register array can become an indexed load from local memory.
__device__ __forceinline__ float pick(bool up, float a, float b) {
  const int m = -(int)up;
  return __int_as_float((__float_as_int(a) & m) | (__float_as_int(b) & ~m));
}

// Lanes in aligned groups of G each hold v[0..R) (R <= G, powers of two):
// returns on the lane at place `gl` of its group the group's sum of
// v[gl / (G / R)].  log2 R halving exchanges (R - 1 shuffles: each lane
// sends the half it gives up and adds the half it keeps), then log2 (G / R)
// butterflies; about one shuffle a value where R = G, not log2 G.  A
// recursion over the halvings, so that every index into v is a constant.
template <int R, int O>
struct ReduceScatter {
  static __device__ __forceinline__ float run(float* v, int gl) {
    if constexpr (R == 1) {
      float r = v[0];
#pragma unroll
      for (int o = O; o > 0; o /= 2)
        r += __shfl_xor_sync(0xffffffffu, r, o);
      return r;
    } else {
      constexpr int H = R / 2;
      const bool up = gl & O;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = pick(up, v[i], v[i + H]);
        const float keep = pick(up, v[i + H], v[i]);
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      return ReduceScatter<H, O / 2>::run(v, gl);
    }
  }
};

template <int G, int R>
__device__ __forceinline__ float reduce_scatter(float (&v)[R], int gl) {
  return ReduceScatter<R, G / 2>::run(v, gl);
}

// The forward's shared memory, in floats: a ring of kStages stages of x,
// dt ([kMaxChunk][CH] each) and B, C ([kMaxChunk][L] each), then two y
// tiles.
template <int L, int K>
struct FwdLayout {
  static constexpr int G = L / K, CH = kFwdThreads / G;
  static constexpr int kTile = kMaxChunk * CH, kRows = kMaxChunk * L;
  static constexpr int kStage = 2 * kTile + 2 * kRows;
  static constexpr int kFloats = kStages * kStage + 2 * kTile;
};

// The backward's: a ring of stages of x, dt, dy, B, C and the chunk's kept
// state ([CH][L]); each warp's dB and dC rows (dC 16 floats further on,
// on other banks); the block's sums of them; the dx and ddt tiles.
template <int L>
struct BwdLayout {
  static constexpr int CH = kBwdThreads / L, W = kBwdThreads / 32;
  static constexpr int kTile = kMaxChunk * CH, kRows = kMaxChunk * L;
  static constexpr int kRowsP = kRows + 16, kWarpRed = kRowsP + kRows;
  static constexpr int kStage = 3 * kTile + 2 * kRows + CH * L;
  static constexpr int kFloats =
      kStages * kStage + W * kWarpRed + 2 * kRows + 2 * kTile;
};

// G steps of the forward on a thread's K states (every step on the
// chunk where kFull, else those below n): y of step j0 + gl into the tile.
template <int L, int K, bool kFull>
__device__ __forceinline__ void fwd_group(
    float (&h)[K], const float (&a)[K], const float* xs, const float* ds,
    const float* bs, const float* cs, float* yt, int j0, int n, int c,
    int gl, int s0) {
  constexpr int G = FwdLayout<L, K>::G, CH = FwdLayout<L, K>::CH;
  float p[G];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    const int j = j0 + r;
    p[r] = 0.f;
    if (kFull || j < n) {
      const float dtv = ds[j * CH + c];
      const float dtx = __fmul_rn(dtv, xs[j * CH + c]);
      float bv[K], cv[K];
      load_k<K>(bv, bs + j * L + s0);
      load_k<K>(cv, cs + j * L + s0);
#pragma unroll
      for (int k = 0; k < K; ++k) {     // states past N: a, h, B, C all 0
        const float da = expf(__fmul_rn(dtv, a[k]));
        h[k] = __fadd_rn(__fmul_rn(da, h[k]), __fmul_rn(dtx, bv[k]));
        p[r] = fmaf(h[k], cv[k], p[r]);
      }
    }
  }
  const float yv = reduce_scatter<G, G>(p, gl);   // y of step j0 + gl
  if (kFull || j0 + gl < n) yt[(j0 + gl) * CH + c] = yv;
}

// Forward.  A thread holds K states of one channel, a channel's L states
// sit on G = L / K lanes, a block of kFwdThreads covers CH channels of one
// b.  Chunk by chunk, the block stages x, dt (kMaxChunk x CH) and B, C
// (kMaxChunk x L) into a ring of kStages, the next chunk's copies in
// flight while this one computes; y is collected in a shared tile and
// stored after the chunk's one barrier.
template <int L, int K>
__global__ void __launch_bounds__(kFwdThreads) mamba_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ A, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_final,
    float* __restrict__ states, int T, int D, int N, int chunk, int keep,
    int vec_x, int vec_b) {
  using Y = FwdLayout<L, K>;
  constexpr int G = Y::G, CH = Y::CH, kTile = Y::kTile, kRows = Y::kRows;
  constexpr int kStage = Y::kStage;
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t full[kStages];
  float* ytile = smem + kStages * kStage;          // [2][kMaxChunk][CH]
  const int c = threadIdx.x / G, gl = threadIdx.x % G, s0 = gl * K;
  const int b = blockIdx.y, d0 = blockIdx.x * CH, d = d0 + c;
  const int cols = min(CH, D - d0);
  const bool on = d < D;
  const int nc = (T + chunk - 1) / chunk;
  float h[K], a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool ok = on && s0 + k < N;
    h[k] = ok ? h0[((size_t)b * D + d) * N + s0 + k] : 0.f;
    a[k] = ok ? A[(size_t)d * N + s0 + k] : 0.f;
  }
  // the copies never write the columns past D or N: they stay 0
  zero_shared(smem, kStages * kStage);
  if (threadIdx.x == 0)
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], blockDim.x);
  __syncthreads();
  auto stage_chunk = [&](int ci) {
    float* st = smem + (ci % kStages) * kStage;
    const int n = min(chunk, T - ci * chunk);
    const size_t row = (size_t)b * T + (size_t)ci * chunk;
    stage_rows(st, CH, x + row * D + d0, D, n, cols, vec_x);
    stage_rows(st + kTile, CH, dt + row * D + d0, D, n, cols, vec_x);
    stage_rows(st + 2 * kTile, L, bm + row * N, N, n, N, vec_b);
    stage_rows(st + 2 * kTile + kRows, L, cm + row * N, N, n, N, vec_b);
    mbar_arrive_copies(&full[ci % kStages]);
  };
  for (int ci = 0; ci < kStages - 1 && ci < nc; ++ci) stage_chunk(ci);
  for (int ci = 0; ci < nc; ++ci) {
    // the stage this refills was last read before the previous barrier
    if (ci + kStages - 1 < nc) stage_chunk(ci + kStages - 1);
    const int t0 = ci * chunk, n = min(chunk, T - t0);
    if (keep && on) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (s0 + k < N)
          states[(((size_t)b * nc + ci) * D + d) * N + s0 + k] = h[k];
    }
    mbar_wait(&full[ci % kStages], (ci / kStages) & 1);
    const float* xs = smem + (ci % kStages) * kStage;
    const float* ds = xs + kTile;
    const float* bs = ds + kTile;
    const float* cs = bs + kRows;
    float* yt = ytile + (ci & 1) * kTile;
    int j0 = 0;
    for (; j0 + G <= n; j0 += G)
      fwd_group<L, K, true>(h, a, xs, ds, bs, cs, yt, j0, n, c, gl, s0);
    if (j0 < n)
      fwd_group<L, K, false>(h, a, xs, ds, bs, cs, yt, j0, n, c, gl, s0);
    __syncthreads();   // the y tile is whole, the stage free
    store_rows(y + ((size_t)b * T + t0) * D + d0, D, yt, CH, n, cols, vec_x);
  }
  if (on) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (s0 + k < N) h_final[((size_t)b * D + d) * N + s0 + k] = h[k];
  }
}

// One chunk of the backward on a thread's state (every step where kFull,
// else the n first): the chunk's states and exp(dt A) recomputed into
// registers, then the walk back, last step first, carrying g and gA; the
// dB / dC rows into the warp's tile `wr`, dx and ddt into the block's.
template <int L, bool kFull>
__device__ __forceinline__ void bwd_chunk(
    float& g, float& gA, float a, const float* xs, const float* ds,
    const float* ys, const float* bs, const float* cs, const float* hs,
    float* wr, float* dxt, float* ddtt, int n, int c, int s, int lane,
    bool dv) {
  constexpr int CH = BwdLayout<L>::CH, kRowsP = BwdLayout<L>::kRowsP;
  constexpr int R = L < 4 ? L : 4;
  // off lanes read zeros (the staged tiles' columns past D and N), so that
  // they add exact zeros to every sum
  float hb[kMaxChunk + 1], ea[kMaxChunk];  // hb[j]: the state entering j
  hb[0] = hs[c * L + s];
#pragma unroll
  for (int j = 0; j < kMaxChunk; ++j) {
    if (kFull || j < n) {
      const float dtv = ds[j * CH + c];
      const float xv = xs[j * CH + c];
      const float bv = bs[j * L + s];
      ea[j] = expf(__fmul_rn(dtv, a));
      hb[j + 1] = __fadd_rn(__fmul_rn(ea[j], hb[j]),
                            __fmul_rn(__fmul_rn(dtv, xv), bv));
    }
  }
#pragma unroll
  for (int jb = kMaxChunk - R; jb >= 0; jb -= R) {
    float ev[R], qv[R];
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      const int j = jb + r;
      ev[r] = 0.f;
      qv[r] = 0.f;
      if (kFull || j < n) {
        const float dtv = ds[j * CH + c];
        const float xv = xs[j * CH + c];
        const float dyv = ys[j * CH + c];
        const float bv = bs[j * L + s];
        const float cv = cs[j * L + s];
        const float da = ea[j];
        g += dyv * cv;
        const float sb = g * (dtv * xv);     // -> dB_t[s]
        const float sc = dyv * hb[j + 1];    // -> dC_t[s]
        ev[r] = g * bv;                      // -> sum_s g B_t[s]
        const float q = g * hb[j] * da;
        qv[r] = q * a;                       // -> sum_s q A[d, s]
        gA += q * dtv;
        g *= da;
        if constexpr (L == 32) {
          wr[j * L + s] = sb;
          wr[kRowsP + j * L + s] = sc;
        } else {
          // over the warp's channels: the low half-warp keeps dB, the
          // high one dC, then butterflies over the rest
          const bool up = lane & 16;
          float v = (up ? sc : sb) +
                    __shfl_xor_sync(0xffffffffu, up ? sb : sc, 16);
#pragma unroll
          for (int o = 8; o >= L; o /= 2)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          if ((lane & 15) < L) wr[(up ? kRowsP : 0) + j * L + s] = v;
        }
      }
    }
    const float e = reduce_scatter<L, R>(ev, s);
    const float qa = reduce_scatter<L, R>(qv, s);
    const int j = jb + s / (L / R);
    if (dv && s % (L / R) == 0 && (kFull || j < n)) {
      dxt[j * CH + c] = e * ds[j * CH + c];
      ddtt[j * CH + c] = e * xs[j * CH + c] + qa;
    }
  }
}

// Backward.  A thread per (d, s) (a channel's L states on L lanes), blocks
// of kBwdThreads (CH channels of one b) in clusters of kCluster; each
// block walks its channels' chunks last first, with no grid-wide
// synchronisation.  A chunk's x, dt, dy, B, C and kept state are staged
// as in the forward; the chunk's states and exp(dt A) are recomputed into
// registers (hb, ea: the loops over a chunk are unrolled), so the walk
// back reads only shared memory and registers.  Sums over s (for dx, ddt)
// are reduce-scatters over R steps; dB and dC (sums over d) go per step
// from each warp into its rows of a shared [2][kMaxChunk][L] tile, summed
// over the block's warps after the chunk's barrier and over the cluster's
// blocks through distributed shared memory, in fixed orders, into the
// cluster's partials of every step, which sum_middle adds over the
// clusters.
template <int L>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kBwdThreads, kBwdBlocks) mamba_bwd_kernel(
        const float* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ bm, const float* __restrict__ cm,
        const float* __restrict__ A, const float* __restrict__ states,
        const float* __restrict__ dy, const float* __restrict__ dh_final,
        float* __restrict__ dx, float* __restrict__ ddt,
        float* __restrict__ part_db, float* __restrict__ part_dc,
        float* __restrict__ part_da, float* __restrict__ dh0, int T, int D,
        int N, int chunk, int vec_x, int vec_b, int vec_h) {
  using Y = BwdLayout<L>;
  constexpr int CH = Y::CH, W = Y::W, kTile = Y::kTile, kRows = Y::kRows;
  constexpr int kRowsP = Y::kRowsP, kWarpRed = Y::kWarpRed;
  constexpr int kStage = Y::kStage;
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t full[kStages];
  float* wred = smem + kStages * kStage;   // [W][kWarpRed]: dB, dC rows
  float* bred = wred + W * kWarpRed;       // [2][kMaxChunk][L]: the block's
  float* dxt = bred + 2 * kRows;           // [kMaxChunk][CH]
  float* ddtt = dxt + kTile;               // [kMaxChunk][CH]
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = threadIdx.x / L, s = threadIdx.x % L;
  const int b = blockIdx.y, d0 = blockIdx.x * CH, d = d0 + c;
  const int cols = max(0, min(CH, D - d0));
  const bool dv = d < D, on = dv && s < N;
  const int rank = (int)cluster.block_rank();
  const int tiles = gridDim.x / kCluster, tile = blockIdx.x / kCluster;
  const int nc = (T + chunk - 1) / chunk;
  const size_t hd = ((size_t)b * D + d) * N + s;
  const float a = on ? A[(size_t)d * N + s] : 0.f;
  float g = on ? dh_final[hd] : 0.f, gA = 0.f;
  // the copies never write the columns past D or N: they stay 0
  zero_shared(smem, kStages * kStage);
  if (threadIdx.x == 0)
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], blockDim.x);
  __syncthreads();
  cluster_arrive_relaxed();  // bred is free: paired with the first wait
  auto stage_chunk = [&](int k) {  // the k-th chunk from the end
    const int ci = nc - 1 - k;
    float* st = smem + (k % kStages) * kStage;
    const int n = min(chunk, T - ci * chunk);
    const size_t row = (size_t)b * T + (size_t)ci * chunk;
    stage_rows(st, CH, x + row * D + d0, D, n, cols, vec_x);
    stage_rows(st + kTile, CH, dt + row * D + d0, D, n, cols, vec_x);
    stage_rows(st + 2 * kTile, CH, dy + row * D + d0, D, n, cols, vec_x);
    stage_rows(st + 3 * kTile, L, bm + row * N, N, n, N, vec_b);
    stage_rows(st + 3 * kTile + kRows, L, cm + row * N, N, n, N, vec_b);
    stage_rows(st + 3 * kTile + 2 * kRows, L,
               states + (((size_t)b * nc + ci) * D + d0) * N, N, cols, N,
               vec_h);
    mbar_arrive_copies(&full[k % kStages]);
  };
  for (int k = 0; k < kStages - 1 && k < nc; ++k) stage_chunk(k);
  for (int k = 0; k < nc; ++k) {
    if (k + kStages - 1 < nc) stage_chunk(k + kStages - 1);
    const int ci = nc - 1 - k, t0 = ci * chunk, n = min(chunk, T - t0);
    mbar_wait(&full[k % kStages], (k / kStages) & 1);
    const float* xs = smem + (k % kStages) * kStage;
    const float* ds = xs + kTile;
    const float* ys = ds + kTile;
    const float* bs = ys + kTile;
    const float* cs = bs + kRows;
    const float* hs = cs + kRows;
    if (n == kMaxChunk)
      bwd_chunk<L, true>(g, gA, a, xs, ds, ys, bs, cs, hs,
                         wred + warp * kWarpRed, dxt, ddtt, n, c, s, lane,
                         dv);
    else
      bwd_chunk<L, false>(g, gA, a, xs, ds, ys, bs, cs, hs,
                          wred + warp * kWarpRed, dxt, ddtt, n, c, s, lane,
                          dv);
    __syncthreads();   // the chunk's dx, ddt and dB, dC rows are whole
    const size_t orow = ((size_t)b * T + t0) * D + d0;
    store_rows(dx + orow, D, dxt, CH, n, cols, vec_x);
    store_rows(ddt + orow, D, ddtt, CH, n, cols, vec_x);
    cluster_wait();    // the cluster is done reading the last chunk's bred
    for (int i = threadIdx.x; i < 2 * n * L; i += blockDim.x) {
      const int q = i / (n * L), e = i - q * n * L;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) acc += wred[w * kWarpRed + q * kRowsP + e];
      bred[q * kRows + e] = acc;
    }
    cluster_arrive_release();
    cluster_wait();    // every block's rows of the chunk are summed
    for (int i = rank * (int)blockDim.x + threadIdx.x; i < 2 * n * L;
         i += kCluster * blockDim.x) {
      const int q = i / (n * L), e = i - q * n * L, j = e / L, ss = e % L;
      if (ss >= N) continue;
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        acc += cluster.map_shared_rank(bred, r)[q * kRows + e];
      (q ? part_dc : part_db)[(((size_t)b * tiles + tile) * T + t0 + j) * N +
                              ss] = acc;
    }
    // this block's reads of the cluster are done: a release, so that they
    // are ordered before the owners' writes of the next chunk's rows
    cluster_arrive_release();
  }
  cluster_wait();      // no block leaves while its bred may still be read
  if (on) {
    part_da[hd] = gA;
    dh0[hd] = g;
  }
}

// out[o][e] = sum over m of in[o][m][e], m in order
__global__ void __launch_bounds__(kSumThreads) sum_middle_kernel(
    const float* __restrict__ in, float* __restrict__ out, long long mid,
    long long inner) {
  const long long e = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  if (e >= inner) return;
  const float* p = in + (size_t)blockIdx.y * mid * inner + e;
  float acc = 0.f;
  for (long long m = 0; m < mid; ++m) acc += p[m * inner];
  out[(size_t)blockIdx.y * inner + e] = acc;
}

void sum_middle(const float* in, float* out, int outer, long long mid,
                long long inner, cudaStream_t stream) {
  const dim3 grid((unsigned)((inner + kSumThreads - 1) / kSumThreads),
                  (unsigned)outer);
  sum_middle_kernel<<<grid, kSumThreads, 0, stream>>>(in, out, mid, inner);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The states a thread of the forward holds: 2 where that still gives
// kFwdMinWarps warps, else 1.
int fwd_split(int B, int D, int L) {
  return (long long)B * D * L / 2 / 32 >= kFwdMinWarps ? 2 : 1;
}

template <int L, int K>
int mamba_fwd_launch(const float* x, const float* dt, const float* bm,
                     const float* cm, const float* a, const float* h0,
                     float* y, float* h_final, float* states, int B, int T,
                     int D, int N, int chunk, int keep, cudaStream_t stream) {
  constexpr int CH = FwdLayout<L, K>::CH;
  auto kernel = mamba_fwd_kernel<L, K>;
  const int bytes = FwdLayout<L, K>::kFloats * (int)sizeof(float);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  const int vec_x = D % 4 == 0 && aligned16(x) && aligned16(dt) &&
                    aligned16(y);
  const int vec_b = N % 4 == 0 && aligned16(bm) && aligned16(cm);
  const dim3 grid((unsigned)((D + CH - 1) / CH), (unsigned)B);
  kernel<<<grid, kFwdThreads, bytes, stream>>>(
      x, dt, bm, cm, a, h0, y, h_final, states, T, D, N, chunk, keep, vec_x,
      vec_b);
  return (int)cudaGetLastError();
}

template <int L>
int mamba_fwd_split_launch(int K, const float* x, const float* dt,
                           const float* bm, const float* cm, const float* a,
                           const float* h0, float* y, float* h_final,
                           float* states, int B, int T, int D, int N,
                           int chunk, int keep, cudaStream_t stream) {
  auto f = K == 2 ? &mamba_fwd_launch<L, 2> : &mamba_fwd_launch<L, 1>;
  return f(x, dt, bm, cm, a, h0, y, h_final, states, B, T, D, N, chunk, keep,
           stream);
}

int bwd_tiles(int D, int L) {
  const int ch = kBwdThreads / L, blocks = (D + ch - 1) / ch;
  return (blocks + kCluster - 1) / kCluster;
}

template <int L>
int mamba_bwd_launch(const float* x, const float* dt, const float* bm,
                     const float* cm, const float* a, const float* states,
                     const float* dy, const float* dh_final, float* dx,
                     float* ddt, float* part_db, float* part_dc,
                     float* part_da, float* dh0, int B, int T, int D, int N,
                     int chunk, cudaStream_t stream) {
  auto kernel = mamba_bwd_kernel<L>;
  const int bytes = BwdLayout<L>::kFloats * (int)sizeof(float);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       100);
  const int vec_x = D % 4 == 0 && aligned16(x) && aligned16(dt) &&
                    aligned16(dy) && aligned16(dx) && aligned16(ddt);
  const int vec_b = N % 4 == 0 && aligned16(bm) && aligned16(cm);
  const int vec_h = N % 4 == 0 && aligned16(states);
  const dim3 grid((unsigned)(bwd_tiles(D, L) * kCluster), (unsigned)B);
  kernel<<<grid, kBwdThreads, bytes, stream>>>(
      x, dt, bm, cm, a, states, dy, dh_final, dx, ddt, part_db, part_dc,
      part_da, dh0, T, D, N, chunk, vec_x, vec_b, vec_h);
  return (int)cudaGetLastError();
}

int lanes_of(int N) { return N <= 8 ? 8 : (N <= 16 ? 16 : 32); }

}  // namespace

extern "C" {

// The clusters of a batch row in the selective scan's backward (its dB /
// dC partials take B x tiles x T x N floats each), for the wrapper's
// allocation.
int mamba_scan_tiles(int D, int N) { return bwd_tiles(D, lanes_of(N)); }

// Each returns cudaGetLastError() after its launches (0 = success).
int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* out, void* s_final,
             void* states, int B, int T, int H, int chunk, int keep,
             void* stream) {
  wkv6_fwd_kernel<<<(unsigned)(B * H), kHead, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(s_final),
      static_cast<float*>(states), T, H, chunk, keep);
  return (int)cudaGetLastError();
}

int wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* states, const void* dout,
             const void* ds_final, void* dr, void* dk, void* dv, void* dw,
             void* du_part, void* du, void* ds0, void* scratch, int B, int T,
             int H, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  wkv6_bwd_kernel<<<dim3((unsigned)(B * H), 2), kHead, 0, st>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(states),
      static_cast<const float*>(dout), static_cast<const float*>(ds_final),
      static_cast<float*>(dr), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dw),
      static_cast<float*>(du_part), static_cast<float*>(ds0),
      static_cast<float*>(scratch), T, H, chunk);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  sum_middle(static_cast<const float*>(du_part), static_cast<float*>(du), 1,
             B, (long long)H * kHead, st);
  return (int)cudaGetLastError();
}

int mamba_scan_fwd(const void* x, const void* dt, const void* bm,
                   const void* cm, const void* a, const void* h0, void* y,
                   void* h_final, void* states, int B, int T, int D, int N,
                   int chunk, int keep, void* stream) {
  const int L = lanes_of(N);
  auto f = L == 8 ? &mamba_fwd_split_launch<8>
                  : (L == 16 ? &mamba_fwd_split_launch<16>
                             : &mamba_fwd_split_launch<32>);
  return f(fwd_split(B, D, L), static_cast<const float*>(x),
           static_cast<const float*>(dt), static_cast<const float*>(bm),
           static_cast<const float*>(cm), static_cast<const float*>(a),
           static_cast<const float*>(h0), static_cast<float*>(y),
           static_cast<float*>(h_final), static_cast<float*>(states), B, T,
           D, N, chunk, keep, static_cast<cudaStream_t>(stream));
}

int mamba_scan_bwd(const void* x, const void* dt, const void* bm,
                   const void* cm, const void* a, const void* states,
                   const void* dy, const void* dh_final, void* dx, void* ddt,
                   void* part_db, void* part_dc, void* part_da, void* db,
                   void* dc, void* da, void* dh0, int B, int T, int D, int N,
                   int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = lanes_of(N);
  auto f = L == 8 ? &mamba_bwd_launch<8>
                  : (L == 16 ? &mamba_bwd_launch<16> : &mamba_bwd_launch<32>);
  const int err = f(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(states),
      static_cast<const float*>(dy), static_cast<const float*>(dh_final),
      static_cast<float*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(part_db), static_cast<float*>(part_dc),
      static_cast<float*>(part_da), static_cast<float*>(dh0), B, T, D, N,
      chunk, st);
  if (err) return err;
  const int tiles = bwd_tiles(D, L);
  sum_middle(static_cast<const float*>(part_db), static_cast<float*>(db), B,
             tiles, (long long)T * N, st);
  sum_middle(static_cast<const float*>(part_dc), static_cast<float*>(dc), B,
             tiles, (long long)T * N, st);
  sum_middle(static_cast<const float*>(part_da), static_cast<float*>(da), 1,
             B, (long long)D * N, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
