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
// One thread per (b, d, s): a channel's N states sit in a group of L lanes
// (L = 8, 16 or 32, the power of two >= N; lanes past N hold 0), and the
// sums over s are L-lane butterflies of __shfl_xor_sync.  Blocks of 256
// threads cover 256 / L channels of one b.  The forward needs no barrier.
// mamba_scan_bwd recomputes a chunk's kMaxChunk + 1 states into registers
// (the loops over a chunk are unrolled, so `hb` never leaves them), then
// walks back with g = dL/dh_t:
//   g += dy_t[d] C_t[s];  dC_t[s] += dy_t[d] h_t;  dB_t[s] += g dt_t x_t
//   e = sum_s g B_t[s];  q = g h_{t-1} exp(dt_t A)
//   dx_t = e dt_t;  d dt_t = e x_t + sum_s q A;  dA += q dt_t;  g *= exp(dt_t A)
// dB and dC sum over all D channels, across blocks: across a warp's channel
// groups by shuffles, across the block's warps through shared memory (one
// barrier a step), into per-tile partials of the chunk's steps, which the
// grid sums after a grid-wide barrier, in a fixed order (deterministic).
// So the kernel is persistent (a cooperative launch, every block resident,
// each walking its tiles chunk by chunk, last chunk first): per-tile
// partials of every step would take 2 x 134 MB at jamba's widths and 4096
// steps, a chunk's take 2 x 2 MB.  dA is written per b and summed over b by
// sum_middle_kernel.
//
// What bounds them.  At B = 1, T = 4096: wkv6_fwd at rwkv6-3b's H = 40 moves
// r, k, v, w and out (5 x 42 MB) and, under autograd, 42 MB of kept states,
// ~75 us at 3.35 TB/s, against 4.7 GFLOP of float32 work (~70 us at 67
// TFLOP/s); mamba_scan_fwd at jamba's D = 8192, N = 16 moves x, dt and y (3
// x 134 MB, ~0.12 ms) and takes 537M expf (~0.13 ms on the SFUs).  Both are
// latency-bound as written: a step's work per thread is one dependent chain
// (64 multiply-adds for wkv, a multiply, an add and a shuffle tree for the
// scan), and only B H x 64 threads (2,560) run the wkv.  This design is the
// simple one; splitting k over threads, wgmma over chunked products and
// fewer barriers are later work.
//
// The kernels allocate nothing (the wrapper passes outputs, partials and
// scratch) and launch on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHead = 64;         // RWKV6 head size (K = V)
constexpr int kMaxChunk = 64;     // most steps between two kept states
constexpr int kScanThreads = 256; // selective-scan block
constexpr int kSumThreads = 256;

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

template <int L>
__global__ void __launch_bounds__(kScanThreads) mamba_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ A, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_final,
    float* __restrict__ states, int T, int D, int N, int chunk, int keep) {
  const int s = threadIdx.x % L;
  const int d = blockIdx.x * (kScanThreads / L) + threadIdx.x / L;
  const int b = blockIdx.y;
  const bool on = d < D && s < N;
  const int nc = (T + chunk - 1) / chunk;
  const size_t hd = ((size_t)b * D + d) * N + s;   // (b, d, s) of a state
  float h = on ? h0[hd] : 0.f;
  const float a = on ? A[(size_t)d * N + s] : 0.f;
  for (int t = 0; t < T; ++t) {
    if (keep && on && t % chunk == 0)
      states[(((size_t)b * nc + t / chunk) * D + d) * N + s] = h;
    float dtv = 0.f, xv = 0.f, bv = 0.f, cv = 0.f;
    const size_t o = ((size_t)b * T + t) * D + d;
    if (on) {
      const size_t q = ((size_t)b * T + t) * N + s;
      dtv = dt[o];
      xv = x[o];
      bv = bm[q];
      cv = cm[q];
    }
    const float da = expf(__fmul_rn(dtv, a));
    h = __fadd_rn(__fmul_rn(da, h), __fmul_rn(__fmul_rn(dtv, xv), bv));
    float p = h * cv;
#pragma unroll
    for (int off = L / 2; off > 0; off /= 2)
      p += __shfl_xor_sync(0xffffffffu, p, off);
    if (on && s == 0) y[o] = p;
  }
  if (on) h_final[hd] = h;
}

// A barrier across the grid of a cooperative launch (every block resident):
// the k-th call of a launch waits for k x gridDim.x arrivals on `count`,
// which starts at 0.  A wait past ~2^31 polls (minutes) traps, so that a
// fault ends the launch with an error rather than holding the card.
__device__ void grid_barrier(unsigned* count, unsigned k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    for (unsigned polls = 0; *(volatile unsigned*)count < k * gridDim.x;
         ++polls) {
      if (polls == 0x80000000u) __trap();
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// Persistent: each block walks the tiles (b, 256 / L channels) blockIdx.x,
// blockIdx.x + gridDim.x, ... for one chunk, all chunks last first; g and
// the dA sum of each (b, d, s) wait in g_out / ga_out between chunks (the
// last chunk starts from dh_final).  A chunk's dB / dC partials (a tile's
// 64 steps) are summed over the tiles after a grid barrier, so they take
// tiles x 64 x N floats each, not tiles x T x N.
template <int L>
__global__ void __launch_bounds__(kScanThreads) mamba_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ A, const float* __restrict__ states,
    const float* __restrict__ dy, const float* __restrict__ dh_final,
    float* __restrict__ dx, float* __restrict__ ddt,
    float* __restrict__ part_db, float* __restrict__ part_dc,
    float* __restrict__ g_out, float* __restrict__ ga_out,
    float* __restrict__ db, float* __restrict__ dc, unsigned* barrier,
    int B, int T, int D, int N, int chunk) {
  constexpr int kWarps = kScanThreads / 32, kChannels = kScanThreads / L;
  __shared__ float red_b[2][kWarps][32], red_c[2][kWarps][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int s = threadIdx.x % L;
  const int per_b = (D + kChannels - 1) / kChannels, tiles = B * per_b;
  const int nc = (T + chunk - 1) / chunk;
  unsigned phase = 0;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * chunk, n = min(chunk, T - t0);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int b = tile / per_b;
      const int d = (tile % per_b) * kChannels + threadIdx.x / L;
      const bool on = d < D && s < N;
      const size_t hd = ((size_t)b * D + d) * N + s;
      const float a = on ? A[(size_t)d * N + s] : 0.f;
      float g = on ? (c == nc - 1 ? dh_final[hd] : g_out[hd]) : 0.f;
      float gA = on && c != nc - 1 ? ga_out[hd] : 0.f;
      float* pb = part_db + (size_t)tile * kMaxChunk * N;
      float* pc = part_dc + (size_t)tile * kMaxChunk * N;
      float hb[kMaxChunk + 1];       // hb[j]: the state entering step t0 + j
      hb[0] = on ? states[(((size_t)b * nc + c) * D + d) * N + s] : 0.f;
#pragma unroll
      for (int j = 0; j < kMaxChunk; ++j) {
        if (j < n) {
          float dtv = 0.f, xv = 0.f, bv = 0.f;
          if (on) {
            const size_t o = ((size_t)b * T + t0 + j) * D + d;
            dtv = dt[o];
            xv = x[o];
            bv = bm[((size_t)b * T + t0 + j) * N + s];
          }
          const float da = expf(__fmul_rn(dtv, a));
          hb[j + 1] = __fadd_rn(__fmul_rn(da, hb[j]),
                                __fmul_rn(__fmul_rn(dtv, xv), bv));
        }
      }
#pragma unroll
      for (int j = kMaxChunk - 1; j >= 0; --j) {
        if (j < n) {
          const int t = t0 + j;
          const size_t o = ((size_t)b * T + t) * D + d;
          float dtv = 0.f, xv = 0.f, bv = 0.f, cv = 0.f, dyv = 0.f;
          if (on) {
            const size_t q = ((size_t)b * T + t) * N + s;
            dtv = dt[o];
            xv = x[o];
            dyv = dy[o];
            bv = bm[q];
            cv = cm[q];
          }
          const float da = expf(__fmul_rn(dtv, a));
          const float dtx = dtv * xv;
          g += dyv * cv;
          float sc = dyv * hb[j + 1];  // -> dC_t[s]
          float sb = g * dtx;          // -> dB_t[s]
          float e = g * bv;            // -> sum_s g B_t[s]
          const float q = g * hb[j] * da;
          float qa = q * a;            // -> sum_s q A[d, s]
#pragma unroll
          for (int off = L / 2; off > 0; off /= 2) {
            e += __shfl_xor_sync(0xffffffffu, e, off);
            qa += __shfl_xor_sync(0xffffffffu, qa, off);
          }
#pragma unroll
          for (int off = L; off < 32; off *= 2) {
            sb += __shfl_xor_sync(0xffffffffu, sb, off);
            sc += __shfl_xor_sync(0xffffffffu, sc, off);
          }
          const int par = j & 1;
          if (lane < L) {
            red_b[par][warp][lane] = sb;
            red_c[par][warp][lane] = sc;
          }
          __syncthreads();
          if (warp == 0 && lane < N) {
            float tb = 0.f, tc = 0.f;
#pragma unroll
            for (int wi = 0; wi < kWarps; ++wi) {
              tb += red_b[par][wi][lane];
              tc += red_c[par][wi][lane];
            }
            pb[j * N + lane] = tb;
            pc[j * N + lane] = tc;
          }
          if (on && s == 0) {
            dx[o] = e * dtv;
            ddt[o] = e * xv + qa;
          }
          gA += q * dtv;
          g *= da;
        }
      }
      if (on) {
        g_out[hd] = g;
        ga_out[hd] = gA;
      }
      __syncthreads();               // red_* are free for the next tile
    }
    grid_barrier(barrier, ++phase);  // every tile's partials of chunk c
    const int m = B * n * N;
    for (int i = blockIdx.x * kScanThreads + threadIdx.x; i < m;
         i += gridDim.x * kScanThreads) {
      const int b = i / (n * N), j = (i / N) % n, ss = i % N;
      const size_t first = ((size_t)b * per_b * kMaxChunk + j) * N + ss;
      const float* qb = part_db + first;
      const float* qc = part_dc + first;
      float tb = 0.f, tc = 0.f;
      for (int k = 0; k < per_b; ++k) {
        tb += qb[(size_t)k * kMaxChunk * N];
        tc += qc[(size_t)k * kMaxChunk * N];
      }
      const size_t o = ((size_t)b * T + t0 + j) * N + ss;
      db[o] = tb;
      dc[o] = tc;
    }
    grid_barrier(barrier, ++phase);  // the partials are free again
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

template <int L>
void mamba_fwd_launch(const float* x, const float* dt, const float* bm,
                      const float* cm, const float* a, const float* h0,
                      float* y, float* h_final, float* states, int B, int T,
                      int D, int N, int chunk, int keep, cudaStream_t stream) {
  const int cpb = kScanThreads / L;
  const dim3 grid((unsigned)((D + cpb - 1) / cpb), (unsigned)B);
  mamba_fwd_kernel<L><<<grid, kScanThreads, 0, stream>>>(
      x, dt, bm, cm, a, h0, y, h_final, states, T, D, N, chunk, keep);
}

template <int L>
int mamba_bwd_launch(const float* x, const float* dt, const float* bm,
                     const float* cm, const float* a, const float* states,
                     const float* dy, const float* dh_final, float* dx,
                     float* ddt, float* part_db, float* part_dc, float* g_out,
                     float* ga_out, float* db, float* dc, unsigned* barrier,
                     int B, int T, int D, int N, int chunk,
                     cudaStream_t stream) {
  auto kernel = mamba_bwd_kernel<L>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kScanThreads, 0);
  const int tiles = B * ((D + kScanThreads / L - 1) / (kScanThreads / L));
  const int grid = min(tiles, per_sm * sms);
  void* args[] = {&x, &dt, &bm, &cm, &a, &states, &dy, &dh_final, &dx,
                  &ddt, &part_db, &part_dc, &g_out, &ga_out, &db, &dc,
                  &barrier, &B, &T, &D, &N, &chunk};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                          dim3(kScanThreads), args, 0,
                                          stream);
}

}  // namespace

extern "C" {

// The tiles of the selective scan's backward (its dB / dC partials take
// tiles x 64 x N floats each), for the wrapper's allocation.
int mamba_scan_tiles(int B, int D, int N) {
  const int L = N <= 8 ? 8 : (N <= 16 ? 16 : 32);
  const int cpb = kScanThreads / L;
  return B * ((D + cpb - 1) / cpb);
}

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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = N <= 8 ? &mamba_fwd_launch<8>
                  : (N <= 16 ? &mamba_fwd_launch<16> : &mamba_fwd_launch<32>);
  f(static_cast<const float*>(x), static_cast<const float*>(dt),
    static_cast<const float*>(bm), static_cast<const float*>(cm),
    static_cast<const float*>(a), static_cast<const float*>(h0),
    static_cast<float*>(y), static_cast<float*>(h_final),
    static_cast<float*>(states), B, T, D, N, chunk, keep, st);
  return (int)cudaGetLastError();
}

int mamba_scan_bwd(const void* x, const void* dt, const void* bm,
                   const void* cm, const void* a, const void* states,
                   const void* dy, const void* dh_final, void* dx, void* ddt,
                   void* part_db, void* part_dc, void* part_da, void* db,
                   void* dc, void* da, void* dh0, void* barrier, int B,
                   int T, int D, int N, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = N <= 8 ? &mamba_bwd_launch<8>
                  : (N <= 16 ? &mamba_bwd_launch<16> : &mamba_bwd_launch<32>);
  const int err = f(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(states),
      static_cast<const float*>(dy), static_cast<const float*>(dh_final),
      static_cast<float*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(part_db), static_cast<float*>(part_dc),
      static_cast<float*>(dh0), static_cast<float*>(part_da),
      static_cast<float*>(db), static_cast<float*>(dc),
      static_cast<unsigned*>(barrier), B, T, D, N, chunk, st);
  if (err) return err;
  sum_middle(static_cast<const float*>(part_da), static_cast<float*>(da), 1,
             B, (long long)D * N, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
