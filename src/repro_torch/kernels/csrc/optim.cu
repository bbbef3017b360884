// The training step's optimizer path, hand-written for Hopper (sm_90a).
// Plain C interface, loaded with ctypes (kernels/optim.py).
//
// Replace no Pallas kernel.  The reference runs the whole training step
// under one `jax.jit` (src/repro/train/loop.py:65-83), and XLA fuses each
// of these into a few loop fusions a leaf; the port ran them as eager
// chains of 20-30 tensor operators a leaf, most of them a full pass over
// device memory and many of them float64 temporaries:
//   ef_amax, ef_apply <- `ef_quantize` (src/repro/distributed/
//                        grad_compress.py:65): error-feedback truncation of
//                        a gradient leaf to its sign and top `planes`
//                        magnitude bitplanes
//   adamw_update      <- AdamW's per-leaf update `upd`
//                        (src/repro/optim/adamw.py:68-76)
//   global_sumsq      <- the sums of squares of AdamW's `global_norm`
//                        (src/repro/optim/adamw.py:54)
//
// Bit-identity.  Each kernel computes what the port's plain versions
// compute (distributed/grad_compress.py's plane path, optim/adamw.py's
// `_upd`), which are held bit-identical to the reference's jitted XLA on
// the CPU.  So every float32 operation is written with an explicit
// rounding (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), never contracted
// into an FMA, as torch's separate elementwise operators round; the
// float64 steps of `_upd` (its `_fma`: a float32 product, exact in
// float64, plus a float64 add, rounded once; its `_sqrt`: __dsqrt_rn) are
// written in float64; and every flush to zero of XLA's CPU arithmetic is
// the plain versions' own `x * (|x| >= 2**-126)`, so that a subnormal
// becomes a zero of its sign and a NaN stays a NaN.  Nothing is built
// with fast math.
//
// --- ef_amax, ef_apply (one leaf of N float32 values) ----------------------
//
//   total = flush(flush(x) + flush(r)),  e = frexp exponent of max|total|
//   k     = rint(total * scale),  scale = the reference's exp2(23 - e)
//   mag   = saturate_u32(|k|)           (NaN -> 0, >= 2**32 -> 2**32 - 1)
//   q     = sign(k < 0) * flush(((mag & keep) + half) / scale)
//   r'    = flush(total - q)
// where `keep` selects magnitude bits 22 .. 23 - planes (the planes the
// register_block encoder keeps: bits above 22 and below the tail are
// dropped) and `half` is the midpoint of the truncated tail.  That is
// exactly what encoding the sign plane and the top `planes` planes and
// decoding them gives: the planes are lossless on the bits they keep, and
// nothing on the trainer's path reads the planes themselves, so they are
// not formed.
//
// What bounds them: bytes.  ef_amax reads x and r (8 bytes a value);
// ef_apply reads them again and writes q and r' (16 bytes a value); 24
// bytes a value for the pair against the 16 that one fused pass would
// need, since the scale needs the maximum over the whole leaf before the
// first value can be quantized, and a leaf (up to 491 MB at h2o-danube's
// embedding) does not fit the 50 MB L2 between the two passes.  A few
// float32 operations a value (one division) are far below the card's
// operation rate.  Design:
//   * ef_amax is a grid-stride pass, 16-byte loads where every pointer is
//     16-byte aligned; each block leaves its maximum, as the float's bit
//     pattern, in a workspace of one word a block.  The maximum is taken
//     on the pattern as an unsigned integer: |total| is non-negative, so
//     the order is the float order, and a NaN's pattern exceeds inf's, so
//     a NaN propagates as torch.max propagates it (fmaxf would drop it).
//     No atomic and no memset: the same inputs give the same bits on
//     every call;
//   * ef_apply's blocks each reduce the workspace (at most MAX_BLOCKS of
//     kernels/optim.py words, from L2) to the maximum, take e with frexpf and the scale
//     from the port's table of the reference's exp2 (core/align.py
//     `_EXP2_BITS`, passed as the device tensor `exp2_int` reads; past
//     its ends inf or 0, as `exp2_int` gives), and then run the same
//     grid-stride pass as ef_amax, writing q and r'.
//
// --- adamw_update (one leaf of N values) -----------------------------------
//
// One elementwise pass: reads p, g, m, v and the 0-d float32 device
// scalars scale (the clip factor), lr, c1 and c2 (the bias corrections)
// through pointers, so the host never waits for them, and writes new p, m
// and v.  Parameters, gradients and the state are each float32 or
// bfloat16 (8 instantiations); bfloat16 values widen exactly and round to
// nearest even on the way out (__float2bfloat16_rn, which torch's own
// conversion is on the card).  The update is `_upd`, op for op:
//   g  = flush(g * scale);  g2 = flush(g * g)
//   m' = flush(fma64(m, b1, g (1 - b1)))   float32 state (the old moment's
//   v' = flush(fma64(v, b2, g2 (1 - b2)))  product contracted, as XLA)
//   m' = flush(fma64(g, 1 - b1, m b1))     bfloat16 state (the other
//   v' = flush(fma64(g2, 1 - b2, v b2))    product), and the step's v
//                                          formed once more the first way
//   denom = flush(c1 (sqrt64(flush(v_step / c2)) + eps))
//   delta = flush(fma64(p, wd, flush(m' / denom)))
//   p' = flush(fma64(delta, -lr, p))
// with fma64(a, b, c) = round_f32(double(a) * double(b) + double(c)) and
// sqrt64(x) = round_f32(__dsqrt_rn(double(x))).  The Python scalars b1,
// 1 - b1, b2, 1 - b2, eps and wd enter as the float32 values torch's
// binary operators give a wrapped scalar beside a float32 tensor: the
// double rounded once to float32 (the wrapper passes them so).
//
// What bounds it: bytes, 28 a value for a float32 leaf and state (p, g,
// m, v read; p, m, v written), 14 with everything in bfloat16.  The
// float64 work (3-4 products and adds and one square root a value) is
// about 25 float64 instructions a value: by count, under a fifth of the
// time the bytes take at the card's float64 rate.  The pass is a grid-stride loop of 4
// values a thread an iteration, loaded 16 bytes (float32) or 8 bytes
// (bfloat16) at a time where every pointer is so aligned, so that four
// independent loads of each thread are in flight.
//
// --- global_sumsq (each leaf's sum of squares, float64) --------------------
//
// The port's plain version is a chain a leaf (a float64 copy, its square,
// its sum), summed in torch's order; the reference sums in XLA's.  Neither
// order is kept: the kernel's is its own, fixed, so that two calls give
// the same bits whatever the scheduling.  Each leaf is cut into chunks of
// kSumChunk values, whatever the grid; a block of kThreads sums a chunk:
// thread t takes the 16-byte vectors (it * kThreads + t) of the chunk, it
// = 0, 1, ..., and adds their values' squares in order into one float64
// (a float32 value's square is exact in float64, so each step rounds once,
// at the add); then a warp tree (shuffles down 16, 8, 4, 2, 1) and a tree
// over the 8 warps (4, 2, 1) give the chunk's partial.  A second launch,
// a block a leaf, sums the leaf's partials in the same order (thread t
// takes partials t, t + kThreads, ...; the two trees).  float32 or
// bfloat16 leaves (bfloat16 widens exactly); 16-byte loads where the
// leaf's pointer is 16-byte aligned, the same values one at a time (in the
// same order) where it is not.  An argument block (SumArgs, passed by
// value) holds kSumLeaves leaves; a longer list takes one pair of launches
// a block (the wrapper's).
//
// What bounds it: bytes, each element read once (4 a value in float32,
// 2 in bfloat16); one float64 multiply and add a value, under a tenth of
// that time at the card's float64 rate.  Chunks of 256 KB in float32 keep
// thousands of blocks in flight on a large tree, and a thread issues eight
// 16-byte loads before it adds.
//
// Launches: all run on the caller's stream and allocate nothing; the
// wrapper allocates the outputs, ef_amax's workspace and global_sumsq's
// partials, and picks the elementwise passes' grid (kernels/optim.py
// `blocks`: at most MAX_BLOCKS, 8 blocks of kThreads on each of the 132
// SMs); global_sumsq's grid is a block a chunk and a block a leaf.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMinNormal = 1.1754943508222875e-38f;  // 2**-126
constexpr int kMagBits = 23;
constexpr int kExp2K0 = -126;    // core/align.py _EXP2_K0
constexpr int kExp2Len = 254;    // exp2(k) for k = -126 .. 127
constexpr long long kSumChunk = 65536;   // values a global_sumsq block sums
constexpr int kSumLeaves = 64;           // leaves an argument block
constexpr int kSumBatch = 8;             // 16-byte loads issued at once

// XLA's CPU flush-to-zero as the plain versions write it, x * (|x| >= 2**-126):
// a subnormal becomes a zero of its own sign, NaN stays NaN
__device__ __forceinline__ float flush(float x) {
  return __fmul_rn(x, fabsf(x) >= kMinNormal ? 1.0f : 0.0f);
}

// ------------------------------------------------------------ ef_quantize --

__device__ __forceinline__ float ef_total(float x, float r) {
  return flush(__fadd_rn(flush(x), flush(r)));
}

__device__ __forceinline__ uint32_t abs_bits(float t) {
  return __float_as_uint(t) & 0x7FFFFFFFu;
}

// the largest value of `v` over the block, returned to every thread
__device__ __forceinline__ uint32_t block_max(uint32_t v) {
  __shared__ uint32_t warp_max[kWarps];
  __shared__ uint32_t result;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_max_sync(0xFFFFFFFFu, v);
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = __reduce_max_sync(0xFFFFFFFFu, lane < kWarps ? warp_max[lane] : 0u);
    if (lane == 0) result = v;
  }
  __syncthreads();
  return result;
}

__global__ void __launch_bounds__(kThreads)
ef_amax_kernel(const float* __restrict__ x, const float* __restrict__ r,
               uint32_t* __restrict__ part, long long n, int vec) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  uint32_t best = 0;
  long long done = 0;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* r4 = reinterpret_cast<const float4*>(r);
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      const float4 a = x4[i], b = r4[i];
      best = max(best, max(max(abs_bits(ef_total(a.x, b.x)),
                               abs_bits(ef_total(a.y, b.y))),
                           max(abs_bits(ef_total(a.z, b.z)),
                               abs_bits(ef_total(a.w, b.w)))));
    }
    done = 4 * n4;
  }
  for (long long i = done + tid; i < n; i += stride)
    best = max(best, abs_bits(ef_total(x[i], r[i])));
  best = block_max(best);
  if (threadIdx.x == 0) part[blockIdx.x] = best;
}

struct EfCode {
  float scale;
  uint32_t keep;   // the magnitude bits the planes keep
  uint32_t half;   // the midpoint of the truncated tail
};

__device__ __forceinline__ void ef_value(float x, float r, const EfCode& c,
                                         float& q, float& res) {
  const float t = ef_total(x, r);
  const float k = rintf(__fmul_rn(t, c.scale));   // round half to even
  const float a = fabsf(k);
  const uint32_t mag = isnan(a) ? 0u
                       : (a >= 4294967296.0f ? 0xFFFFFFFFu : (uint32_t)a);
  // < 2**23, so the conversion is exact
  const float v = flush(__fdiv_rn((float)((mag & c.keep) + c.half), c.scale));
  q = k < 0.0f ? -v : v;          // -0.0 decodes positive
  res = flush(__fsub_rn(t, q));
}

__global__ void __launch_bounds__(kThreads)
ef_apply_kernel(const float* __restrict__ x, const float* __restrict__ r,
                const uint32_t* __restrict__ part, int parts,
                const float* __restrict__ table, float* __restrict__ q,
                float* __restrict__ r_out, long long n, int planes, int vec) {
  uint32_t best = 0;
  for (int i = threadIdx.x; i < parts; i += kThreads) best = max(best, part[i]);
  best = block_max(best);
  const float amax = __uint_as_float(best);
  int e = 0;
  frexpf(amax, &e);
  if (!(amax > 0.0f)) e = 0;       // zero and NaN
  const int k = kMagBits - e;
  EfCode c;
  c.scale = k > kExp2K0 + kExp2Len - 1 ? INFINITY
            : (k < kExp2K0 ? 0.0f : table[k - kExp2K0]);
  const int tail = kMagBits - planes;
  c.keep = ((1u << kMagBits) - 1u) & ~((1u << tail) - 1u);
  c.half = tail > 0 ? 1u << (tail - 1) : 0u;

  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* r4 = reinterpret_cast<const float4*>(r);
    float4* q4 = reinterpret_cast<float4*>(q);
    float4* o4 = reinterpret_cast<float4*>(r_out);
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      const float4 a = x4[i], b = r4[i];
      float4 qq, rr;
      ef_value(a.x, b.x, c, qq.x, rr.x);
      ef_value(a.y, b.y, c, qq.y, rr.y);
      ef_value(a.z, b.z, c, qq.z, rr.z);
      ef_value(a.w, b.w, c, qq.w, rr.w);
      q4[i] = qq;
      o4[i] = rr;
    }
    done = 4 * n4;
  }
  for (long long i = done + tid; i < n; i += stride)
    ef_value(x[i], r[i], c, q[i], r_out[i]);
}

// ----------------------------------------------------------------- AdamW --

struct AdamConsts {
  float b1, omb1, b2, omb2, eps, wd;
};

// `_fma`: a float32 product, exact in float64, plus a float64 add, rounded
// once to float32
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b),
                                     (double)c));
}

__device__ __forceinline__ float sqrt64(float x) {
  return __double2float_rn(__dsqrt_rn((double)x));
}

// `_moment`: old * b + x * (1 - b), the product with the old moment
// contracted (old_product) or else the other one
__device__ __forceinline__ float moment(float old, float b, float omb,
                                       float x, bool old_product) {
  return old_product ? flush(fma64(old, b, __fmul_rn(x, omb)))
                     : flush(fma64(x, omb, __fmul_rn(old, b)));
}

struct AdamScalars {
  float scale, lr, c1, c2;
};

template <bool kF32State>
__device__ __forceinline__ void adamw_value(float p, float g, float m,
                                            float v, const AdamScalars& s,
                                            const AdamConsts& c, float& np,
                                            float& nm, float& nv) {
  const float gs = flush(__fmul_rn(g, s.scale));
  const float g2 = flush(__fmul_rn(gs, gs));
  nm = moment(m, c.b1, c.omb1, gs, kF32State);
  nv = moment(v, c.b2, c.omb2, g2, kF32State);
  const float v_step = kF32State ? nv : moment(v, c.b2, c.omb2, g2, true);
  const float denom = flush(__fmul_rn(
      s.c1, __fadd_rn(sqrt64(flush(__fdiv_rn(v_step, s.c2))), c.eps)));
  const float delta = flush(fma64(p, c.wd, flush(__fdiv_rn(nm, denom))));
  np = flush(fma64(delta, -s.lr, p));
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// four consecutive values at p[i .. i + 3], i a multiple of 4 and p
// aligned to four of its values: one 16-byte (float32) or 8-byte
// (bfloat16) access
__device__ __forceinline__ void load4(const float* p, long long i,
                                      float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p + i);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, long long i,
                                      float (&o)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p + i);
  o[0] = __uint_as_float(t.x << 16);
  o[1] = __uint_as_float(t.x & 0xFFFF0000u);
  o[2] = __uint_as_float(t.y << 16);
  o[3] = __uint_as_float(t.y & 0xFFFF0000u);
}
__device__ __forceinline__ void store4(float* p, long long i,
                                       const float (&v)[4]) {
  *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, long long i,
                                       const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p + i) =
      make_uint2(bf16_bits(v[0]) | (bf16_bits(v[1]) << 16),
                 bf16_bits(v[2]) | (bf16_bits(v[3]) << 16));
}

template <typename P, typename G, typename S>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const P* __restrict__ p, const G* __restrict__ g,
             const S* __restrict__ m, const S* __restrict__ v,
             const float* __restrict__ scale_p,
             const float* __restrict__ lr_p, const float* __restrict__ c1_p,
             const float* __restrict__ c2_p, P* __restrict__ p_out,
             S* __restrict__ m_out, S* __restrict__ v_out, long long n,
             AdamConsts c, int vec) {
  constexpr bool kF32State = sizeof(S) == 4;
  AdamScalars s;
  s.scale = *scale_p;
  s.lr = *lr_p;
  s.c1 = *c1_p;
  s.c2 = *c2_p;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    for (long long j = tid; j < n4; j += stride) {
      const long long i = 4 * j;
      float pp[4], gg[4], mm[4], vv[4], np[4], nm[4], nv[4];
      load4(p, i, pp);
      load4(g, i, gg);
      load4(m, i, mm);
      load4(v, i, vv);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        adamw_value<kF32State>(pp[u], gg[u], mm[u], vv[u], s, c, np[u],
                               nm[u], nv[u]);
      store4(p_out, i, np);
      store4(m_out, i, nm);
      store4(v_out, i, nv);
    }
    done = 4 * n4;
  }
  for (long long i = done + tid; i < n; i += stride) {
    float np, nm, nv;
    adamw_value<kF32State>(widen(p[i]), widen(g[i]), widen(m[i]),
                           widen(v[i]), s, c, np, nm, nv);
    p_out[i] = narrow<P>(np);
    m_out[i] = narrow<S>(nm);
    v_out[i] = narrow<S>(nv);
  }
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// ----------------------------------------------------------- global_sumsq --

struct SumArgs {
  const void* ptr[kSumLeaves];
  long long n[kSumLeaves];
  long long first[kSumLeaves + 1];   // each leaf's first chunk, then the total
  unsigned long long bf16;           // bit l: leaf l is bfloat16
  unsigned long long vec;            // bit l: leaf l is 16-byte aligned
  int leaves;
};

__device__ __forceinline__ double sq_add(double acc, float x) {
  const double d = static_cast<double>(x);
  return __dadd_rn(acc, __dmul_rn(d, d));
}

// value u of the 16 bytes q, as float
template <typename T>
__device__ __forceinline__ float vec_value(const uint4& q, int u);
template <>
__device__ __forceinline__ float vec_value<float>(const uint4& q, int u) {
  return __uint_as_float(u == 0 ? q.x : u == 1 ? q.y : u == 2 ? q.z : q.w);
}
template <>
__device__ __forceinline__ float vec_value<__nv_bfloat16>(const uint4& q,
                                                          int u) {
  const int k = u >> 1;
  const uint32_t w = k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
  return __uint_as_float(u & 1 ? w & 0xFFFF0000u : w << 16);
}

// this thread's float64 sum of squares over chunk c of the leaf x (n
// values), in the fixed order: vector (it * kThreads + thread), it = 0, 1,
// ..., its values in order
template <typename T>
__device__ __forceinline__ double chunk_sumsq(const T* __restrict__ x,
                                              long long n, long long c,
                                              bool vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kSteps = kSumChunk / (kThreads * V);
  static_assert(kSteps % kSumBatch == 0, "a chunk is whole batches");
  const long long c0 = c * kSumChunk;
  double acc = 0.0;
  if (vec && c0 + kSumChunk <= n) {
#pragma unroll 1
    for (int it0 = 0; it0 < kSteps; it0 += kSumBatch) {
      uint4 q[kSumBatch];
#pragma unroll
      for (int g = 0; g < kSumBatch; ++g) {
        q[g] = __ldg(reinterpret_cast<const uint4*>(
            x + c0 + (static_cast<long long>(it0 + g) * kThreads
                      + threadIdx.x) * V));
      }
#pragma unroll
      for (int g = 0; g < kSumBatch; ++g) {
#pragma unroll
        for (int u = 0; u < V; ++u) acc = sq_add(acc, vec_value<T>(q[g], u));
      }
    }
  } else {
    for (int it = 0; it < kSteps; ++it) {
      const long long e = c0 + (static_cast<long long>(it) * kThreads
                                + threadIdx.x) * V;
      for (int u = 0; u < V; ++u) {
        if (e + u < n) acc = sq_add(acc, widen(x[e + u]));
      }
    }
  }
  return acc;
}

// the block's sum of v, in a fixed order: a warp tree, then a tree over
// the warps; thread 0's return is the block's
__device__ __forceinline__ double block_sum_fixed(double v) {
  __shared__ double warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    v = __dadd_rn(v, __shfl_down_sync(0xFFFFFFFFu, v, d));
  }
  if (lane == 0) warp_sum[warp] = v;
  __syncthreads();
  double r = 0.0;
  if (warp == 0) {
    r = lane < kWarps ? warp_sum[lane] : 0.0;
#pragma unroll
    for (int d = kWarps / 2; d > 0; d >>= 1) {
      r = __dadd_rn(r, __shfl_down_sync(0xFFFFFFFFu, r, d));
    }
  }
  return r;
}

// A block a chunk, the leaves' chunks in order: the chunk's partial.
__global__ void __launch_bounds__(kThreads)
sumsq_chunks_kernel(const __grid_constant__ SumArgs a,
                    double* __restrict__ partials) {
  const long long blk = blockIdx.x;
  // the last leaf whose first chunk is at or before this one (an empty
  // leaf's first is its successor's)
  int lo = 0, hi = a.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.first[mid] <= blk) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long c = blk - a.first[lo];
  const bool vec = (a.vec >> lo) & 1ull;
  const double v = (a.bf16 >> lo) & 1ull
      ? chunk_sumsq(static_cast<const __nv_bfloat16*>(a.ptr[lo]), a.n[lo], c,
                    vec)
      : chunk_sumsq(static_cast<const float*>(a.ptr[lo]), a.n[lo], c, vec);
  const double r = block_sum_fixed(v);
  if (threadIdx.x == 0) partials[blk] = r;
}

// A block a leaf: its partials summed in the fixed order.
__global__ void __launch_bounds__(kThreads)
sumsq_leaves_kernel(const __grid_constant__ SumArgs a,
                    const double* __restrict__ partials,
                    double* __restrict__ out) {
  const int l = blockIdx.x;
  const long long p0 = a.first[l], cnt = a.first[l + 1] - p0;
  double acc = 0.0;
  for (long long i = threadIdx.x; i < cnt; i += kThreads) {
    acc = __dadd_rn(acc, partials[p0 + i]);
  }
  const double r = block_sum_fixed(acc);
  if (threadIdx.x == 0) out[l] = r;
}

template <typename P, typename G, typename S>
int launch_adamw(const void* p, const void* g, const void* m, const void* v,
                 const void* scale, const void* lr, const void* c1,
                 const void* c2, void* p_out, void* m_out, void* v_out,
                 long long n, const AdamConsts& c, int blocks,
                 cudaStream_t stream) {
  const int vec = aligned(p, 4 * sizeof(P)) && aligned(p_out, 4 * sizeof(P))
                  && aligned(g, 4 * sizeof(G)) && aligned(m, 4 * sizeof(S))
                  && aligned(v, 4 * sizeof(S)) && aligned(m_out, 4 * sizeof(S))
                  && aligned(v_out, 4 * sizeof(S));
  adamw_kernel<P, G, S><<<blocks, kThreads, 0, stream>>>(
      static_cast<const P*>(p), static_cast<const G*>(g),
      static_cast<const S*>(m), static_cast<const S*>(v),
      static_cast<const float*>(scale), static_cast<const float*>(lr),
      static_cast<const float*>(c1), static_cast<const float*>(c2),
      static_cast<P*>(p_out), static_cast<S*>(m_out), static_cast<S*>(v_out),
      n, c, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch (0 = success).

// part: `blocks` words, one maximum a block
int ef_amax(const void* x, const void* r, void* part, long long n, int blocks,
            void* stream) {
  const int vec = aligned(x, 16) && aligned(r, 16);
  ef_amax_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(r),
      static_cast<uint32_t*>(part), n, vec);
  return (int)cudaGetLastError();
}

// part: ef_amax's `parts` words; table: the kExp2Len float32 exp2 values
int ef_apply(const void* x, const void* r, const void* part, int parts,
             const void* table, void* q, void* r_out, long long n, int planes,
             int blocks, void* stream) {
  const int vec = aligned(x, 16) && aligned(r, 16) && aligned(q, 16)
                  && aligned(r_out, 16);
  ef_apply_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(r),
      static_cast<const uint32_t*>(part), parts,
      static_cast<const float*>(table), static_cast<float*>(q),
      static_cast<float*>(r_out), n, planes, vec);
  return (int)cudaGetLastError();
}

// ptrs, ns, bf16: `leaves` (1 .. kSumLeaves) host arrays: each leaf's
// device pointer, its values and its flag (1: bfloat16, else float32);
// partials: (the leaves' chunks, ceil(n / kSumChunk) each) float64
// scratch; out: (leaves,) float64.  The chunks' launch (where there is a
// chunk), then the leaves'.
int global_sumsq(const long long* ptrs, const long long* ns, const int* bf16,
                 int leaves, void* partials, void* out, void* stream) {
  if (leaves < 1 || leaves > kSumLeaves) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SumArgs a = {};
  a.leaves = leaves;
  for (int l = 0; l < leaves; ++l) {
    a.ptr[l] = reinterpret_cast<const void*>(ptrs[l]);
    a.n[l] = ns[l];
    a.first[l + 1] = a.first[l] + (ns[l] + kSumChunk - 1) / kSumChunk;
    if (bf16[l]) a.bf16 |= 1ull << l;
    if (aligned(a.ptr[l], 16)) a.vec |= 1ull << l;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* part = static_cast<double*>(partials);
  int err = 0;
  if (a.first[leaves] > 0) {
    sumsq_chunks_kernel<<<static_cast<unsigned>(a.first[leaves]), kThreads,
                          0, st>>>(a, part);
    err = static_cast<int>(cudaGetLastError());
  }
  sumsq_leaves_kernel<<<leaves, kThreads, 0, st>>>(a, part,
                                                   static_cast<double*>(out));
  const int e = static_cast<int>(cudaGetLastError());
  return err != 0 ? err : e;
}

// bf16: bit 0 the parameters, bit 1 the gradient, bit 2 the state are
// bfloat16 (else float32); scale, lr, c1, c2: 0-d float32 device tensors
int adamw_update(const void* p, const void* g, const void* m, const void* v,
                 const void* scale, const void* lr, const void* c1,
                 const void* c2, void* p_out, void* m_out, void* v_out,
                 long long n, int bf16, float b1, float omb1, float b2,
                 float omb2, float eps, float wd, int blocks, void* stream) {
  const AdamConsts c{b1, omb1, b2, omb2, eps, wd};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using F = float;
  using B = __nv_bfloat16;
#define REPRO_ADAMW(P, G, S)                                                 \
  return launch_adamw<P, G, S>(p, g, m, v, scale, lr, c1, c2, p_out, m_out, \
                               v_out, n, c, blocks, st)
  switch (bf16 & 7) {
    case 0: REPRO_ADAMW(F, F, F);
    case 1: REPRO_ADAMW(B, F, F);
    case 2: REPRO_ADAMW(F, B, F);
    case 3: REPRO_ADAMW(B, B, F);
    case 4: REPRO_ADAMW(F, F, B);
    case 5: REPRO_ADAMW(B, F, B);
    case 6: REPRO_ADAMW(F, B, B);
    default: REPRO_ADAMW(B, B, B);
  }
#undef REPRO_ADAMW
}

}  // extern "C"
