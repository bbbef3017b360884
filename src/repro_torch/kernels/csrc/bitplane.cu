// Bitplane encode/decode for the `register_block` format, hand-written for
// Hopper (sm_90a).  Plain C interface, loaded with ctypes.
//
// Replaces the TPU kernels of the reference package:
//   rb_encode  <- src/repro/kernels/bitplane.py `_encode_register_block_kernel`
//                 (with `_transpose32_butterfly`), reached through
//                 `encode_pallas` -> `pl.pallas_call` (bitplane.py:199)
//   rb_decode  <- src/repro/kernels/bitplane.py `_decode_register_block_kernel`,
//                 reached through `decode_pallas` -> `pl.pallas_call` (:232)
//
// Format (kernels/ref.py): within 4096-element tile t, the element at flat
// index 4096 t + 128 i + l supplies bit i of word 128 t + l of every plane;
// planes are MSB-first (plane j carries magnitude bit P_total - 1 - j).
//
// What bounds it: both kernels are memory-bound.  Encoding P planes reads
// 4 bytes and writes 4 P / 32 bytes per element; the butterfly transpose
// costs ~512 integer ops per 32 elements (5 stages x 16 pairs x ~6 ops),
// about 2-3 ops per byte moved, against the card's ~5 INT32 ops per byte of
// HBM bandwidth.  Memory sets the bound, but not by a wide margin, so the
// transpose must stay in registers and the design aims at moving each
// byte once, coalesced:
//   * one thread per (tile, lane): thread l of a tile loads the 32
//     elements 4096 t + 128 i + l, i = 0..31 -- for each i the 32 threads of
//     a warp read 128 consecutive bytes (one coalesced transaction);
//   * the 32x32 bit transpose runs in registers (5 butterfly stages, no
//     shared memory, no cross-thread exchange -- the format was chosen so
//     that none is needed);
//   * plane word j of the tile is written by the same thread at column
//     128 t + l, again 128 consecutive bytes per warp and plane.
// One CTA of 128 threads per tile (the blocking that measured fastest on
// the H100; the reference's `tiles_per_block` and `unroll` knobs select
// Pallas blocking and a slower transpose, never a bit of the output, and
// are not taken here).  The kernels allocate nothing and launch on the
// caller's stream.
//
// Shifts: every shift count is kept in [0, 31] (planes, total in [1, 32]
// are checked by the Python wrapper), so no shift by 32 is ever evaluated.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileSub = 32;
constexpr int kTileLane = 128;
constexpr int64_t kTile = kTileSub * kTileLane;

// One stage of the Hacker's-Delight 32x32 bit-matrix transpose: pairs
// (k, k + J) with bit J of k clear.  J and the mask are compile-time
// constants, so the unrolled loop touches registers only.
template <int J>
__device__ __forceinline__ void butterfly_stage(uint32_t (&a)[32],
                                                uint32_t m) {
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if ((k & J) == 0) {
      const uint32_t t = (a[k] ^ (a[k + J] >> J)) & m;
      a[k] ^= t;
      a[k + J] ^= t << J;
    }
  }
}

// in[i] bit b -> out[31 - b] bit (31 - i)
__device__ __forceinline__ void transpose32(uint32_t (&a)[32]) {
  butterfly_stage<16>(a, 0x0000FFFFu);
  butterfly_stage<8>(a, 0x00FF00FFu);
  butterfly_stage<4>(a, 0x0F0F0F0Fu);
  butterfly_stage<2>(a, 0x33333333u);
  butterfly_stage<1>(a, 0x55555555u);
}

// One CTA of 128 threads per 4096-element tile: blockIdx.x is the tile,
// blockIdx.y the batch row, threadIdx.x the lane.
// x: (batch, x_stride) magnitudes, n valid per row (elements past n read 0)
// out: (batch, planes, words), words = 128 * tiles
__global__ void __launch_bounds__(kTileLane)
rb_encode_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 int64_t n, int64_t x_stride, int planes, int64_t words) {
  const int lane = threadIdx.x;
  const int64_t t = blockIdx.x;
  const uint32_t* xr = x + (int64_t)blockIdx.y * x_stride;
  uint32_t* outr = out + (int64_t)blockIdx.y * planes * words;
  const int64_t base = t * kTile + lane;
  const int64_t col = t * kTileLane + lane;
  // left-align magnitude bit (planes - 1) at bit 31 and reverse the slot
  // order, so that transposed row j is plane word j with bit i <- slot i
  const int sh = 32 - planes;  // in [0, 31]
  uint32_t a[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int64_t idx = base + (int64_t)i * kTileLane;
    a[31 - i] = (idx < n ? __ldg(xr + idx) : 0u) << sh;
  }
  transpose32(a);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j < planes) outr[(int64_t)j * words + col] = a[j];
  }
}

// planes: (batch, rows, words) prefix, rows <= total
// out: (batch, n) magnitudes with plane j at bit total - 1 - j
__global__ void __launch_bounds__(kTileLane)
rb_decode_kernel(const uint32_t* __restrict__ planes,
                 uint32_t* __restrict__ out, int64_t n, int rows, int total,
                 int64_t words) {
  const int lane = threadIdx.x;
  const int64_t t = blockIdx.x;
  const uint32_t* pr = planes + (int64_t)blockIdx.y * rows * words;
  uint32_t* outr = out + (int64_t)blockIdx.y * n;
  const int64_t base = t * kTile + lane;
  const int64_t col = t * kTileLane + lane;
  uint32_t a[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    a[j] = j < rows ? __ldg(pr + (int64_t)j * words + col) : 0u;
  }
  transpose32(a);  // a[31 - i] bit (31 - j) = plane j bit i
  const int sh = 32 - total;  // in [0, 31]
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int64_t idx = base + (int64_t)i * kTileLane;
    if (idx < n) outr[idx] = a[31 - i] >> sh;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success).
int rb_encode(const void* x, void* out, long long n, long long x_stride,
              int batch, int planes, long long words, void* stream) {
  const dim3 grid((unsigned)(words / kTileLane), (unsigned)batch);
  rb_encode_kernel<<<grid, kTileLane, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n,
      x_stride, planes, words);
  return (int)cudaGetLastError();
}

int rb_decode(const void* planes, void* out, long long n, int batch,
              int rows, int total, long long words, void* stream) {
  const dim3 grid((unsigned)(words / kTileLane), (unsigned)batch);
  rb_decode_kernel<<<grid, kTileLane, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), static_cast<uint32_t*>(out), n,
      rows, total, words);
  return (int)cudaGetLastError();
}

}  // extern "C"
