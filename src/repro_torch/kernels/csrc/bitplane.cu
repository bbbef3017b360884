// Bitplane encode/decode for the three designs of the reference package,
// hand-written for Hopper (sm_90a).  Plain C interface, loaded with ctypes.
//
// Replaces the TPU kernels of src/repro/kernels/bitplane.py (every function
// there that reaches `pl.pallas_call`):
//   rb_encode      <- `_encode_register_block_kernel` (with
//                     `_transpose32_butterfly`), via `encode_pallas` (:199)
//   rb_decode      <- `_decode_register_block_kernel`, via `decode_pallas`
//                     (:232)
//   loc_encode     <- `_encode_locality_kernel`, via `encode_pallas` (:199)
//   shuffle_encode <- `_encode_shuffle_kernel`, via `encode_pallas` (:199)
//   loc_decode     <- `_decode_locality_kernel`, via `decode_pallas` (:247);
//                     it decodes both the `locality` and `shuffle` designs,
//                     which share one format
//
// --- register_block (rb_encode, rb_decode) ---------------------------------
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
// --- locality / shuffle (loc_encode, shuffle_encode, loc_decode) ----------
//
// Format: word w of plane j holds bit P_total - 1 - j of the 32 consecutive
// elements 32 w .. 32 w + 31 (element 32 w + i -> bit i).  N is padded to a
// whole 4096-element tile, as for register_block, so the plane sizes agree.
//
// What bounds them: they move the same bytes as register_block (4 bytes in
// and 4 P / 32 bytes out per element on encode, the reverse on decode).  A
// 32-element word is exactly one warp's worth of consecutive elements, which
// is what paper section 4.1 builds on; a CTA of 4 warps covers 128 words,
// a warp 32 consecutive words (1,024 elements, 4 KB):
//   * loc_encode: one thread per word, the mirror of loc_decode.  The warp
//     loads its 32 words' 1,024 elements coalesced (all 32 loads issued
//     first, so each warp has 4 KB in flight) and writes them to the per-warp
//     32 x 33 shared tile, row k holding word k's 32 elements; lane l then
//     reads row l, its own word.  For more than kDirectPlanes planes the
//     thread transposes the 32 x 32 bits in registers, as rb_encode does
//     (~500 integer ops per word, whatever P is), and stores plane j's word,
//     128 consecutive bytes per warp and plane.  For kDirectPlanes planes or
//     fewer it gathers each plane's word directly: element i is rotated left
//     by i once (bit b to bit b + i), then plane b's word is the OR of 32
//     single-bit masks, one LOP3 with an immediate mask per element and
//     plane, and one rotate back -- ~33 P + 32 ops per word.  Half of the
//     launches encode the sign plane (P = 1), where the transpose's fixed
//     work would cost more than its bytes.  A warp vote, a bit extract and
//     a select per word and plane (the form of paper section 4.1) is bound
//     by instruction issue, ~3x its byte bound at P = 23, not by bytes.
//   * shuffle_encode (paper section 4.2: the words are formed by exchange
//     across the warp's lanes with `__shfl_xor_sync`, the counterpart of the
//     `jnp.roll` OR tree of the TPU kernel): the exchange moves all planes at
//     once, as a 32x32 bit-matrix butterfly across the lanes.  For word
//     column k, lane l holds element 32 (word0 + k) + 31 - l, shifted so
//     that magnitude bit P - 1 sits at bit 31; five stages, one shuffle, one
//     rotate and one bit select each, leave plane j's word of the column in
//     lane j.  That is 5 shuffles per word for all planes; a one-bit OR tree
//     per plane needs 5 per word and plane, and the SM's rate of about one
//     warp shuffle per clock then bounds it, not bytes.  The 32 columns are
//     staged in a per-warp 32 x 33 word shared tile (the pad keeps both the
//     column writes and the row reads free of bank conflicts), and the P
//     live planes are stored from it, 128 consecutive bytes per warp and
//     plane.  All 32 column loads are issued before the first butterfly, so
//     each warp has 4 KB in flight.  About 15 shuffles and integer ops per
//     element keep it under its byte bound, but not by much.
//   * loc_decode: one thread per word, the shape of rb_decode.  Thread w
//     loads word w of each of the P' rows (all loads issued first, predicated
//     on the row count; 128 consecutive bytes per warp and row), transposes
//     the 32 x 32 bits in registers and so holds the 32 magnitudes of
//     elements 32 w .. 32 w + 31.  They go through the same per-warp shared
//     tile, so that each store instruction writes 32 consecutive elements.
//     A thread per element would read each row word as a 32-way broadcast,
//     with one row's load in flight per warp, and memory latency would bound
//     it; a thread per word issues 32 times fewer loads and keeps every
//     row's load in flight at once, so that bytes bound it.
// Every lane of a launched warp is live (the grid covers exactly W words, so
// 32 W elements): elements from n up to the tile boundary read as 0, which
// makes the padded words zeros and keeps the full-warp masks valid.
//
// Shifts: every shift count is kept in [0, 31] (planes, total in [1, 32]
// and rows <= total are checked by the Python wrapper), so no shift by 32 is
// ever evaluated.

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

// ---------------------------------------------------- locality / shuffle --

constexpr int kWarpsPerBlock = 4;
constexpr int kLocThreads = 32 * kWarpsPerBlock;   // 128 words per CTA

// Loads the 1,024 consecutive elements of one warp's 32 words: v[k] is
// element 32 (word0 + k) + slot, 0 past n; slot is the lane or, for
// shuffle_encode, 31 - lane.
__device__ __forceinline__ void load_warp_words(const uint32_t* __restrict__ xr,
                                                int64_t n, int64_t word0,
                                                int slot, uint32_t (&v)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int64_t idx = (word0 + k) * 32 + slot;
    v[k] = idx < n ? __ldg(xr + idx) : 0u;
  }
}

// Per-warp staging tile of 32 x 32 words; row pitch 33 so that a column of
// lanes and a row of lanes both touch 32 different banks.
using WarpTile = uint32_t[32][33];

// loc_encode_kernel gathers the words of at most this many planes bit by bit
// (~33 P + 32 ops per word) and transposes above it (~500).
constexpr int kDirectPlanes = 8;

// One CTA of 128 threads covers 128 words: warp w of the CTA the 32 words
// from 128 blockIdx.x + 32 w, lane l of the warp word word0 + l; blockIdx.y
// is the batch row.
// x: (batch, x_stride) magnitudes, n valid per row
// out: (batch, planes, words)
__global__ void __launch_bounds__(kLocThreads)
loc_encode_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                  int64_t n, int64_t x_stride, int planes, int64_t words) {
  __shared__ WarpTile tiles[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  WarpTile& tile = tiles[threadIdx.x >> 5];
  const int64_t word0 =
      (int64_t)blockIdx.x * kLocThreads + (threadIdx.x >> 5) * 32;
  const uint32_t* xr = x + (int64_t)blockIdx.y * x_stride;
  uint32_t* outr = out + (int64_t)blockIdx.y * planes * words + word0 + lane;
  uint32_t a[32];
  load_warp_words(xr, n, word0, lane, a);
#pragma unroll
  for (int k = 0; k < 32; ++k) tile[k][lane] = a[k];
  __syncwarp();
  // tile[lane][i] is element i of this thread's word, word0 + lane
  if (planes <= kDirectPlanes) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const uint32_t t = tile[lane][i];
      a[i] = __funnelshift_l(t, t, i);  // bit b -> bit (b + i) mod 32
    }
#pragma unroll
    for (int b = 0; b < kDirectPlanes; ++b) {
      if (b < planes) {  // magnitude bit b is plane planes - 1 - b
        uint32_t acc = 0;
#pragma unroll
        for (int i = 0; i < 32; ++i) acc |= a[i] & (1u << ((b + i) & 31));
        outr[(int64_t)(planes - 1 - b) * words] = __funnelshift_r(acc, acc, b);
      }
    }
  } else {
    // left-align magnitude bit (planes - 1) at bit 31 and reverse the
    // element order, so that transposed row j is plane j's word
    const int sh = 32 - planes;  // in [0, 31]
#pragma unroll
    for (int i = 0; i < 32; ++i) a[31 - i] = tile[lane][i] << sh;
    transpose32(a);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j < planes) outr[(int64_t)j * words] = a[j];
    }
  }
}

// transpose32 across a warp: lane l holds row l, and the pair (k, k + J) of
// butterfly_stage<J> is the lane pair (l, l ^ J).  The lower lane of a pair
// takes its partner's bits (p >> J) & m, the upper one (p << J) & ~m; both
// are a rotation of p and a bit select, with the rotation and the mask kept
// fixed per lane, so a stage is one shuffle and two integer ops.
// Lane 31 - b ends with bit (31 - l) = bit b of lane l's row.
class WarpTranspose32 {
 public:
  __device__ __forceinline__ explicit WarpTranspose32(int lane) {
    init_stage<0, 16>(lane, 0x0000FFFFu);
    init_stage<1, 8>(lane, 0x00FF00FFu);
    init_stage<2, 4>(lane, 0x0F0F0F0Fu);
    init_stage<3, 2>(lane, 0x33333333u);
    init_stage<4, 1>(lane, 0x55555555u);
  }

  __device__ __forceinline__ uint32_t operator()(uint32_t a) const {
    a = stage<0, 16>(a);
    a = stage<1, 8>(a);
    a = stage<2, 4>(a);
    a = stage<3, 2>(a);
    return stage<4, 1>(a);
  }

 private:
  template <int S, int J>
  __device__ __forceinline__ void init_stage(int lane, uint32_t m) {
    const bool upper = lane & J;
    keep_[S] = upper ? m : ~m;
    rot_[S] = upper ? J : 32 - J;  // in [1, 31]
  }

  template <int S, int J>
  __device__ __forceinline__ uint32_t stage(uint32_t a) const {
    const uint32_t p = __shfl_xor_sync(0xffffffffu, a, J);
    const uint32_t r = __funnelshift_l(p, p, rot_[S]);
    return (a & keep_[S]) | (r & ~keep_[S]);
  }

  uint32_t keep_[5];
  int rot_[5];
};

// Same grid as loc_encode_kernel.
__global__ void __launch_bounds__(kLocThreads)
shuffle_encode_kernel(const uint32_t* __restrict__ x,
                      uint32_t* __restrict__ out, int64_t n, int64_t x_stride,
                      int planes, int64_t words) {
  __shared__ WarpTile tiles[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  WarpTile& tile = tiles[threadIdx.x >> 5];
  const int64_t word0 =
      (int64_t)blockIdx.x * kLocThreads + (threadIdx.x >> 5) * 32;
  const uint32_t* xr = x + (int64_t)blockIdx.y * x_stride;
  uint32_t* outr = out + (int64_t)blockIdx.y * planes * words + word0 + lane;
  // lane l takes element 31 - l of each word, so that the transpose leaves
  // plane j in lane j with bit i from element i
  uint32_t v[32];
  load_warp_words(xr, n, word0, 31 - lane, v);
  const int sh = 32 - planes;  // in [0, 31]
  const WarpTranspose32 transpose(lane);
#pragma unroll
  for (int k = 0; k < 32; ++k) tile[lane][k] = transpose(v[k] << sh);
  __syncwarp();
  for (int j = 0; j < planes; ++j) outr[(int64_t)j * words] = tile[j][lane];
}

// One thread per word, as rb_decode_kernel: the grid of loc_encode_kernel,
// thread w of a CTA decodes word 128 blockIdx.x + w; blockIdx.y is the batch
// row.
// planes: (batch, rows, words) prefix, rows <= total
// out: (batch, n) magnitudes with plane j at bit total - 1 - j
__global__ void __launch_bounds__(kLocThreads)
loc_decode_kernel(const uint32_t* __restrict__ planes,
                  uint32_t* __restrict__ out, int64_t n, int rows, int total,
                  int64_t words) {
  __shared__ WarpTile tiles[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  WarpTile& tile = tiles[threadIdx.x >> 5];
  const int64_t word0 =
      (int64_t)blockIdx.x * kLocThreads + (threadIdx.x >> 5) * 32;
  const uint32_t* pr =
      planes + (int64_t)blockIdx.y * rows * words + word0 + lane;
  uint32_t* outr = out + (int64_t)blockIdx.y * n;
  uint32_t a[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    a[j] = j < rows ? __ldg(pr + (int64_t)j * words) : 0u;
  }
  transpose32(a);  // a[31 - i] bit (31 - j) = plane j bit i
  const int sh = 32 - total;  // in [0, 31]
#pragma unroll
  for (int i = 0; i < 32; ++i) tile[lane][i] = a[31 - i] >> sh;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int64_t idx = (word0 + i) * 32 + lane;
    if (idx < n) outr[idx] = tile[i][lane];
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

int loc_encode(const void* x, void* out, long long n, long long x_stride,
               int batch, int planes, long long words, void* stream) {
  const dim3 grid((unsigned)(words / kLocThreads), (unsigned)batch);
  loc_encode_kernel<<<grid, kLocThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n,
      x_stride, planes, words);
  return (int)cudaGetLastError();
}

int shuffle_encode(const void* x, void* out, long long n, long long x_stride,
                   int batch, int planes, long long words, void* stream) {
  const dim3 grid((unsigned)(words / kLocThreads), (unsigned)batch);
  shuffle_encode_kernel<<<grid, kLocThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n,
      x_stride, planes, words);
  return (int)cudaGetLastError();
}

int loc_decode(const void* planes, void* out, long long n, int batch,
               int rows, int total, long long words, void* stream) {
  const dim3 grid((unsigned)(words / kLocThreads), (unsigned)batch);
  loc_decode_kernel<<<grid, kLocThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), static_cast<uint32_t*>(out), n,
      rows, total, words);
  return (int)cudaGetLastError();
}

}  // extern "C"
