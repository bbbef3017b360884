// Algorithm 2's lossless codec, hand-written for Hopper (sm_90a).
// Plain C interface, loaded with ctypes (kernels/lossless.py).
//
// Replace no Pallas kernel.  The reference jits each device part of its
// lossless stage into one XLA program; the port ran them as eager chains
// of int64 torch operators:
//   lossless_stats  <- `_group_stats_batch` (src/repro/core/lossless_batch.py:163):
//                      a bucket's 256-bin histograms and RLE run counts
//   huffman_pack    <- `_huffman_pack` (src/repro/core/lossless.py:216)
//   huffman_decode  <- `_huffman_unpack` (src/repro/core/lossless.py:238):
//                      a `lax.scan` of CHUNK steps, vmapped over chunks
//   rle_scan        <- `_rle_scan` (src/repro/core/lossless.py:265)
//   rle_expand      <- `_rle_expand` (src/repro/core/lossless.py:280)
//
// Rows.  Every operator takes a bucket: B rows of one length, row b at
// b * (row length) of a contiguous buffer.  Chunks or tiles of a row go on
// gridDim.x, rows on gridDim.y, at most kMaxRows rows a launch (the C
// entry points split larger buckets).  A row need not start 16-byte
// aligned (its length need not be a multiple of 16): 16-byte loads and
// stores are taken where the address is so aligned and the bytes lie in
// the row, bytes one at a time elsewhere.
//
// Byte identity.  Each kernel gives, on every row, the bytes of the port's
// plain version (core/lossless.py, core/lossless_batch.py), which the CPU
// tests hold to the reference.  Integer sums are exact in any order.  The
// Huffman pack ORs codes where the plain version adds them: the codes of
// one stream occupy disjoint bits, so OR and add agree, in any order.
//
// The row-scan helper (row_scan_kernel) is one block a row over that
// row's tile totals: the exclusive prefix sums (int64) and the row's
// total.  The Huffman pack scans its chunks' bit counts with it, the RLE
// scan its tiles' run counts, the RLE expand its tiles' run lengths.
//
// --- lossless_stats --------------------------------------------------------
//
// One pass, a block of 256 threads over 16,384 symbols, 16-byte loads.
// Each warp histograms into its own 256 bins in shared memory; a thread
// first counts runs of one symbol in registers and adds a run with one
// shared atomic, since bitplane groups are run-heavy and an all-zero
// plane would otherwise serialize every warp on bin 0.  The block then
// adds each non-zero bin into the row with one 64-bit atomic.  A run
// break is `_rle_scan`'s: the neighbour differs, or idx % RLE_BREAK == 0;
// a thread's first symbol takes its left neighbour from the lane before
// (lane 0 reads it).  Bound: bytes, the row read once.
//
// --- huffman_pack -----------------------------------------------------------
//
// Three passes over chunks of CHUNK = 4096 symbols, a block of 256 threads
// (16 symbols each) a chunk:
//   1. huff_bits_kernel sums the chunk's code lengths;
//   2. the row-scan helper turns the chunk totals into each chunk's first
//      bit (chunk_offs, the exclusive bit offset of every CHUNK-th symbol)
//      and the row's total_bits;
//   3. huff_pack_kernel scans the chunk's lengths over the block and ORs
//      each code's one or two words into a shared tile of the words the
//      chunk's bits touch (at most 2,049), then stores the interior words
//      and atomicOr's its first and last word, which it may share with its
//      neighbours, into the output that the wrapper zeroed.
// Bound: bytes, the symbols read once and the (B, S * 16 / 32 + 2) words
// written once; the passes read the symbols twice and the zeroing writes
// the words before the pack writes the stream's.
//
// --- huffman_decode ----------------------------------------------------------
//
// What the reference computes, as a kernel: a thread walks one chunk's
// min(CHUNK, n - c * CHUNK) codes in order.  At bit p it takes the top 16
// bits of the 32-bit window at p (a funnel shift of two words held in
// registers, with four more loaded ahead), looks up (symbol, length) in the
// row's 2^16-entry peek table and advances p by the length, which may be
// 0, as the reference does.  A word past the row's L reads as zero, as
// the plain version's padding does; nothing outside the buffers is read.
// Each block loads the row's table into shared memory, packed as uint16
// sym | len << 8 (128 KB of dynamic shared memory); a decode that read the
// two uint8 tables through the read-only cache instead was slower on the
// card (PERF.md).
// Bound: bytes (the words, the tables, n written); but each chunk is one
// dependent chain of 4,096 steps (a shift, a table load, an add), and with
// a thread a chunk that chain's latency, not the bytes, sets the time.
//
// --- rle_scan -----------------------------------------------------------------
//
// No run crosses a multiple of RLE_BREAK = 32,768, so a tile of that many
// symbols (a block of 1024 threads, 32 symbols each) holds whole runs:
//   1. rle_count_kernel counts each tile's run starts;
//   2. the row-scan helper gives each tile its first run's slot and the
//      row's run count;
//   3. rle_emit_kernel scans the tile's run starts over the block, puts
//      each run's start and value into shared memory at its slot, then
//      writes the tile's values and lengths (the next start, or the
//      tile's end, less its own), consecutive threads at consecutive slots.
// Only the first nruns slots of a row are written (the plain version's
// later slots are padding that the host trims).  Lengths are at most
// 32,768 and are stored as uint16 bits (int16 storage).  Bound: bytes.
//
// --- rle_expand ---------------------------------------------------------------
//
//   1. rle_len_sums_kernel sums each tile of 4096 run lengths;
//   2. the row-scan helper gives each tile its first run's start;
//   3. rle_cum_kernel writes every run's inclusive end, cum (int64);
//   4. rle_expand_kernel: each output byte at position pos takes
//      values[min(upper_bound(cum, pos), R - 1)], the plain version's
//      searchsorted(cum, pos, right=True).clamp(max=R - 1), zero-length
//      runs and a sum short of n included.  A block of 256 threads covers
//      4096 bytes; two threads search the whole row for the runs at the
//      block's first and last byte, each thread searches that range for
//      its first byte and walks on for its 16.
// Bound: bytes, the runs read once and n written.
//
// Launches: every kernel runs on the caller's stream and allocates
// nothing; the wrapper allocates the outputs and the scratch (the tile
// totals and bases, and rle_expand's cum), declared in
// kernels/bitplane.py WORKSPACE.  Each C entry point returns the first
// non-zero cudaGetLastError() of its launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kChunk = 4096;            // core/lossless.py CHUNK
constexpr int kRleBreak = 32768;        // core/lossless.py RLE_BREAK
constexpr int kLut = 1 << 16;           // 2**MAX_CODE_LEN peek entries
constexpr long long kMaxRows = 65535;   // gridDim.y

constexpr int kScanThreads = 1024;
constexpr int kStatsThreads = 256;
constexpr int kStatsSegs = 4;           // 16-symbol segments a thread
constexpr int kStatsTile = kStatsThreads * 16 * kStatsSegs;
constexpr int kPackThreads = 256;       // 16 symbols a thread: a chunk
constexpr int kTileWords = kChunk * 16 / 32 + 2;
constexpr int kDecThreads = 32;         // a chunk a thread
constexpr int kRleThreads = 1024;       // 32 symbols a thread: a tile
constexpr int kExpThreads = 256;        // 16 runs or bytes a thread
constexpr int kExpTile = kExpThreads * 16;

static_assert(kPackThreads * 16 == kChunk, "a pack block is a chunk");
static_assert(kRleThreads * 32 == kRleBreak, "an RLE block is a tile");

// ------------------------------------------------------------- helpers --

// 16 symbols in four words, symbol k at bits 8 (k % 4) of word k / 4
struct Sym16 {
  uint32_t w[4];
};

__device__ __forceinline__ uint32_t sym_at(const Sym16& v, int k) {
  return (v.w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
}

// the 16 bytes at row positions [q, q + 16); positions outside [0, s)
// read as 0 and are never loaded
__device__ __forceinline__ Sym16 load16(const uint8_t* __restrict__ row,
                                        long long s, long long q) {
  Sym16 v;
  const uint8_t* p = row + q;
  if (q >= 0 && q + 16 <= s
      && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    v.w[0] = u.x;
    v.w[1] = u.y;
    v.w[2] = u.z;
    v.w[3] = u.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t x = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long i = q + 4 * j + k;
        if (i >= 0 && i < s) x |= static_cast<uint32_t>(__ldg(row + i))
                                   << (8 * k);
      }
      v.w[j] = x;
    }
  }
  return v;
}

// the first `cnt` (<= 16) bytes of `v` to dst[0, cnt)
__device__ __forceinline__ void store16(uint8_t* __restrict__ dst,
                                        const Sym16& v, int cnt) {
  if (cnt == 16 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v.w[0], v.w[1], v.w[2],
                                                v.w[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < cnt) dst[k] = static_cast<uint8_t>(sym_at(v, k));
    }
  }
}

__device__ __forceinline__ int seg_count(long long s, long long q) {
  const long long c = s - q;
  return c <= 0 ? 0 : (c >= 16 ? 16 : static_cast<int>(c));
}

// Exclusive prefix sum of `v` over the block (blockDim.x a multiple of 32);
// `total` gets the block's sum.  `scratch`: 32 values of shared memory.
// Two barriers; a caller that uses `scratch` again first passes a third.
template <typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* scratch, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < warps ? scratch[lane] : T(0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    scratch[lane] = w;
  }
  __syncthreads();
  total = scratch[warps - 1];
  return (warp ? scratch[warp - 1] : T(0)) + x - v;
}

// ------------------------------------------------------ the row scan --

// out[i] = in[0] + ... + in[i - 1] over each row of n values; total[row]
// (if given) the row's sum.  One block a row.
__global__ void __launch_bounds__(kScanThreads)
row_scan_kernel(const long long* __restrict__ in, long long* __restrict__ out,
                long long* __restrict__ total, int n) {
  __shared__ long long scratch[32];
  const long long row = blockIdx.y;
  in += row * n;
  out += row * n;
  long long carry = 0;
  for (int base = 0; base < n; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const long long v = i < n ? in[i] : 0;
    long long tile;
    const long long ex = block_exclusive_scan(v, scratch, tile);
    if (i < n) out[i] = carry + ex;
    carry += tile;
    __syncthreads();
  }
  if (total != nullptr && threadIdx.x == 0) total[row] = carry;
}

// ------------------------------------------------------------- stats --

__global__ void __launch_bounds__(kStatsThreads)
stats_kernel(const uint8_t* __restrict__ syms, long long s,
             unsigned long long* __restrict__ hist,
             unsigned long long* __restrict__ nruns) {
  constexpr int kWarps = kStatsThreads / 32;
  __shared__ uint32_t wh[kWarps][256];
  __shared__ uint32_t brk_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * 256; i += kStatsThreads) {
    (&wh[0][0])[i] = 0;
  }
  if (threadIdx.x == 0) brk_total = 0;
  __syncthreads();
  const long long b = blockIdx.y;
  const uint8_t* row = syms + b * s;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kStatsTile;
  uint32_t run_sym = 0, run_len = 0, breaks = 0;
  for (int it = 0; it < kStatsSegs; ++it) {
    const long long q = tile0 + (static_cast<long long>(it) * kStatsThreads
                                 + threadIdx.x) * 16;
    const Sym16 v = load16(row, s, q);
    uint32_t prev = __shfl_up_sync(kFull, sym_at(v, 15), 1);
    if (lane == 0) prev = (q > 0 && q <= s) ? __ldg(row + q - 1) : 256u;
    const int cnt = seg_count(s, q);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < cnt) {
        const uint32_t c = sym_at(v, k);
        breaks += (c != prev)
                  || (k == 0 && (q & (kRleBreak - 1)) == 0);
        if (c == run_sym && run_len != 0) {
          ++run_len;
        } else {
          if (run_len != 0) atomicAdd(&wh[warp][run_sym], run_len);
          run_sym = c;
          run_len = 1;
        }
        prev = c;
      }
    }
  }
  if (run_len != 0) atomicAdd(&wh[warp][run_sym], run_len);
  breaks = __reduce_add_sync(kFull, breaks);
  if (lane == 0 && breaks != 0) atomicAdd(&brk_total, breaks);
  __syncthreads();
  for (int bin = threadIdx.x; bin < 256; bin += kStatsThreads) {
    uint32_t t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += wh[w][bin];
    if (t != 0) atomicAdd(hist + b * 256 + bin,
                          static_cast<unsigned long long>(t));
  }
  if (threadIdx.x == 0 && brk_total != 0) {
    atomicAdd(nruns + b, static_cast<unsigned long long>(brk_total));
  }
}

// ------------------------------------------------------ huffman pack --

__global__ void __launch_bounds__(kPackThreads)
huff_bits_kernel(const uint8_t* __restrict__ syms, long long s,
                 const long long* __restrict__ lens_tab,
                 long long* __restrict__ chunk_bits, int chunks) {
  __shared__ long long len_s[256];
  __shared__ long long scratch[32];
  const long long b = blockIdx.y;
  len_s[threadIdx.x] = lens_tab[b * 256 + threadIdx.x];
  __syncthreads();
  const long long q = static_cast<long long>(blockIdx.x) * kChunk
                      + threadIdx.x * 16;
  const Sym16 v = load16(syms + b * s, s, q);
  const int cnt = seg_count(s, q);
  long long bits = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k < cnt) bits += len_s[sym_at(v, k)];
  }
  long long total;
  block_exclusive_scan(bits, scratch, total);
  if (threadIdx.x == 0) chunk_bits[b * chunks + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kPackThreads)
huff_pack_kernel(const uint8_t* __restrict__ syms, long long s,
                 const long long* __restrict__ lens_tab,
                 const long long* __restrict__ codes_tab,
                 const long long* __restrict__ chunk_offs, int chunks,
                 uint32_t* __restrict__ words, long long cap) {
  __shared__ uint32_t tile[kTileWords];
  __shared__ long long len_s[256];
  __shared__ uint32_t code_s[256];
  __shared__ long long scratch[32];
  const long long b = blockIdx.y;
  len_s[threadIdx.x] = lens_tab[b * 256 + threadIdx.x];
  code_s[threadIdx.x] = static_cast<uint32_t>(codes_tab[b * 256
                                                        + threadIdx.x]);
  for (int i = threadIdx.x; i < kTileWords; i += kPackThreads) tile[i] = 0;
  __syncthreads();
  const long long q = static_cast<long long>(blockIdx.x) * kChunk
                      + threadIdx.x * 16;
  const Sym16 v = load16(syms + b * s, s, q);
  const int cnt = seg_count(s, q);
  long long bits = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k < cnt) bits += len_s[sym_at(v, k)];
  }
  long long total;
  const long long ex = block_exclusive_scan(bits, scratch, total);
  const long long o = chunk_offs[b * chunks + blockIdx.x];
  const long long f = o >> 5;
  long long pos = o + ex;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k < cnt) {
      const uint32_t c = sym_at(v, k);
      const long long len = len_s[c];
      // a length of 0 places no bit; one above 32 is no codebook's (the
      // plain version's shifts are undefined there) and places none
      if (len > 0 && len <= 32) {
        const uint32_t msb = code_s[c] << (32 - len);
        const uint32_t sh = static_cast<uint32_t>(pos) & 31u;
        const long long t = (pos >> 5) - f;
        if (t >= 0 && t < kTileWords) atomicOr(&tile[t], msb >> sh);
        if (sh != 0 && t + 1 >= 0 && t + 1 < kTileWords) {
          const uint32_t spill = msb << (32 - sh);
          if (spill != 0) atomicOr(&tile[t + 1], spill);
        }
      }
      pos += len;
    }
  }
  __syncthreads();
  if (total <= 0) return;
  const long long nw = ((o + total - 1) >> 5) - f + 1;
  uint32_t* row = words + b * cap;
  for (long long t = threadIdx.x; t < nw && t < kTileWords;
       t += kPackThreads) {
    const long long w = f + t;
    if (w < 0 || w >= cap) continue;
    const uint32_t x = tile[t];
    if (t == 0 || t == nw - 1) {
      if (x != 0) atomicOr(row + w, x);
    } else {
      row[w] = x;
    }
  }
}

// ---------------------------------------------------- huffman decode --

// A chunk's walk: the 32-bit window at the position is w0:w1 shifted left
// by `sh` (< 32), and w2 .. w5 are the next words, loaded ahead.  The
// chain from one code to the next is a funnel shift, a table load, an add
// to `sh` and a compare; a step past w0 moves the words down and loads
// one more, off the chain.
struct Walker {
  const uint32_t* w;
  long long n_words;
  long long i;                  // w0's word
  uint32_t sh;                  // the position's bit in w0
  uint32_t w0, w1, w2, w3, w4, w5;   // words i .. i + 5

  __device__ __forceinline__ uint32_t ld(long long k) const {
    return k < n_words ? __ldg(w + k) : 0u;
  }

  __device__ __forceinline__ void seek(long long bit) {
    i = bit >> 5;
    sh = static_cast<uint32_t>(bit) & 31u;
    w0 = ld(i);
    w1 = ld(i + 1);
    w2 = ld(i + 2);
    w3 = ld(i + 3);
    w4 = ld(i + 4);
    w5 = ld(i + 5);
  }

  // the symbol at the position, which advances by its code's length;
  // `lut`: the packed table in shared memory
  __device__ __forceinline__ uint32_t next(const uint16_t* lut) {
    const uint32_t peek = __funnelshift_l(w1, w0, sh) >> 16;
    const uint32_t e = lut[peek];
    sh += e >> 8;
    if (sh >= 32) {
      if (sh < 64) {            // one word on: a code is at most 16 bits
        sh -= 32;
        ++i;
        w0 = w1;
        w1 = w2;
        w2 = w3;
        w3 = w4;
        w4 = w5;
        w5 = ld(i + 5);
      } else {                  // a table's length past 32 (no codebook's)
        seek(32 * i + sh);
      }
    }
    return e & 0xFFu;
  }
};

__global__ void __launch_bounds__(kDecThreads)
huff_decode_kernel(const uint32_t* __restrict__ words, long long n_words,
                   const long long* __restrict__ chunk_offs, int chunks,
                   const uint8_t* __restrict__ lut_sym,
                   const uint8_t* __restrict__ lut_len,
                   uint8_t* __restrict__ out, long long n) {
  extern __shared__ uint32_t lut_s[];   // kLut / 2 words
  const long long b = blockIdx.y;
  const uint8_t* ls = lut_sym + b * kLut;
  const uint8_t* ll = lut_len + b * kLut;
#pragma unroll 4
  for (int e = threadIdx.x * 16; e < kLut; e += blockDim.x * 16) {
    const Sym16 sv = load16(ls, kLut, e);
    const Sym16 lv = load16(ll, kLut, e);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      lut_s[(e >> 1) + k] =
          (sym_at(sv, 2 * k) | sym_at(lv, 2 * k) << 8)
          | (sym_at(sv, 2 * k + 1) | sym_at(lv, 2 * k + 1) << 8) << 16;
    }
  }
  __syncthreads();
  const long long c = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const long long first = c * kChunk;
  if (c >= chunks || first >= n) return;
  const int count = static_cast<int>(n - first < kChunk ? n - first
                                                         : kChunk);
  const uint16_t* lut = reinterpret_cast<const uint16_t*>(lut_s);
  Walker wk;
  wk.w = words + b * n_words;
  wk.n_words = n_words;
  wk.seek(static_cast<long long>(
      static_cast<uint32_t>(chunk_offs[b * chunks + c])));
  uint8_t* dst = out + b * n + first;
  int k = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (; k + 16 <= count; k += 16) {
      Sym16 v;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t x = wk.next(lut);
        x |= wk.next(lut) << 8;
        x |= wk.next(lut) << 16;
        x |= wk.next(lut) << 24;
        v.w[j] = x;
      }
      store16(dst + k, v, 16);
    }
  }
  for (; k < count; ++k) dst[k] = static_cast<uint8_t>(wk.next(lut));
}

// ----------------------------------------------------------- rle scan --

// bit k set where position q + k (< s) starts a run; a, c: the 32 symbols
__device__ __forceinline__ uint32_t run_starts(const uint8_t* __restrict__ row,
                                               long long s, long long q,
                                               Sym16& a, Sym16& c) {
  a = load16(row, s, q);
  c = load16(row, s, q + 16);
  uint32_t prev = __shfl_up_sync(kFull, sym_at(c, 15), 1);
  if ((threadIdx.x & 31) == 0) {
    prev = (q > 0 && q <= s) ? __ldg(row + q - 1) : 256u;
  }
  uint32_t mask = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const uint32_t x = k < 16 ? sym_at(a, k) : sym_at(c, k - 16);
    if (q + k < s && (x != prev
                      || (k == 0 && (q & (kRleBreak - 1)) == 0))) {
      mask |= 1u << k;
    }
    prev = x;
  }
  return mask;
}

__global__ void __launch_bounds__(kRleThreads)
rle_count_kernel(const uint8_t* __restrict__ syms, long long s,
                 long long* __restrict__ tile_runs, int tiles) {
  __shared__ int scratch[32];
  const long long b = blockIdx.y;
  const long long q = static_cast<long long>(blockIdx.x) * kRleBreak
                      + threadIdx.x * 32;
  Sym16 a, c;
  const uint32_t mask = run_starts(syms + b * s, s, q, a, c);
  int total;
  block_exclusive_scan(static_cast<int>(__popc(mask)), scratch, total);
  if (threadIdx.x == 0) tile_runs[b * tiles + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kRleThreads)
rle_emit_kernel(const uint8_t* __restrict__ syms, long long s,
                const long long* __restrict__ tile_base, int tiles,
                uint8_t* __restrict__ values,
                uint16_t* __restrict__ lengths) {
  // each run's start (kRleBreak uint16), then its value (kRleBreak bytes)
  extern __shared__ uint16_t starts[];
  uint8_t* vals_s = reinterpret_cast<uint8_t*>(starts + kRleBreak);
  __shared__ int scratch[32];
  const long long b = blockIdx.y;
  const long long t0 = static_cast<long long>(blockIdx.x) * kRleBreak;
  const long long q = t0 + threadIdx.x * 32;
  Sym16 a, c;
  const uint32_t mask = run_starts(syms + b * s, s, q, a, c);
  int total;
  int r = block_exclusive_scan(static_cast<int>(__popc(mask)), scratch,
                               total);
  const long long base = tile_base[b * tiles + blockIdx.x];
  uint8_t* vals = values + b * s + base;
  uint16_t* lens = lengths + b * s + base;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if (mask & (1u << k)) {
      starts[r] = static_cast<uint16_t>(threadIdx.x * 32 + k);
      vals_s[r] = static_cast<uint8_t>(k < 16 ? sym_at(a, k)
                                              : sym_at(c, k - 16));
      ++r;
    }
  }
  __syncthreads();
  const int tile_len = static_cast<int>(s - t0 < kRleBreak ? s - t0
                                                           : kRleBreak);
  for (int j = threadIdx.x; j < total; j += kRleThreads) {
    const int end = j + 1 < total ? starts[j + 1] : tile_len;
    vals[j] = vals_s[j];
    lens[j] = static_cast<uint16_t>(end - starts[j]);
  }
}

// --------------------------------------------------------- rle expand --

// the 16 lengths (as int64) at run indices [j, j + 16) of a row of r
__device__ __forceinline__ void load_lengths(const int32_t* __restrict__ row,
                                             long long r, long long j,
                                             long long (&x)[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    x[k] = j + k < r ? static_cast<long long>(__ldg(row + j + k)) : 0;
  }
}

__global__ void __launch_bounds__(kExpThreads)
rle_len_sums_kernel(const int32_t* __restrict__ lengths, long long r,
                    long long* __restrict__ tile_sums, int tiles) {
  __shared__ long long scratch[32];
  const long long b = blockIdx.y;
  const long long j = static_cast<long long>(blockIdx.x) * kExpTile
                      + threadIdx.x * 16;
  long long x[16];
  load_lengths(lengths + b * r, r, j, x);
  long long sum = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) sum += x[k];
  long long total;
  block_exclusive_scan(sum, scratch, total);
  if (threadIdx.x == 0) tile_sums[b * tiles + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kExpThreads)
rle_cum_kernel(const int32_t* __restrict__ lengths, long long r,
               const long long* __restrict__ tile_base, int tiles,
               long long* __restrict__ cum) {
  __shared__ long long scratch[32];
  const long long b = blockIdx.y;
  const long long j = static_cast<long long>(blockIdx.x) * kExpTile
                      + threadIdx.x * 16;
  long long x[16];
  load_lengths(lengths + b * r, r, j, x);
  long long sum = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) sum += x[k];
  long long total;
  long long run = tile_base[b * tiles + blockIdx.x]
                  + block_exclusive_scan(sum, scratch, total);
  long long* row = cum + b * r;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    run += x[k];
    if (j + k < r) row[j + k] = run;
  }
}

// the first index j in [lo, hi) with cum[j] > x, or hi
__device__ __forceinline__ long long first_above(const long long* cum,
                                                 long long lo, long long hi,
                                                 long long x) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (cum[mid] > x) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kExpThreads)
rle_expand_kernel(const uint8_t* __restrict__ values,
                  const long long* __restrict__ cum, long long r,
                  uint8_t* __restrict__ out, long long n) {
  __shared__ long long bounds[2];
  const long long b = blockIdx.y;
  const long long* cr = cum + b * r;
  const long long p0 = static_cast<long long>(blockIdx.x) * kExpTile;
  const long long p1 = (p0 + kExpTile < n ? p0 + kExpTile : n) - 1;
  if (threadIdx.x < 2) {
    bounds[threadIdx.x] = first_above(cr, 0, r, threadIdx.x ? p1 : p0);
  }
  __syncthreads();
  const long long q = p0 + threadIdx.x * 16;
  const int cnt = seg_count(n, q);
  if (cnt == 0) return;
  const long long hi = bounds[1];
  long long j = first_above(cr, bounds[0], hi, q);
  const uint8_t* vrow = values + b * r;
  Sym16 v;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t x = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = 4 * w + m;
      if (k < cnt) {
        while (j < hi && cr[j] <= q + k) ++j;
        x |= static_cast<uint32_t>(__ldg(vrow + (j < r - 1 ? j : r - 1)))
             << (8 * m);
      }
    }
    v.w[w] = x;
  }
  store16(out + b * n + q, v, cnt);
}

// ------------------------------------------------------------ launches --

constexpr int kMaxDevices = 64;

// the first non-zero of `err` and cudaGetLastError()
inline int first_error(int err) {
  const int e = static_cast<int>(cudaGetLastError());
  return err != 0 ? err : e;
}

inline int keep(int err, int e) { return err != 0 ? err : e; }

inline unsigned blocks_for(long long n, long long per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

inline int row_scan(const long long* in, long long* out, long long* total,
                    long long rows, int n, cudaStream_t st) {
  int err = 0;
  for (long long r0 = 0; r0 < rows; r0 += kMaxRows) {
    const long long nr = rows - r0 < kMaxRows ? rows - r0 : kMaxRows;
    row_scan_kernel<<<dim3(1, static_cast<unsigned>(nr)), kScanThreads, 0,
                      st>>>(in + r0 * n, out + r0 * n,
                            total ? total + r0 : nullptr, n);
    err = first_error(err);
  }
  return err;
}

// let `kernel` take `bytes` of dynamic shared memory on the current device
// (an attribute of each device: set once a device, `ready` its flags)
template <typename K>
int allow_smem(K kernel, int bytes, bool* ready) {
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0) return err;
  if (dev >= 0 && dev < kMaxDevices && ready[dev]) return 0;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (err == 0 && dev >= 0 && dev < kMaxDevices) ready[dev] = true;
  return err;
}

}  // namespace

extern "C" {

// hist: (rows, 256) int64 and nruns: (rows,) int64, both zeroed by the
// caller
int lossless_stats(const void* syms, long long rows, long long s, void* hist,
                   void* nruns, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  for (long long r0 = 0; r0 < rows; r0 += kMaxRows) {
    const long long nr = rows - r0 < kMaxRows ? rows - r0 : kMaxRows;
    stats_kernel<<<dim3(blocks_for(s, kStatsTile), static_cast<unsigned>(nr)),
                   kStatsThreads, 0, st>>>(
        static_cast<const uint8_t*>(syms) + r0 * s, s,
        static_cast<unsigned long long*>(hist) + r0 * 256,
        static_cast<unsigned long long*>(nruns) + r0);
    err = first_error(err);
  }
  return err;
}

// chunk_bits: (rows, chunks) scratch; chunk_offs: (rows, chunks);
// total_bits: (rows,); words: (rows, cap), zeroed by the caller
int huffman_pack(const void* syms, long long rows, long long s,
                 const void* lens_tab, const void* codes_tab,
                 void* chunk_bits, void* chunk_offs, void* total_bits,
                 void* words, long long cap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = static_cast<int>(blocks_for(s, kChunk));
  const uint8_t* sy = static_cast<const uint8_t*>(syms);
  const long long* lt = static_cast<const long long*>(lens_tab);
  const long long* ct = static_cast<const long long*>(codes_tab);
  long long* bits = static_cast<long long*>(chunk_bits);
  long long* offs = static_cast<long long*>(chunk_offs);
  int err = 0;
  for (long long r0 = 0; r0 < rows; r0 += kMaxRows) {
    const long long nr = rows - r0 < kMaxRows ? rows - r0 : kMaxRows;
    huff_bits_kernel<<<dim3(chunks, static_cast<unsigned>(nr)), kPackThreads,
                       0, st>>>(sy + r0 * s, s, lt + r0 * 256,
                                bits + r0 * chunks, chunks);
    err = first_error(err);
  }
  err = keep(err, row_scan(bits, offs, static_cast<long long*>(total_bits),
                           rows, chunks, st));
  for (long long r0 = 0; r0 < rows; r0 += kMaxRows) {
    const long long nr = rows - r0 < kMaxRows ? rows - r0 : kMaxRows;
    huff_pack_kernel<<<dim3(chunks, static_cast<unsigned>(nr)), kPackThreads,
                       0, st>>>(sy + r0 * s, s, lt + r0 * 256, ct + r0 * 256,
                                offs + r0 * chunks, chunks,
                                static_cast<uint32_t*>(words) + r0 * cap,
                                cap);
    err = first_error(err);
  }
  return err;
}

// words: (rows, n_words) uint32 bits; chunk_offs: (rows, chunks) int64;
// lut_sym, lut_len: (rows, 65536) uint8; out: (rows, n) uint8
int huffman_decode(const void* words, long long rows, long long n_words,
                   const void* chunk_offs, int chunks, const void* lut_sym,
                   const void* lut_len, void* out, long long n,
                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long used = blocks_for(n, kChunk);
  const unsigned grid_x = blocks_for(used < chunks ? used : chunks,
                                     kDecThreads);
  const int smem = kLut * 2;
  static bool ready[kMaxDevices] = {};
  int err = allow_smem(huff_decode_kernel, smem, ready);
  if (err != 0) return err;
  for (long long r0 = 0; r0 < rows; r0 += kMaxRows) {
    const long long nr = rows - r0 < kMaxRows ? rows - r0 : kMaxRows;
    const dim3 grid(grid_x, static_cast<unsigned>(nr));
    const uint32_t* w = static_cast<const uint32_t*>(words) + r0 * n_words;
    const long long* o = static_cast<const long long*>(chunk_offs)
                         + r0 * chunks;
    const uint8_t* ls = static_cast<const uint8_t*>(lut_sym) + r0 * kLut;
    const uint8_t* ll = static_cast<const uint8_t*>(lut_len) + r0 * kLut;
    uint8_t* dst = static_cast<uint8_t*>(out) + r0 * n;
    huff_decode_kernel<<<grid, kDecThreads, smem, st>>>(
        w, n_words, o, chunks, ls, ll, dst, n);
    err = first_error(err);
  }
  return err;
}

// tile_runs, tile_base: (rows, tiles) scratch; values: (rows, s) uint8;
// lengths: (rows, s) uint16 bits; nruns: (rows,) int64
int rle_scan(const void* syms, long long rows, long long s, void* tile_runs,
             void* tile_base, void* values, void* lengths, void* nruns,
             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = static_cast<int>(blocks_for(s, kRleBreak));
  const int smem = kRleBreak * 3;
  static bool ready[kMaxDevices] = {};
  int err = allow_smem(rle_emit_kernel, smem, ready);
  if (err != 0) return err;
  const uint8_t* sy = static_cast<const uint8_t*>(syms);
  long long* runs = static_cast<long long*>(tile_runs);
  long long* base = static_cast<long long*>(tile_base);
  for (long long r0 = 0; r0 < rows; r0 += kMaxRows) {
    const long long nr = rows - r0 < kMaxRows ? rows - r0 : kMaxRows;
    rle_count_kernel<<<dim3(tiles, static_cast<unsigned>(nr)), kRleThreads,
                       0, st>>>(sy + r0 * s, s, runs + r0 * tiles, tiles);
    err = first_error(err);
  }
  err = keep(err, row_scan(runs, base, static_cast<long long*>(nruns),
                           rows, tiles, st));
  for (long long r0 = 0; r0 < rows; r0 += kMaxRows) {
    const long long nr = rows - r0 < kMaxRows ? rows - r0 : kMaxRows;
    rle_emit_kernel<<<dim3(tiles, static_cast<unsigned>(nr)), kRleThreads,
                      smem, st>>>(sy + r0 * s, s, base + r0 * tiles, tiles,
                                  static_cast<uint8_t*>(values) + r0 * s,
                                  static_cast<uint16_t*>(lengths) + r0 * s);
    err = first_error(err);
  }
  return err;
}

// values: (rows, r) uint8; lengths: (rows, r) int32; tile_sums, tile_base:
// (rows, ceil(r / 4096)) scratch; cum: (rows, r) scratch; out: (rows, n)
int rle_expand(const void* values, const void* lengths, long long rows,
               long long r, void* tile_sums, void* tile_base, void* cum,
               void* out, long long n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = static_cast<int>(blocks_for(r, kExpTile));
  const int32_t* ln = static_cast<const int32_t*>(lengths);
  long long* sums = static_cast<long long*>(tile_sums);
  long long* base = static_cast<long long*>(tile_base);
  long long* cm = static_cast<long long*>(cum);
  int err = 0;
  for (long long r0 = 0; r0 < rows; r0 += kMaxRows) {
    const long long nr = rows - r0 < kMaxRows ? rows - r0 : kMaxRows;
    rle_len_sums_kernel<<<dim3(tiles, static_cast<unsigned>(nr)),
                          kExpThreads, 0, st>>>(ln + r0 * r, r,
                                                sums + r0 * tiles, tiles);
    err = first_error(err);
  }
  err = keep(err, row_scan(sums, base, nullptr, rows, tiles, st));
  for (long long r0 = 0; r0 < rows; r0 += kMaxRows) {
    const long long nr = rows - r0 < kMaxRows ? rows - r0 : kMaxRows;
    const unsigned y = static_cast<unsigned>(nr);
    rle_cum_kernel<<<dim3(tiles, y), kExpThreads, 0, st>>>(
        ln + r0 * r, r, base + r0 * tiles, tiles, cm + r0 * r);
    err = first_error(err);
    rle_expand_kernel<<<dim3(blocks_for(n, kExpTile), y), kExpThreads, 0,
                        st>>>(static_cast<const uint8_t*>(values) + r0 * r,
                              cm + r0 * r, r,
                              static_cast<uint8_t*>(out) + r0 * n, n);
    err = first_error(err);
  }
  return err;
}

}  // extern "C"
