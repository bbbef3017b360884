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
// entry points split larger buckets); huffman_pack's, rle_scan's and
// rle_expand's blocks take tickets over all rows instead.  A row need not start 16-byte
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
// --- lossless_stats --------------------------------------------------------
//
// One pass, a block of 256 threads a tile.  The tile (stats_tile) is
// 16,384 symbols, halved down to 4,096 while a launch would have fewer
// than kStatsBlocks (two an SM) blocks, so that a bucket of short rows
// still fills the card.  A thread issues all of its 16-byte loads (one to
// four) before it counts.  Counting is bound by instructions a symbol
// (PERF.md), so a thread takes its symbols a 4-byte word at a time
// (count_word): run starts by a byte-parallel compare with the word
// shifted by a byte, and a word of one symbol added at once to a run kept
// in registers (bitplane groups are run-heavy, and an all-zero plane would
// otherwise serialize every warp on bin 0); the bytes of any other word go
// by shared atomics, with no branch, into the warp's 256 bins.  A run
// break is `_rle_scan`'s: the neighbour differs, or idx % RLE_BREAK == 0;
// a thread's first symbol takes its left neighbour from the lane before
// (lane 0 reads it).  The tiles of a row go in thread block clusters of
// up to 8 (stats_cluster): each block adds its 257 totals into the
// cluster leader's in distributed shared memory (the leader's zeroed
// before, behind the first half of a split cluster barrier).  A row of one
// cluster is stored from there, with no global atomic and no zeroing; a
// row of more adds each cluster's totals into the row's zeroed sums with
// one 64-bit atomic a bin, and the last cluster to arrive (a counter
// beside the sums) copies them out.  One launch a call, and one memset of
// the sums where a row has more than one cluster.  Bound: bytes, the row
// read once.
//
// --- huffman_pack -----------------------------------------------------------
//
// One pass with a decoupled look-back, plus the zeroing of its status
// words (two launches a call).  A block of 256 threads takes a ticket for
// a group of consecutive chunks (CHUNK = 4096 symbols) of one row, in
// order: one chunk, or (pack_group) two or four where the launch would
// otherwise hold more tickets than the card holds blocks at once, so that
// the blocks start together and each look-back finds its predecessors'
// words already published.  It reads its symbols once, 16 a thread and
// chunk in one 16-byte load, each symbol's code and length from a table of
// one word a symbol (code_entry: codes of at most MAX_CODE_LEN = 16 bits,
// a codebook's).  It scans each chunk's code lengths over the block and
// publishes the group's bits (flag and sum in one 64-bit status word a
// ticket, as rle_expand does; the row's first ticket, whose prefix is 0,
// an inclusive sum at once).  While its predecessors publish theirs, each
// thread turns its 16 codes a chunk into words in registers, counted from
// the group's first bit (pack_codes: a code of at most 16 bits fills at
// most one word, a shift and a funnel shift a code), and ORs them into a
// zeroed shared tile of the group's words (neighbouring threads may share
// a word).  It then looks back to the group's first bit o: chunk_offs, and
// for the row's last group o + its bits, total_bits; the tile's words
// leave shifted to bit o by one funnel shift a word.  Word ownership: a
// group stores the words [o / 32, o' / 32), o' its successor's first bit
// (the row's last group on to its last partial word), so every stream
// word is stored once, by the group whose bits start in it or fill it.
// That word's bits before o belong to earlier groups: warp 0 rebuilds them
// from the symbols before the group (32 at a time, read back until their
// codes cover the word's head, fewer than 32 bits).  The words leave by
// 16-byte stores.  The cap's words past the stream are zero: with codes
// of at most 16 bits, no stream word lies at or past T = ceil((o + the
// group's bits + 16 * the row's symbols after the group) / 32), and T
// falls group by group to the stream's end, so a group stores zeros in
// [its T, the T of the group before) (the row's first group: to the cap)
// without waiting on any later ticket.  Bound: bytes, the symbols read
// once and the stored words (the stream's) written once; a byte-identical
// output also writes the cap's zero words, the floor (B, S * 16 / 32 + 2)
// words.
//
// --- huffman_decode ----------------------------------------------------------
//
// What the reference computes: chunk c's min(CHUNK, n - c * CHUNK) codes
// walked in order from bit off[c].  At bit p the top 16 bits of the 32-bit
// window at p peek the row's 2^16-entry table for (symbol, length), and p
// advances by the length, which may be 0, as the reference's does.  A word
// past the row's L reads as zero, as the plain version's padding does;
// nothing outside the buffers is read.  Two launches a call:
//   1. huff_primary_kernel builds each row's primary table: entry q of
//      2^kPrimBits is the peek table's (sym | len << 8) for the 32 peeks
//      q << 5 .. that it covers, where all 32 agree and len <= kPrimBits
//      (`_build_decode_lut` fills every peek under a code that short alike),
//      else kLong: such a peek (a longer code) is read from the row's full
//      tables through the read-only cache.  4 KB a row, not 128 KB.
//   2. huff_decode_kernel: a block of M lanes (32 to 256, decode_lanes: 256
//      while a launch has at most ~4,200 chunks) a chunk.  One bulk copy
//      (cp.async.bulk on an mbarrier) stages the chunk's words and the
//      primary table in shared memory, so no walk waits on a global load.
//      The chunk's bits [off[c], E) are split into M spans: E is off[c + 1]
//      (the chunks are packed back to back), for the row's last chunk off +
//      16 * count, capped at the row's words.  The staged words' zero tail
//      (a row's padding, where every code is the table's entry 0) goes to
//      the last lane, which counts its codes there rather than walking
//      them; a span is kLaneBits at least (a shorter one could hold no
//      whole code, and each round would right one lane only), so a short
//      chunk keeps its first lanes idle at its start; span starts are
//      multiples of a codebook's one code length where it has one (8-bit
//      codes of noise planes), so that the first walk is already in step.
//      Lane j walks from its span's start until it passes the span's end,
//      counting codes; lane j + 1 restarts where lane j stopped; until no
//      lane's start moves (lane 0 starts on a true boundary, so by
//      induction every start then is one).  A lane that meets a zero length
//      advances one bit, so that its walk ends.  A chunk still moving at
//      round kTableRound (a codebook of nearly one length, 7, 8 and 9 bits,
//      falls into step seldom, and would take a round a lane) takes entry
//      tables instead: each lane walks its span from every entry a true
//      start can have (its nominal start plus 0 .. the longest code - 1),
//      one lane chains the exits from the chunk's start, and each lane
//      walks once more from its own.  An exclusive scan of the
//      counts gives each lane its first symbol's slot, and a second walk
//      writes the symbols into a 4 KB shared tile, stored with 16-byte
//      stores.  The result is kept only where it must equal the serial
//      walk: no zero length on the synchronised path, the counts summing
//      to the chunk's count and the last code ending at off[c + 1] (the
//      last chunk: at least count codes).  Any other chunk (a corrupt or
//      hand-made stream, an offset past 2^16 bits on) is walked serially
//      by one lane through global loads, as the reference walks it.
//   `walks` (4 uint64, the wrapper's per-device record) gets each chunk,
//   each serially walked chunk, the synchronisation rounds (walks after
//   the first) and their most in one chunk.
// Bound: bytes (the words, the tables, n written).  A chunk's codes are
// M chains of about 4,096 / M dependent look-ups, walked twice, once more
// a round, and at most kTableRound - 1 + the longest code + 2 times.
//
// --- rle_scan -----------------------------------------------------------------
//
// No run crosses a multiple of RLE_BREAK = 32,768, so a tile of that many
// symbols holds whole runs, and the only dependency across tiles is each
// tile's first output slot.  One pass with a decoupled look-back, plus the
// zeroing of its status words (two launches a call).  A block takes a
// ticket for a tile, in order over (row, tile), so that its predecessors
// have all started: a block of 512 threads, two an SM, where every tile of
// the call fits on the card so (the card's SM count read at the call),
// else of 256, four an SM, so that a call of many tiles still has them
// all resident and a call of few has more warps a tile.  It reads the
// tile's symbols once, 16-byte loads (segment g = j * threads + thread of
// 16 symbols, j < 4 or 8), keeps them in registers and copies them to a
// shared tile.  It
// forms each segment's run starts byte-parallel (the neighbour differs, or
// the tile's first symbol: a multiple of RLE_BREAK) into a 16-bit mask
// kept in shared memory, and sums them over each warp's 512-symbol piece
// (piece j * warps + warp) into the piece's count and last start; one warp
// scans the 64 pieces in order to each piece's first slot and the start
// before it.  The block publishes the tile's count (flag and sum in one
// 64-bit status word a tile, as the pack's) and looks back to its first
// slot in the row (look_back).  Then each warp walks its pieces 32
// symbols a step (two segments' masks): lane k first scans step k's
// starts over the piece's 16 steps, to each step's first slot and the
// last start before it, so that no step waits on another; in each step
// the starting lanes rank among the step's starts and write their values
// at consecutive slots and the lengths of the runs before them (a start
// less the start before it); the tile's last start writes its own (the
// tile's end less it).  A piece with no start is skipped.  The row's last
// tile writes nruns.  Only the first nruns slots of a row are written (the
// plain version's later slots are padding that the host trims).  Lengths
// are at most 32,768 and are stored as uint16 bits (int16 storage).
// Bound: bytes, the symbols read once and this data's runs (3 bytes each)
// written once.  Every tile of a call is resident at once up to 528 tiles
// (334 at Isabel's group), so the reads, the look-backs and the writes of
// all tiles run in step and do not overlap (PERF.md).
//
// --- rle_expand ---------------------------------------------------------------
//
// One pass with a decoupled look-back, plus the zeroing of its status
// words (two launches a call).  Tiles of 4096 runs; a block takes a
// ticket from an atomic counter (so a ticket's predecessors have all
// started, and tiles of a row are scanned in order), stages its tile's
// int32 lengths and uint8 values in shared memory with a bulk copy on an
// mbarrier, turns them so that a thread reads its own 16 runs without
// bank conflicts, scans the lengths, publishes its tile's sum (flag and
// sum in one 64-bit status word a tile), and sums its predecessors' words
// back to the nearest inclusive one (look_back, 1,024 words a step): the
// tile's first byte.  It then writes its bytes [prefix, prefix + sum) of
// [0, n) (the row's last tile on to n):
//   - few bytes (a tile's whole range fits in shared memory): each thread
//     spells out its own runs there, aligned as the output, and the block
//     stores whole 16-byte granules;
//   - many bytes (long runs, the row's tail past its total, a slice's
//     share): each thread takes 16-byte granules, finds the run of a
//     granule's first byte in the tile's ends (a cursor, then a binary
//     search; upper bound, so zero-length runs are skipped as
//     searchsorted(right=True) skips them), fills a granule one run covers
//     at once and walks the others byte by byte.
// Bytes past the row's total take values[r - 1] (the plain version's
// clamp); a row whose lengths sum past n is cut at n.  Where a row's tiles
// average many bytes, `slices` blocks share each tile: each stages and
// scans it, the first publishes and looks back, the others wait for its
// inclusive word and write their share.  Bound: bytes, the runs read once
// and n written.  A block of many bytes writes them at a few GB/s
// (PERF.md), so a row whose bytes sit in a few tiles waits on those.
//
// Launches: every kernel runs on the caller's stream and allocates
// nothing; the wrapper allocates the outputs and the scratch (the stats'
// cluster partials and counters, the decode's primary tables, the pack's,
// rle_scan's and rle_expand's status words),
// declared in kernels/bitplane.py WORKSPACE.  Each C entry point returns
// the first non-zero error of its launches.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kChunk = 4096;            // core/lossless.py CHUNK
constexpr int kRleBreak = 32768;        // core/lossless.py RLE_BREAK
constexpr int kLut = 1 << 16;           // 2**MAX_CODE_LEN peek entries
constexpr long long kMaxRows = 65535;   // gridDim.y

constexpr int kStatsThreads = 256;
constexpr int kStatsMaxSegs = 4;        // 16-symbol segments a thread, at most
constexpr int kStatsMaxTile = kStatsThreads * 16 * kStatsMaxSegs;
constexpr int kStatsMinTile = kStatsThreads * 16;
constexpr long long kStatsBlocks = 264; // a launch's blocks, at least: 2 an SM
constexpr int kStatsMinBlocks = 6;      // stats blocks an SM, at least
constexpr int kMaxCluster = 8;          // a stats cluster's blocks, at most
constexpr int kPackThreads = 256;       // 16 symbols a thread: a chunk
constexpr int kPackMinBlocks = 6;       // pack blocks an SM, at least
constexpr int kPackGroup = 4;           // chunks a pack ticket, at most
constexpr long long kPackBlocks = 132 * kPackMinBlocks;  // the card's, at once
// a ticket's words from its first bit: at most 2,048 a chunk, and one
constexpr int kPackWords = kPackGroup * kChunk * 16 / 32 + 8;
constexpr int kRlePiece = 512;          // a warp's symbols a segment row
constexpr int kRlePieces = kRleBreak / kRlePiece;
constexpr int kRleSteps = kRlePiece / 32;   // a piece's 32-symbol steps
constexpr int kRleWide = 512;           // an RLE block's threads on few tiles
constexpr int kRleNarrow = 256;         // on many
constexpr int kPrimBits = 11;           // the decode's primary table
constexpr int kPrim = 1 << kPrimBits;
constexpr int kPrimSub = 16 - kPrimBits;   // 32 peeks a primary entry
constexpr uint32_t kLong = 0xFFFFu;     // a primary entry: read the full table
constexpr int kMaxLanes = 256;          // a decode block's lanes, at most
constexpr int kStageWords = kChunk * 16 / 32 + 4;   // a chunk's words, staged
constexpr long long kChunkBits = kChunk * 16LL;     // a chunk's bits, at most
constexpr int kLaneTarget = 8192;       // decode threads an SM, at least
constexpr int kLaneBits = 64;           // a decode lane's span, at least
constexpr int kTableRound = 4;          // a decode's entry tables from here
constexpr int kExpThreads = 256;        // 16 runs or bytes a thread
constexpr int kExpTile = kExpThreads * 16;
constexpr int kLookThreads = 256;       // a look-back's block
constexpr int kLookWidth = 4;           // words a look-back thread reads
constexpr long long kSliceBytes = 16384;   // an expand block's bytes, about
constexpr int kMaxSlices = 256;
// an expand tile's status word: the flag in the top two bits, a sum in
// the other 62
constexpr unsigned long long kAgg = 1ull << 62, kInc = 2ull << 62;
constexpr unsigned long long kValBits = (1ull << 62) - 1;

static_assert(kPackThreads * 16 == kChunk, "a pack block is a chunk");
static_assert(kPackThreads == kLookThreads && kExpThreads == kLookThreads,
              "the look-backs' blocks");
static_assert(kRlePieces == 64 && kRleSteps <= 32
              && kRleBreak % (kRleWide * 16) == 0
              && kRleBreak % (kRleNarrow * 16) == 0, "an RLE block is a tile");
static_assert(kPrim % 256 == 0, "a primary block is 256 entries");
static_assert(16 * kMaxLanes <= kChunk, "a decode's entry exits fit its tile");

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

// ------------------------------------------------- staging, mbarriers --

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(1u) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of the barrier's phase, expecting `bytes` of bulk copies.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits for the barrier's first phase; a wait of ~8 s (2^34 cycles) traps,
// so that a fault ends the launch with an error rather than holding the
// card.
__device__ __forceinline__ void mbar_wait0(uint64_t* bar) {
  const long long t0 = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(0u) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// `bytes` bytes of global memory at `src` staged at dst + lead in shared
// memory (dst 16-byte aligned, lead + bytes of room): lead = src % 16, so
// that the two are 16-byte aligned alike; the aligned body goes by one bulk
// copy, the head and tail (< 16 bytes each) by plain loads.
struct Stage {
  const uint8_t* src;
  int bytes, lead, head, body;
};

__device__ __forceinline__ Stage stage_plan(const void* src, int bytes) {
  Stage s;
  s.src = static_cast<const uint8_t*>(src);
  s.bytes = bytes > 0 ? bytes : 0;
  s.lead = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int h = (16 - s.lead) & 15;
  s.head = h < s.bytes ? h : s.bytes;
  s.body = (s.bytes - s.head) & ~15;
  return s;
}

// One thread, after mbar_arrive_tx of every stage's body on `bar`.
__device__ __forceinline__ void stage_body(uint8_t* dst, const Stage& s,
                                           uint64_t* bar) {
  if (s.body > 0) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst + s.lead + s.head)), "l"(s.src + s.head),
          "r"(s.body), "r"(smem_u32(bar)) : "memory");
  }
}

// Every thread: its share of the head and tail bytes.
__device__ __forceinline__ void stage_edges(uint8_t* dst, const Stage& s) {
  const int tail = s.head + s.body;
  const int edges = s.bytes - s.body;
  for (int i = threadIdx.x; i < edges; i += blockDim.x) {
    const int k = i < s.head ? i : tail + (i - s.head);
    dst[s.lead + k] = __ldg(s.src + k);
  }
}

// ------------------------------------------------------- the look-back --

__device__ __forceinline__ unsigned long long status_load(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void status_store(unsigned long long* p,
                                             unsigned long long flag,
                                             long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) =
      flag | (static_cast<unsigned long long>(v) & kValBits);
}

__device__ __forceinline__ long long status_value(unsigned long long s) {
  return static_cast<long long>(s << 2) >> 2;
}

// The status word at `p` once its flag is at least `flag`; a wait of ~8 s
// (2^34 cycles) traps.  Every word waited on is a lower ticket's, whose
// block has started and waits on no higher one.
__device__ __forceinline__ unsigned long long status_wait(
    const unsigned long long* p, unsigned long long flag) {
  const long long t0 = clock64();
  unsigned long long s;
  while (((s = status_load(p)) & ~kValBits) < flag) {
    if (clock64() - t0 > (1ll << 34)) __trap();
    __nanosleep(64);
  }
  return s;
}

// Tile t's sum, published for its successors' look-backs: an aggregate,
// or for the row's first tile, whose prefix is 0, at once an inclusive
// sum, where every look-back of the row can end.
__device__ __forceinline__ void publish_sum(unsigned long long* srow,
                                            long long t, long long sum) {
  if (threadIdx.x == 0) status_store(srow + t, t > 0 ? kAgg : kInc, sum);
}

// Tile t of a row whose status words are `srow` (tiles in ticket order),
// after publish_sum: sums its predecessors' words back to the nearest
// inclusive one and publishes its inclusive sum; returns its exclusive
// prefix, the same in every thread.  A step reads kBlock * kLookWidth
// words at once: thread i the words at distances i + 1 + kBlock * j, so
// that only the nearest row, one word a thread, can still wait on a
// tile's first status.  Every thread of the block (kBlock threads:
// kLookThreads, or rle_scan's block) calls it, right after a
// block_exclusive_scan on `scratch` if need be (a barrier comes before any
// write); `scratch` and `first_s` (kLookWidth * kBlock / 32 ints, shared)
// are free again when it returns.
template <int kBlock = kLookThreads>
__device__ __forceinline__ long long look_back(unsigned long long* srow,
                                               long long t,
                                               long long tile_sum,
                                               long long* scratch,
                                               int* first_s) {
  constexpr int kWarps = kBlock / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long acc = 0;
  for (long long look = t - 1 - tid; look + tid >= 0;
       look -= kBlock * kLookWidth) {
    // before the row's first tile: an inclusive 0
    unsigned long long sv[kLookWidth];
#pragma unroll
    for (int j = 0; j < kLookWidth; ++j) {
      const long long tj = look - kBlock * j;
      sv[j] = tj >= 0 ? __ldcg(srow + tj) : kInc;   // pipelined
    }
#pragma unroll
    for (int j = 0; j < kLookWidth; ++j) {
      const long long tj = look - kBlock * j;
      if ((sv[j] & ~kValBits) < kAgg) sv[j] = status_wait(srow + tj, kAgg);
      const unsigned inc = __ballot_sync(kFull,
                                         (sv[j] & ~kValBits) == kInc);
      if (lane == 0) {
        first_s[j * kWarps + warp] = inc ? tid + __ffs(inc) - 1 : kBlock;
      }
    }
    __syncthreads();
    // the nearest inclusive word: its row, then its thread
    int row = kLookWidth, nearest = kBlock;
    for (int j = 0; j < kLookWidth && row == kLookWidth; ++j) {
      for (int w = 0; w < kWarps; ++w) {
        nearest = first_s[j * kWarps + w] < nearest
            ? first_s[j * kWarps + w] : nearest;
      }
      if (nearest < kBlock) row = j;
    }
    long long part = 0;
#pragma unroll
    for (int j = 0; j < kLookWidth; ++j) {
      if (j < row || (j == row && tid <= nearest)) {
        part += status_value(sv[j]);
      }
    }
    long long sum;
    block_exclusive_scan(part, scratch, sum);
    acc += sum;
    __syncthreads();            // first_s and scratch free again
    if (row < kLookWidth) break;
  }
  if (tid == 0 && t > 0) status_store(srow + t, kInc, acc + tile_sum);
  return acc;
}

// ------------------------------------------------------------- stats --

// The cluster's barrier in two halves: an arrival (releasing this thread's
// shared-memory writes to the cluster), then a wait for every thread of the
// cluster's blocks to have arrived.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a stats block's symbols at (rows, s): 16,384, halved while the launch
// would have fewer than kStatsBlocks blocks, 4,096 at least (mirrored by
// kernels/lossless.py stats_tiling)
inline int stats_tile(long long rows, long long s) {
  int tile = kStatsMaxTile;
  while (tile > kStatsMinTile
         && rows * ((s + tile - 1) / tile) < kStatsBlocks) {
    tile /= 2;
  }
  return tile;
}

// a cluster's blocks for a row of `tiles`: its tiles rounded up to a power
// of two, at most kMaxCluster
inline int stats_cluster(long long tiles) {
  int k = 1;
  while (k < kMaxCluster && k < tiles) k *= 2;
  return k;
}

// bit 7 of each byte of x set where that byte is not zero
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// A thread's word w of symbols (nb of them in the row, all four where
// kFull) after the symbol pv: its run starts added to `breaks` (forced:
// a break at the word's first symbol), its symbols to the warp's `bins`:
// a word of one symbol to the run (run_sym, run_len) kept in registers,
// which first moves to that symbol, any other word byte by byte, by
// shared atomics.
template <bool kFull>
__device__ __forceinline__ void count_word(uint32_t w, int nb, uint32_t pv,
                                           bool forced, uint32_t* bins,
                                           uint32_t& run_sym,
                                           uint32_t& run_len,
                                           uint32_t& breaks) {
  uint32_t ne = nonzero_bytes(w ^ ((w << 8) | pv));
  if (forced) ne |= 0x80u;
  if (!kFull) ne &= nb >= 4 ? 0xFFFFFFFFu : (1u << (8 * nb)) - 1;
  breaks += __popc(ne);
  const uint32_t c0 = w & 0xFFu;
  if ((kFull || nb >= 4) && c0 * 0x01010101u == w) {
    if (c0 != run_sym) {
      if (run_len != 0) atomicAdd(bins + run_sym, run_len);
      run_sym = c0;
      run_len = 0;
    }
    run_len += 4;
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (kFull || m < nb) atomicAdd(bins + ((w >> (8 * m)) & 0xFFu), 1u);
    }
  }
}

// A block of a cluster of k (gridDim.x = clusters * k, blocks past the
// row's tiles count nothing): the histogram and run starts of its tile of
// row blockIdx.y.  sums: (rows, 258) uint64, zeroed, where clusters > 1:
// each row's 257 totals, then its count of arrived clusters.
__global__ void __launch_bounds__(kStatsThreads, kStatsMinBlocks)
stats_kernel(const uint8_t* __restrict__ syms, long long s, int tile,
             int clusters, unsigned long long* __restrict__ hist,
             unsigned long long* __restrict__ nruns,
             unsigned long long* __restrict__ sums) {
  constexpr int kWarps = kStatsThreads / 32;
  __shared__ __align__(16) uint32_t wh[kWarps * 256];
  // the cluster's bins, then its run starts (the leader's, added to by
  // every block of the cluster)
  __shared__ uint32_t acc[257];
  __shared__ uint32_t brk_w[kWarps];
  __shared__ int last_s;
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = blockIdx.y;
  const uint8_t* row = syms + b * s;
  const int segs = tile / (kStatsThreads * 16);
  const long long tile0 = static_cast<long long>(blockIdx.x) * tile;
  // every load of the thread before any count
  Sym16 v[kStatsMaxSegs];
  uint32_t left[kStatsMaxSegs];
#pragma unroll
  for (int it = 0; it < kStatsMaxSegs; ++it) {
    if (it < segs) {
      const long long q = tile0 + (static_cast<long long>(it) * kStatsThreads
                                   + threadIdx.x) * 16;
      v[it] = load16(row, s, q);
      left[it] = (lane == 0 && q > 0 && q <= s) ? __ldg(row + q - 1) : 0u;
    }
  }
  for (int i = threadIdx.x; i < kWarps * 256 / 4; i += kStatsThreads) {
    reinterpret_cast<uint4*>(wh)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = threadIdx.x; i < 257; i += kStatsThreads) acc[i] = 0;
  __syncthreads();
  cluster_arrive_release();     // this block's acc is zero
  uint32_t* bins = wh + warp * 256;
  uint32_t run_sym = 0, run_len = 0, breaks = 0;
#pragma unroll
  for (int it = 0; it < kStatsMaxSegs; ++it) {
    if (it < segs) {
      const long long q = tile0 + (static_cast<long long>(it) * kStatsThreads
                                   + threadIdx.x) * 16;
      uint32_t pv = __shfl_up_sync(kFull, v[it].w[3] >> 24, 1);
      if (lane == 0) pv = left[it];
      const bool forced = (q & (kRleBreak - 1)) == 0;
      const int cnt = seg_count(s, q);
      if (cnt == 16) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          count_word<true>(v[it].w[j], 4, j ? v[it].w[j - 1] >> 24 : pv,
                           j == 0 && forced, bins, run_sym, run_len, breaks);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * j < cnt) {
            count_word<false>(v[it].w[j], cnt - 4 * j,
                              j ? v[it].w[j - 1] >> 24 : pv,
                              j == 0 && forced, bins, run_sym, run_len,
                              breaks);
          }
        }
      }
    }
  }
  if (run_len != 0) atomicAdd(bins + run_sym, run_len);
  breaks = __reduce_add_sync(kFull, breaks);
  if (lane == 0) brk_w[warp] = breaks;
  __syncthreads();
  // the block's totals into the leader's acc (kStatsThreads == 256: a
  // thread a bin), once every block of the cluster has zeroed its own
  uint32_t t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += wh[w * 256 + threadIdx.x];
  cluster_wait();
  uint32_t* lacc = cluster.map_shared_rank(acc, 0);
  if (t != 0) atomicAdd(lacc + threadIdx.x, t);
  if (threadIdx.x == 0) {
    uint32_t x = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += brk_w[w];
    if (x != 0) atomicAdd(lacc + 256, x);
  }
  cluster.sync();               // every block's adds are in
  if (cluster.block_rank() != 0) return;
  unsigned long long* srow = sums + b * 258;
  for (int i = threadIdx.x; i < 257; i += kStatsThreads) {
    const uint32_t x = acc[i];
    if (clusters > 1) {
      if (x != 0) atomicAdd(srow + i, static_cast<unsigned long long>(x));
    } else if (i < 256) {
      hist[b * 256 + i] = x;
    } else {
      nruns[b] = x;
    }
  }
  if (clusters == 1) return;
  // the row's last cluster to arrive copies its sums out
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last_s = atomicAdd(srow + 257, 1ull)
             == static_cast<unsigned long long>(clusters - 1);
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int i = threadIdx.x; i < 257; i += kStatsThreads) {
    const unsigned long long x = __ldcg(srow + i);
    if (i < 256) {
      hist[b * 256 + i] = x;
    } else {
      nruns[b] = x;
    }
  }
}

// ------------------------------------------------------ huffman pack --

// Words [lo, hi) of the row `wrow`, word w being word(w): whole 16-byte
// granules by one store, the edges word by word.
template <typename F>
__device__ __forceinline__ void store_words(uint32_t* wrow, long long lo,
                                            long long hi, F word) {
  if (hi <= lo) return;
  const long long a = (reinterpret_cast<uintptr_t>(wrow) >> 2) & 3;
  const long long g0 = ((lo + a) & ~3LL) - a;   // lo's granule
  const long long granules = (hi - g0 + 3) >> 2;
  for (long long gi = threadIdx.x; gi < granules; gi += blockDim.x) {
    const long long w = g0 + 4 * gi;
    if (w >= lo && w + 4 <= hi) {
      *reinterpret_cast<uint4*>(wrow + w) =
          make_uint4(word(w), word(w + 1), word(w + 2), word(w + 3));
    } else {
      for (long long x = w < lo ? lo : w; x < w + 4 && x < hi; ++x) {
        wrow[x] = word(x);
      }
    }
  }
}

// A symbol's code and length in one word: the code MSB-aligned, the length
// in the low 5 bits (a code of at most 16 bits leaves its low 16 free).  A
// length of 0, or past MAX_CODE_LEN (16, no codebook's), places no bit
// and counts as 0.
__device__ __forceinline__ uint32_t code_entry(long long len,
                                               long long code) {
  return len > 0 && len <= 16
      ? static_cast<uint32_t>(code) << (32 - len) | static_cast<uint32_t>(len)
      : 0u;
}

// A thread's cnt codes (all 16 where kFull) of the symbols v into the
// zeroed tile from bit p: cur is tile word t, its first nacc bits placed;
// a code of at most 16 bits fills at most one word, which is ORed in (it
// may share its bits with neighbouring threads), with no branch.
template <bool kFull>
__device__ __forceinline__ void pack_codes(const Sym16& v, int cnt, int p,
                                           const uint32_t* code_s,
                                           uint32_t* tile) {
  int t = p >> 5, nacc = p & 31;
  uint32_t cur = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t e = kFull || k < cnt ? code_s[sym_at(v, k)] : 0u;
    const uint32_t msb = e & ~31u;
    cur |= msb >> nacc;
    const uint32_t spill = __funnelshift_r(0u, msb, nacc);
    nacc += static_cast<int>(e & 31u);
    const bool full = nacc >= 32;
    if (full) atomicOr(tile + t, cur);
    cur = full ? spill : cur;
    nacc -= full ? 32 : 0;
    t += full;
  }
  if (cur != 0) atomicOr(tile + t, cur);
}

// chunks a pack ticket: 1, doubled up to kPackGroup while the launch would
// have more tickets than the card holds pack blocks at once (mirrored by
// kernels/lossless.py pack_group)
inline int pack_group(long long rows, long long chunks) {
  int g = 1;
  while (g < kPackGroup && rows * ((chunks + g - 1) / g) > kPackBlocks) {
    g *= 2;
  }
  return g;
}

// A block a ticket: `group` consecutive chunks of one row (the row's last
// ticket may have fewer), tickets in order over (row, group of chunks).
__global__ void __launch_bounds__(kPackThreads, kPackMinBlocks)
huff_pack_kernel(const uint8_t* __restrict__ syms, long long s,
                 const long long* __restrict__ lens_tab,
                 const long long* __restrict__ codes_tab, int chunks,
                 int group, int groups, long long tickets,
                 unsigned long long* __restrict__ status,
                 unsigned long long* __restrict__ ticket,
                 long long* __restrict__ chunk_offs,
                 long long* __restrict__ total_bits,
                 uint32_t* __restrict__ words, long long cap) {
  __shared__ __align__(16) uint32_t tile[kPackWords];
  __shared__ uint32_t code_s[256];   // a symbol's code_entry
  __shared__ int iscratch[32];
  __shared__ long long scratch[32];
  __shared__ int first_s[kLookWidth * kLookThreads / 32];
  __shared__ long long ticket_s;
  __shared__ uint32_t head_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) ticket_s = static_cast<long long>(atomicAdd(ticket, 1ull));
  __syncthreads();
  const long long tk = ticket_s;
  if (tk >= tickets) return;
  const int gi = static_cast<int>(tk % groups);
  const long long b = tk / groups;
  const int c0 = gi * group;
  const int nc = chunks - c0 < group ? chunks - c0 : group;
  const uint8_t* row = syms + b * s;
  const long long first = static_cast<long long>(c0) * kChunk;
  // chunk g's symbols tid * 16 .. of the group, one 16-byte load each
  Sym16 v[kPackGroup];
#pragma unroll
  for (int g = 0; g < kPackGroup; ++g) {
    if (g < nc) v[g] = load16(row, s, first + g * kChunk + tid * 16);
  }
  // warp 0: the 32 symbols before the group, for its head word
  const long long hq = first - 32 + lane;
  uint32_t hsym = (warp == 0 && hq >= 0) ? __ldg(row + hq) : 0u;
  code_s[tid] = code_entry(lens_tab[b * 256 + tid],
                           codes_tab[b * 256 + tid]);
  for (int i = tid; i < (nc * kChunk / 2 + 8) / 4; i += kPackThreads) {
    reinterpret_cast<uint4*>(tile)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  // each chunk's lengths scanned over the block: the thread's first bit
  // in the chunk, and the chunk's first bit in the group
  int ex[kPackGroup], sub[kPackGroup];
  int tot = 0;
#pragma unroll
  for (int g = 0; g < kPackGroup; ++g) {
    if (g < nc) {
      const int cnt = seg_count(s, first + g * kChunk + tid * 16);
      int bits = 0;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (k < cnt) bits += static_cast<int>(code_s[sym_at(v[g], k)] & 31u);
      }
      int chunk_bits;
      ex[g] = block_exclusive_scan(bits, iscratch, chunk_bits);
      sub[g] = tot;
      tot += chunk_bits;
      __syncthreads();          // iscratch free again
    }
  }
  unsigned long long* srow = status + b * groups;
  publish_sum(srow, gi, tot);
  // the codes into the tile's words, from the group's first bit, while
  // the predecessors publish theirs
#pragma unroll
  for (int g = 0; g < kPackGroup; ++g) {
    if (g < nc) {
      const int cnt = seg_count(s, first + g * kChunk + tid * 16);
      if (cnt == 16) {
        pack_codes<true>(v[g], 16, sub[g] + ex[g], code_s, tile);
      } else {
        pack_codes<false>(v[g], cnt, sub[g] + ex[g], code_s, tile);
      }
    }
  }
  const long long o = look_back(srow, gi, tot, scratch, first_s);
  const long long f = o >> 5;   // the group's first word
  const int sh = static_cast<int>(o & 31);
  if (warp == 0 && sh != 0) {
    // word f's bits before o, from the codes of the symbols before the
    // group: 32 symbols a step, back until they cover the word's head
    const long long lo = f << 5;
    long long end = o;          // the bit after the window's codes
    long long i0 = first - 32;  // the window's first symbol
    uint32_t head = 0;
    while (true) {
      const uint32_t e = i0 + lane >= 0 ? code_s[hsym] : 0u;
      const int ln = static_cast<int>(e & 31u);
      const uint32_t m = e & ~31u;
      int suf = ln;             // this and the later lanes' lengths
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_down_sync(kFull, suf, d);
        if (lane + d < 32) suf += y;
      }
      const long long start = end - suf;   // the code's first bit
      if (m != 0 && start + ln > lo && start < lo + 32) {
        const long long d = start - lo;
        head |= d >= 0 ? m >> d : m << (-d);
      }
      end -= __shfl_sync(kFull, suf, 0);
      i0 -= 32;
      if (end <= lo || i0 + 32 <= 0) break;
      hsym = i0 + lane >= 0 ? __ldg(row + i0 + lane) : 0u;
    }
    head = __reduce_or_sync(kFull, head);
    if (lane == 0) head_s = head;
  }
  __syncthreads();
  const bool last = gi + 1 == groups;
  uint32_t* wrow = words + b * cap;
  // the stream words the group owns, from its first word to the word its
  // successor starts in (the row's last group: to its last partial word):
  // the tile's words shifted to bit o, the first after the head's bits
  long long e = last ? (o + tot + 31) >> 5 : (o + tot) >> 5;
  if (e > cap) e = cap;
  // the bits before o, in the low sh bits: the word before tile[0]
  const uint32_t head = sh ? head_s >> (32 - sh) : 0u;
  store_words(wrow, f, e, [&](long long w) {
    const int i = static_cast<int>(w - f);
    return __funnelshift_r(tile[i], i ? tile[i - 1] : head, sh);
  });
  // the zeros in [T, the T of the group before) (module note)
  const long long after = s - first - static_cast<long long>(nc) * kChunk;
  long long t_lo = (o + tot + 16 * (after > 0 ? after : 0) + 31) >> 5;
  long long t_hi = gi == 0 ? cap : (o + 16 * (s - first) + 31) >> 5;
  t_lo = t_lo < cap ? t_lo : cap;
  t_hi = t_hi < cap ? t_hi : cap;
  store_words(wrow, t_lo, t_hi, [](long long) { return 0u; });
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < kPackGroup; ++g) {
      if (g < nc) chunk_offs[b * chunks + c0 + g] = o + sub[g];
    }
    if (last) total_bits[b] = o + tot;
  }
}

// ---------------------------------------------------- huffman decode --

// (sym | len << 8) of the 16-bit peek: the primary table's entry where it
// holds one, else the row's full tables
__device__ __forceinline__ uint32_t lookup(uint32_t peek, const uint16_t* prim,
                                           const uint8_t* ls,
                                           const uint8_t* ll) {
  uint32_t e = prim[peek >> kPrimSub];
  if ((e >> 8) > kPrimBits) {
    e = __ldg(ls + peek) | static_cast<uint32_t>(__ldg(ll + peek)) << 8;
  }
  return e;
}

// Entry q of a row's primary table from its 32 peeks q << 5 ...: their
// common (sym | len << 8) if all agree and len <= kPrimBits, else kLong.
__global__ void __launch_bounds__(256)
huff_primary_kernel(const uint8_t* __restrict__ lut_sym,
                    const uint8_t* __restrict__ lut_len,
                    uint16_t* __restrict__ prim) {
  const long long b = blockIdx.y;
  const int q = blockIdx.x * 256 + threadIdx.x;
  const long long at = b * kLut + (static_cast<long long>(q) << kPrimSub);
  uint32_t same = 1, sym = 0, len = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const Sym16 sv = load16(lut_sym + at, 32, 16 * h);
    const Sym16 lv = load16(lut_len + at, 32, 16 * h);
    if (h == 0) {
      sym = sym_at(sv, 0);
      len = sym_at(lv, 0);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      same &= (sv.w[k] == sym * 0x01010101u) & (lv.w[k] == len * 0x01010101u);
    }
  }
  prim[b * kPrim + q] = static_cast<uint16_t>(
      same && len <= kPrimBits ? sym | len << 8 : kLong);
}

// A serial walk through global loads, as the reference's: the 32-bit
// window at the position is w0:w1 shifted left by `sh` (< 32), w2 .. w5
// the next words, loaded ahead.  A step past w0 moves the words down and
// loads one more, off the chain.
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

  // the symbol at the position, which advances by its code's length
  __device__ __forceinline__ uint32_t next(const uint16_t* prim,
                                           const uint8_t* ls,
                                           const uint8_t* ll) {
    const uint32_t e = lookup(__funnelshift_l(w1, w0, sh) >> 16, prim, ls,
                              ll);
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

__device__ __forceinline__ uint32_t staged(const uint32_t* sw, int nw, int k) {
  return k < nw ? sw[k] : 0u;
}

// The staged words' zero tail: from bit `from` on every window is zero,
// so every code is (sym0, len0), the peek table's entry 0.
struct Tail {
  int from;
  uint32_t sym0, len0;
};

// A lane's walk over the staged words `sw` (nw of them; positions in bits
// from the first): from `pos` while the position is before `stop`.  Gives
// the first position at or past `stop`, the codes walked, and whether a
// zero length was met (walked over as one bit).  In the zero tail the
// codes are counted, not walked.  kWrite: the symbols go to tile[slot
// ...], the first `limit - slot` of them.  The window's two words are
// read from shared memory at every step: a window kept in registers and
// moved down a word at a time, as the serial walk keeps it, gave codes
// other than the host's on the card here (PERF.md).
template <bool kWrite>
__device__ __forceinline__ int walk(const uint32_t* sw, int nw, int pos,
                                    int stop, const Tail& tail,
                                    const uint16_t* prim, const uint8_t* ls,
                                    const uint8_t* ll, int& count, bool& zero,
                                    uint8_t* tile, int slot, int limit) {
  int p = pos, cnt = 0;
  bool z = false;
  while (p < stop) {
    if (kWrite && slot + cnt >= limit) break;
    if (p >= tail.from && tail.len0 > 0) {
      const int len0 = static_cast<int>(tail.len0);
      int more = (stop - p + len0 - 1) / len0;
      if (kWrite) {
        const int room = limit - slot - cnt;
        if (more > room) more = room;
        for (int i = 0; i < more; ++i) {
          tile[slot + cnt + i] = static_cast<uint8_t>(tail.sym0);
        }
      }
      cnt += more;
      p += more * len0;
      break;
    }
    const int k = p >> 5;
    const uint32_t e = lookup(
        __funnelshift_l(staged(sw, nw, k + 1), staged(sw, nw, k),
                        static_cast<uint32_t>(p) & 31u) >> 16,
        prim, ls, ll);
    const int len = static_cast<int>(e >> 8);
    if (kWrite) tile[slot + cnt] = static_cast<uint8_t>(e);
    ++cnt;
    if (len == 0) z = true;
    p += len == 0 ? 1 : len;
  }
  count = cnt;
  zero = z;
  return p;
}

__global__ void __launch_bounds__(kMaxLanes)
huff_decode_kernel(const uint32_t* __restrict__ words, long long n_words,
                   const long long* __restrict__ chunk_offs, int chunks,
                   int used, const uint16_t* __restrict__ primary,
                   const uint8_t* __restrict__ lut_sym,
                   const uint8_t* __restrict__ lut_len,
                   unsigned long long* __restrict__ walks,
                   uint8_t* __restrict__ out, long long n) {
  __shared__ __align__(16) uint8_t words_s[kStageWords * 4 + 16];
  __shared__ __align__(16) uint8_t prim_s[kPrim * 2 + 16];
  __shared__ __align__(16) uint8_t tile[kChunk + 16];   // or entry exits
  __shared__ int end_s[kMaxLanes];
  __shared__ int scratch[32];
  // least and most length of a direct entry; the last non-zero word + 1
  __shared__ int quantum[3];
  __shared__ __align__(8) uint64_t bar;
  const int lane = threadIdx.x, lanes = blockDim.x;
  const long long b = blockIdx.y;
  const int c = blockIdx.x;
  const long long first = static_cast<long long>(c) * kChunk;
  const int count = static_cast<int>(n - first < kChunk ? n - first : kChunk);
  const uint32_t* wrow = words + b * n_words;
  const long long* orow = chunk_offs + b * chunks;
  const long long off = static_cast<uint32_t>(orow[c]);
  const bool last = c + 1 == used;
  long long end = off + 16LL * count;   // count codes of at most 16 bits
  if (end > 32 * n_words) end = 32 * n_words;
  if (!last) end = static_cast<uint32_t>(orow[c + 1]);
  const bool parallel = end > off && end - off <= kChunkBits;
  const long long wlo = off >> 5;
  const int nstage = parallel
      ? static_cast<int>(((end - 1) >> 5) - wlo + 4) : 0;
  long long avail = n_words - wlo;
  if (avail > nstage) avail = nstage;
  if (avail < 0) avail = 0;
  const Stage sw_plan = stage_plan(wrow + wlo, static_cast<int>(4 * avail));
  const Stage sp_plan = stage_plan(primary + b * kPrim, 2 * kPrim);
  if (lane == 0) {
    mbar_init(&bar);
    quantum[0] = 255;
    quantum[1] = 0;
    quantum[2] = 0;
  }
  __syncthreads();
  if (lane == 0) {
    mbar_arrive_tx(&bar, sw_plan.body + sp_plan.body);
    stage_body(words_s, sw_plan, &bar);
    stage_body(prim_s, sp_plan, &bar);
  }
  stage_edges(words_s, sw_plan);
  stage_edges(prim_s, sp_plan);
  uint32_t* sw = reinterpret_cast<uint32_t*>(words_s + sw_plan.lead);
  for (int k = static_cast<int>(avail) + lane; k < nstage; k += lanes) {
    sw[k] = 0;                  // past the row's words
  }
  mbar_wait0(&bar);
  __syncthreads();
  const uint16_t* prim = reinterpret_cast<const uint16_t*>(prim_s
                                                           + sp_plan.lead);
  const uint8_t* ls = lut_sym + b * kLut;
  const uint8_t* ll = lut_len + b * kLut;
  uint8_t* dst = out + b * n + first;
  const int toff = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  uint8_t* tl = tile + toff;    // tile[16 g] lies as dst[16 g - toff]
  bool ok = false;
  int rounds = 0;
  if (parallel) {
    // the spans' quantum: a codebook's one code length, where it has one;
    // and the zero tail, which the last lane takes
    int lmin = 255, lmax = 0, nz = 0;
    for (int q = lane; q < kPrim; q += lanes) {
      const int len = prim[q] >> 8;
      if (len > 0) {
        lmin = len < lmin ? len : lmin;
        lmax = len > lmax ? len : lmax;
      }
    }
    for (int k = lane; k < nstage; k += lanes) {
      if (sw[k] != 0) nz = k + 1;
    }
    lmin = __reduce_min_sync(kFull, lmin);
    lmax = __reduce_max_sync(kFull, lmax);
    nz = __reduce_max_sync(kFull, nz);
    if ((lane & 31) == 0) {
      atomicMin(&quantum[0], lmin);
      atomicMax(&quantum[1], lmax);
      atomicMax(&quantum[2], nz);
    }
    __syncthreads();
    const int g = quantum[0] == quantum[1] && quantum[1] <= kPrimBits
        ? quantum[0] : 1;
    const uint32_t e0 = lookup(0, prim, ls, ll);
    const Tail tail = {32 * quantum[2], e0 & 0xFFu, e0 >> 8};
    const int base_rel = static_cast<int>(off - 32 * wlo);
    const int stop_all = static_cast<int>(end - 32 * wlo);
    int split = tail.from < stop_all ? tail.from : stop_all;
    if (split < base_rel) split = base_rel;
    // the last `act` lanes share the spans, kLaneBits at least each; the
    // others hold empty spans at the chunk's start, a true boundary
    const int units = (split - base_rel) / g;
    int act = units * g / kLaneBits;
    act = act < 1 ? 1 : (act > lanes ? lanes : act);
    const int i = lane - (lanes - act);
    int start = base_rel, stop = base_rel;
    if (i >= 0) {
      start += (units * i / act) * g;
      stop = i + 1 == act ? stop_all : base_rel + (units * (i + 1) / act) * g;
    }
    const int nominal = start;
    int cnt;
    bool zero;
    int p = walk<false>(sw, nstage, start, stop, tail, prim, ls, ll, cnt,
                        zero, nullptr, 0, 0);
    bool lost = false;          // a lane's start past its entry table
    while (true) {              // until no lane's start moves
      end_s[lane] = p;
      __syncthreads();
      const int ns = lane ? end_s[lane - 1] : start;
      const bool moved = ns != start;
      if (!__syncthreads_or(moved)) break;
      if (++rounds == kTableRound) {
        // Still moving: a codebook of nearly one length, which falls into
        // step seldom, would take a round a lane.  Each lane walks its span
        // from every entry a true start can have (its nominal start plus
        // 0 .. lm - 1, lm the longest code), one lane chains the exits from
        // lane 0's true start, and each lane walks once from its own.
        const int lm = quantum[1] == 0 ? 1
            : (quantum[1] <= kPrimBits ? quantum[1] : 16);
        uint8_t* exits = tile;  // lm x kMaxLanes, before any symbol lands
        for (int f = 0; f < lm; ++f) {
          int x = nominal + f - stop;   // a span too short to enter
          if (x < 0) {
            int c;
            bool z;
            x = walk<false>(sw, nstage, nominal + f, stop, tail, prim, ls,
                            ll, c, z, nullptr, 0, 0) - stop;
          }
          exits[f * kMaxLanes + lane] = static_cast<uint8_t>(x < lm ? x
                                                                    : 0xFF);
        }
        __syncthreads();
        if (lane == 0) {
          int f = 0;
          for (int l = 0; l < lanes; ++l) {
            end_s[l] = f;
            if (f != 0xFF) f = exits[f * kMaxLanes + l];
          }
        }
        __syncthreads();
        const int f = end_s[lane];
        lost = __syncthreads_or(f == 0xFF);
        start = nominal + (f == 0xFF ? 0 : f);
        p = walk<false>(sw, nstage, start, stop, tail, prim, ls, ll, cnt,
                        zero, nullptr, 0, 0);
        end_s[lane] = p;        // read after the scan's barriers
        break;
      }
      if (moved) {
        start = ns;
        p = walk<false>(sw, nstage, start, stop, tail, prim, ls, ll, cnt,
                        zero, nullptr, 0, 0);
      }
    }
    int total;
    const int base = block_exclusive_scan(cnt, scratch, total);
    const bool zany = __syncthreads_or(zero);
    ok = !zany && !lost
         && (last ? total >= count
                  : total == count && end_s[lanes - 1] == stop_all);
    if (ok && base < count) {
      walk<true>(sw, nstage, start, stop, tail, prim, ls, ll, cnt, zero, tl,
                 base, count);
    }
  }
  if (!ok && lane == 0) {       // the reference's serial walk
    Walker wk;
    wk.w = wrow;
    wk.n_words = n_words;
    wk.seek(off);
    for (int k = 0; k < count; ++k) {
      tl[k] = static_cast<uint8_t>(wk.next(prim, ls, ll));
    }
  }
  __syncthreads();
  // the tile's 16-byte granules: whole ones at once, the edges by bytes
  const int granules = (toff + count + 15) >> 4;
  for (int gi = lane; gi < granules; gi += lanes) {
    const int lo = gi == 0 ? toff : 16 * gi;
    const int hi = 16 * gi + 16 < toff + count ? 16 * gi + 16 : toff + count;
    if (lo == 16 * gi && hi == 16 * gi + 16) {
      *reinterpret_cast<uint4*>(dst - toff + 16 * gi) =
          *reinterpret_cast<const uint4*>(tile + 16 * gi);
    } else {
      for (int k = lo; k < hi; ++k) dst[k - toff] = tile[k];
    }
  }
  if (lane == 0 && walks != nullptr) {
    atomicAdd(walks, 1ull);
    if (!ok) atomicAdd(walks + 1, 1ull);
    if (rounds) {
      atomicAdd(walks + 2, static_cast<unsigned long long>(rounds));
      atomicMax(walks + 3, static_cast<unsigned long long>(rounds));
    }
  }
}

// ----------------------------------------------------------- rle scan --

// bit k set where symbol k of the segment v starts a run: it differs from
// the symbol before it (pv for the first), or `forced` (the first); only
// the first cnt symbols (those in the row) count
__device__ __forceinline__ uint32_t seg_starts(const Sym16& v, uint32_t pv,
                                               bool forced, int cnt) {
  uint32_t m = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t x = v.w[w];
    const uint32_t ne = nonzero_bytes(x ^ ((x << 8) | (w ? v.w[w - 1] >> 24
                                                        : pv)));
    m |= ((ne >> 7 & 1u) | (ne >> 14 & 2u) | (ne >> 21 & 4u)
          | (ne >> 28 & 8u)) << (4 * w);
  }
  if (forced) m |= 1u;
  return cnt >= 16 ? m : (cnt <= 0 ? 0u : m & ((1u << cnt) - 1u));
}

// A block of kThreads a ticket: tile t of row b, tickets in order over
// (row, tile); kMinBlocks of them an SM (2 of 512 threads, 4 of 256).
template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rle_scan_kernel(const uint8_t* __restrict__ syms, long long s, int tiles,
                long long tickets, unsigned long long* __restrict__ status,
                unsigned long long* __restrict__ ticket,
                uint8_t* __restrict__ values, uint16_t* __restrict__ lengths,
                long long* __restrict__ nruns) {
  constexpr int kRleSegs = kRleBreak / (kThreads * 16);   // 16-byte loads
  constexpr int kRleWarps = kThreads / 32;
  __shared__ __align__(16) uint8_t tile_s[kRleBreak];
  // each segment's run starts (bit k: its symbol k), two a word
  __shared__ uint32_t mask_s[kRleBreak / 32];
  // each piece's run starts and last start (-1: none), then its first
  // run's slot in the tile and the last start before it
  __shared__ int piece_n[kRlePieces], piece_last[kRlePieces];
  __shared__ int piece_first[kRlePieces], piece_prev[kRlePieces];
  __shared__ long long scratch[32];
  __shared__ int first_s[kLookWidth * kThreads / 32];
  __shared__ long long ticket_s;
  __shared__ int total_s, last_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) ticket_s = static_cast<long long>(atomicAdd(ticket, 1ull));
  __syncthreads();
  const long long tk = ticket_s;
  if (tk >= tickets) return;
  const int t = static_cast<int>(tk % tiles);
  const long long b = tk / tiles;
  const uint8_t* row = syms + b * s;
  const long long t0 = static_cast<long long>(t) * kRleBreak;
  const int len = static_cast<int>(s - t0 < kRleBreak ? s - t0 : kRleBreak);
  // every load of the thread, then the shared tile
  Sym16 v[kRleSegs];
#pragma unroll
  for (int j = 0; j < kRleSegs; ++j) {
    const int g = j * kThreads + tid;
    if (16 * g < len) {
      v[j] = load16(row, s, t0 + 16 * g);
    } else {
      v[j].w[0] = v[j].w[1] = v[j].w[2] = v[j].w[3] = 0u;
    }
  }
#pragma unroll
  for (int j = 0; j < kRleSegs; ++j) {
    reinterpret_cast<uint4*>(tile_s)[j * kThreads + tid] =
        make_uint4(v[j].w[0], v[j].w[1], v[j].w[2], v[j].w[3]);
  }
  __syncthreads();
  // each piece's run starts and last start
#pragma unroll
  for (int j = 0; j < kRleSegs; ++j) {
    const int g = j * kThreads + tid;
    uint32_t pv = __shfl_up_sync(kFull, v[j].w[3] >> 24, 1);
    if (lane == 0) pv = g > 0 ? tile_s[16 * g - 1] : 0u;
    const uint32_t m = seg_starts(v[j], pv, g == 0, len - 16 * g);
    reinterpret_cast<uint16_t*>(mask_s)[g] = static_cast<uint16_t>(m);
    const int n = __reduce_add_sync(kFull, static_cast<unsigned>(__popc(m)));
    const int last = __reduce_max_sync(kFull, m ? 16 * g + 31 - __clz(m)
                                                : -1);
    if (lane == 0) {
      piece_n[j * kRleWarps + warp] = n;
      piece_last[j * kRleWarps + warp] = last;
    }
  }
  __syncthreads();
  if (warp == 0) {              // the pieces in order, two a lane
    const int n0 = piece_n[2 * lane], n1 = piece_n[2 * lane + 1];
    const int a0 = piece_last[2 * lane], a1 = piece_last[2 * lane + 1];
    int n = n0 + n1, a = a0 > a1 ? a0 : a1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int yn = __shfl_up_sync(kFull, n, d);
      const int ya = __shfl_up_sync(kFull, a, d);
      if (lane >= d) {
        n += yn;
        a = a > ya ? a : ya;
      }
    }
    int before = __shfl_up_sync(kFull, a, 1);
    if (lane == 0) before = -1;
    piece_first[2 * lane] = n - n0 - n1;
    piece_first[2 * lane + 1] = n - n1;
    piece_prev[2 * lane] = before;
    piece_prev[2 * lane + 1] = before > a0 ? before : a0;
    if (lane == 31) {
      total_s = n;
      last_s = a;
    }
  }
  __syncthreads();
  const int total = total_s, tile_last = last_s;
  unsigned long long* srow = status + b * tiles;
  publish_sum(srow, t, total);
  const long long base = look_back<kThreads>(srow, t, total, scratch,
                                                first_s);
  uint8_t* vrow = values + b * s + base;
  uint16_t* lrow = lengths + b * s + base;
  // each warp's pieces, 32 symbols a step (two segments' masks): lane k
  // scans step k's starts over the piece's steps, to each step's first
  // slot and the last start before it, so that no step waits on another;
  // the starting lanes rank among the step's starts and write at
  // consecutive slots
  const unsigned lower = (1u << lane) - 1u;
  for (int j = 0; j < kRleSegs; ++j) {
    const int pi = j * kRleWarps + warp;
    if (piece_n[pi] == 0) continue;
    const int p0 = kRlePiece * pi;
    const unsigned mk = lane < kRleSteps ? mask_s[p0 / 32 + lane] : 0u;
    int n = __popc(mk);
    int a = mk ? p0 + 32 * lane + 31 - __clz(mk) : -1;
#pragma unroll
    for (int d = 1; d < kRleSteps; d <<= 1) {
      const int yn = __shfl_up_sync(kFull, n, d);
      const int ya = __shfl_up_sync(kFull, a, d);
      if (lane >= d) {
        n += yn;
        a = a > ya ? a : ya;
      }
    }
    const int first_k = piece_first[pi] + n - __popc(mk);
    int prev_k = __shfl_up_sync(kFull, a, 1);
    if (lane == 0 || prev_k < piece_prev[pi]) prev_k = piece_prev[pi];
    uint32_t x[kRleSteps];
#pragma unroll
    for (int k = 0; k < kRleSteps; ++k) x[k] = tile_s[p0 + 32 * k + lane];
#pragma unroll
    for (int k = 0; k < kRleSteps; ++k) {
      const unsigned mask = __shfl_sync(kFull, mk, k);
      if (mask == 0) continue;
      const int r0 = __shfl_sync(kFull, first_k, k);
      const int prev = __shfl_sync(kFull, prev_k, k);
      if (mask >> lane & 1u) {
        const int q = p0 + 32 * k;
        const unsigned below = mask & lower;
        const int p = q + lane;
        const int r = r0 + __popc(below);
        vrow[r] = static_cast<uint8_t>(x[k]);
        if (r > 0) {
          const int before = below ? q + 31 - __clz(below) : prev;
          lrow[r - 1] = static_cast<uint16_t>(p - before);
        }
        if (p == tile_last) lrow[r] = static_cast<uint16_t>(len - p);
      }
    }
  }
  if (tid == 0 && t + 1 == tiles) nruns[b] = base + total;
}

// --------------------------------------------------------- rle expand --

// A tile's run j in shared memory where a thread reads its own 16 runs
// (j = 16 t + m) a step at a time: at [m * stride + t], so that a warp's
// threads touch consecutive entries at each step; `stride` 257 for the
// int32 lengths and 260 for the byte values, whose natural-order writes
// then spread over the banks.
template <int kStride>
__device__ __forceinline__ int col(int j) {
  return (j & 15) * kStride + (j >> 4);
}

// A tile's run end j where neighbouring threads read neighbouring runs:
// in order, one slot skipped every 16, so that a thread's 16 writes of its
// own runs spread over the banks.
__device__ __forceinline__ int slot(int j) { return j + (j >> 4); }

// the first run in [lo, cnt) whose inclusive end is past x, or cnt
__device__ __forceinline__ int first_past(const long long* ends, int lo,
                                          int cnt, long long x) {
  int hi = cnt;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[slot(mid)] > x) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// the bytes [p0, p1) of the 16-byte granule at q of `orow` (16-byte
// aligned): the whole granule at once, else byte by byte
__device__ __forceinline__ void put16(uint8_t* orow, long long q,
                                      long long p0, long long p1,
                                      const Sym16& v) {
  if (p0 == q && p1 == q + 16) {
    *reinterpret_cast<uint4*>(orow + q) = make_uint4(v.w[0], v.w[1], v.w[2],
                                                     v.w[3]);
  } else {
    for (long long pos = p0; pos < p1; ++pos) {
      orow[pos] = static_cast<uint8_t>(sym_at(v, static_cast<int>(pos - q)));
    }
  }
}

constexpr int kLenStage = 16 * 257 * 4 + 16;   // col<257> lengths, aligned
constexpr int kBig = kExpTile * 17 / 16 * 8 + 16;   // slot() ends
constexpr int kOutBytes = kBig - 32;          // a tile's bytes in shared
static_assert(kBig >= kLenStage + kExpTile * 4 + 16,
              "the lengths are staged where the ends go");

__global__ void __launch_bounds__(kExpThreads)
rle_expand_kernel(const uint8_t* __restrict__ values,
                  const int32_t* __restrict__ lengths, long long r, int tiles,
                  int slices, long long tickets,
                  unsigned long long* __restrict__ status,
                  unsigned long long* __restrict__ ticket,
                  uint8_t* __restrict__ out, long long n) {
  // big: the staged lengths (after kLenStage) and their col<257> copy,
  // both read out before it holds the tile's inclusive run ends (int64, by
  // slot()) or its bytes
  __shared__ __align__(16) uint8_t big[kBig];
  __shared__ __align__(16) uint8_t vals_s[kExpTile + 16];
  __shared__ uint8_t vals_c[16 * 260];
  __shared__ long long scratch[32];
  __shared__ int first_s[kLookWidth * kLookThreads / 32];
  __shared__ long long ticket_s, prefix_s;
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x;
  if (tid == 0) {
    ticket_s = static_cast<long long>(atomicAdd(ticket, 1ull));
    mbar_init(&bar);
  }
  __syncthreads();
  const long long tk = ticket_s;
  if (tk >= tickets) return;
  const int slice = static_cast<int>(tk % slices);
  const long long row_tile = tk / slices;
  const int t = static_cast<int>(row_tile % tiles);
  const long long b = row_tile / tiles;
  const long long j0 = static_cast<long long>(t) * kExpTile;
  const int cnt = static_cast<int>(r - j0 < kExpTile ? r - j0 : kExpTile);
  const Stage sl = stage_plan(lengths + b * r + j0, 4 * cnt);
  const Stage sv = stage_plan(values + b * r + j0, cnt);
  uint8_t* len_dst = big + kLenStage;
  if (tid == 0) {
    mbar_arrive_tx(&bar, sl.body + sv.body);
    stage_body(len_dst, sl, &bar);
    stage_body(vals_s, sv, &bar);
  }
  stage_edges(len_dst, sl);
  stage_edges(vals_s, sv);
  mbar_wait0(&bar);
  __syncthreads();
  // natural order in, col order out: each step a warp's consecutive runs
  const int32_t* lens = reinterpret_cast<const int32_t*>(len_dst + sl.lead);
  int32_t* lens_c = reinterpret_cast<int32_t*>(big);
  for (int i = tid; i < cnt; i += kExpThreads) {
    lens_c[col<257>(i)] = lens[i];
    vals_c[col<260>(i)] = vals_s[sv.lead + i];
  }
  __syncthreads();
  int x[16];
  uint32_t vw[4] = {0, 0, 0, 0};  // the thread's 16 values, 4 a word
  long long sum = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const bool in = tid * 16 + k < cnt;
    x[k] = in ? lens_c[k * 257 + tid] : 0;
    if (in) vw[k >> 2] |= static_cast<uint32_t>(vals_c[k * 260 + tid])
                           << (8 * (k & 3));
    sum += x[k];
  }
  long long tile_sum;
  const long long ex = block_exclusive_scan(sum, scratch, tile_sum);
  unsigned long long* srow = status + b * tiles;
  if (slice == 0) {             // publish, then look back
    publish_sum(srow, t, tile_sum);
    const long long acc = look_back(srow, t, tile_sum, scratch, first_s);
    if (tid == 0) prefix_s = acc;
  } else if (tid == 0) {        // the tile's first slice publishes it
    prefix_s = status_value(status_wait(srow + t, kInc)) - tile_sum;
  }
  __syncthreads();
  const long long prefix = prefix_s;
  long long lo = prefix < 0 ? 0 : prefix;
  long long hi = t + 1 == tiles ? n : prefix + tile_sum;
  if (hi > n) hi = n;
  if (hi <= lo) return;
  uint8_t* orow = out + b * n;
  const uintptr_t base = reinterpret_cast<uintptr_t>(orow);
  if (slices == 1 && prefix >= 0 && hi <= prefix + tile_sum
      && hi - lo <= kOutBytes) {
    // a tile of few bytes: each thread spells out its own runs into shared
    // memory (aligned as the output), then the block stores whole granules
    uint8_t* obuf = big;
    const long long g0 = static_cast<long long>((base + lo) & ~uintptr_t(15))
                         - static_cast<long long>(base);
    long long pos = prefix + ex;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const long long from = pos > lo ? pos : lo;
      const long long to = pos + x[k] < hi ? pos + x[k] : hi;
      const uint8_t v = static_cast<uint8_t>(vw[k >> 2] >> (8 * (k & 3)));
      for (long long q = from; q < to; ++q) obuf[q - g0] = v;
      pos += x[k];
    }
    __syncthreads();
    const long long granules = (hi - g0 + 15) >> 4;
    for (long long gi = tid; gi < granules; gi += kExpThreads) {
      const long long q = g0 + 16 * gi;
      const uint4 u = *reinterpret_cast<const uint4*>(obuf + 16 * gi);
      Sym16 v;
      v.w[0] = u.x;
      v.w[1] = u.y;
      v.w[2] = u.z;
      v.w[3] = u.w;
      put16(orow, q, q > lo ? q : lo, q + 16 < hi ? q + 16 : hi, v);
    }
    return;
  }
  // many bytes (long runs, a slice's share, the row's tail past its total):
  // every byte's run found among the tile's ends
  long long* ends = reinterpret_cast<long long*>(big);
  long long run = ex;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    run += x[k];
    if (tid * 16 + k < cnt) ends[slot(tid * 16 + k)] = run;
  }
  __syncthreads();
  const long long span = hi - lo;
  const long long s_lo = lo + span * slice / slices;
  const long long s_hi = lo + span * (slice + 1) / slices;
  if (s_hi <= s_lo) return;
  const long long g0 = static_cast<long long>((base + s_lo) & ~uintptr_t(15))
                       - static_cast<long long>(base);
  const long long granules = (s_hi - g0 + 15) >> 4;
  const uint8_t* vals = vals_s + sv.lead;
  int j = 0;                    // the run of this thread's last byte so far
  for (long long gi = tid; gi < granules; gi += kExpThreads) {
    const long long q = g0 + 16 * gi;   // the granule's first position
    const long long p0 = q > s_lo ? q : s_lo;
    const long long p1 = q + 16 < s_hi ? q + 16 : s_hi;
    // runs before j end at or before an earlier byte of this thread
    if (j < cnt && ends[slot(j)] <= p0 - prefix) {
      j = first_past(ends, j + 1, cnt, p0 - prefix);
    }
    Sym16 v;
    if (j == cnt || ends[slot(j)] >= p1 - prefix) {
      // one value covers it
      v.w[0] = v.w[1] = v.w[2] = v.w[3] =
          vals[j < cnt ? j : cnt - 1] * 0x01010101u;
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t word = 0;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const long long pos = q + 4 * w + m;
          if (pos >= p0 && pos < p1) {
            while (j < cnt && ends[slot(j)] <= pos - prefix) ++j;
            word |= static_cast<uint32_t>(vals[j < cnt ? j : cnt - 1])
                    << (8 * m);
          }
        }
        v.w[w] = word;
      }
    }
    put16(orow, q, p0, p1, v);
  }
}

// ------------------------------------------------------------ launches --

// the first non-zero of `err` and cudaGetLastError()
inline int first_error(int err) {
  const int e = static_cast<int>(cudaGetLastError());
  return err != 0 ? err : e;
}

inline int keep(int err, int e) { return err != 0 ? err : e; }

inline unsigned blocks_for(long long n, long long per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

// the current device's SMs
int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// the decode's lanes a chunk for `blocks` chunks: 32, doubled while the
// grid would give the SMs fewer than kLaneTarget threads each
int decode_lanes(long long blocks) {
  const int sms = sm_count();
  int lanes = 32;
  while (lanes < kMaxLanes
         && blocks * lanes < static_cast<long long>(sms) * kLaneTarget) {
    lanes *= 2;
  }
  return lanes;
}

// rle_expand's blocks a tile: one for every kSliceBytes of a tile's
// bytes on average, at most kMaxSlices
int expand_slices(long long n, long long tiles) {
  const long long per = tiles > 0 ? n / tiles : 0;
  const long long s = (per + kSliceBytes - 1) / kSliceBytes;
  return static_cast<int>(s < 1 ? 1 : (s > kMaxSlices ? kMaxSlices : s));
}

}  // namespace

extern "C" {

// hist: (rows, 256) int64 and nruns: (rows,) int64; sums: (rows, 258)
// uint64 scratch where a row has more than one cluster (zeroed here), else
// may be null.  One launch (more past kMaxRows rows), and the sums'
// zeroing where it has them.
int lossless_stats(const void* syms, long long rows, long long s, void* hist,
                   void* nruns, void* sums, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tile = stats_tile(rows, s);
  const long long tiles = blocks_for(s, tile);
  const int k = stats_cluster(tiles);
  const long long clusters = (tiles + k - 1) / k;
  if (clusters > 1 && sums == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = 0;
  unsigned long long* sw = static_cast<unsigned long long*>(sums);
  if (clusters > 1) {
    err = static_cast<int>(cudaMemsetAsync(
        sw, 0, rows * 258 * sizeof(unsigned long long), st));
  }
  for (long long r0 = 0; r0 < rows; r0 += kMaxRows) {
    const long long nr = rows - r0 < kMaxRows ? rows - r0 : kMaxRows;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(clusters * k),
                       static_cast<unsigned>(nr));
    cfg.blockDim = dim3(kStatsThreads);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(k);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const uint8_t* sy = static_cast<const uint8_t*>(syms) + r0 * s;
    unsigned long long* h = static_cast<unsigned long long*>(hist) + r0 * 256;
    unsigned long long* nrow = static_cast<unsigned long long*>(nruns) + r0;
    unsigned long long* srow = clusters > 1 ? sw + r0 * 258 : nullptr;
    const int c = static_cast<int>(clusters);
    err = keep(err, static_cast<int>(cudaLaunchKernelEx(
        &cfg, stats_kernel, sy, s, tile, c, h, nrow, srow)));
    err = first_error(err);
  }
  return err;
}

// status: (rows * groups + 1) uint64 scratch (each ticket's word, groups
// = ceil(chunks / pack_group) a row, then the ticket counter), zeroed
// here; chunk_offs: (rows, chunks); total_bits: (rows,); words: (rows,
// cap), cap = s * 16 / 32 + 2, every word written.
// Two launches (more only past 2^31 - 1 blocks).
int huffman_pack(const void* syms, long long rows, long long s,
                 const void* lens_tab, const void* codes_tab, void* status,
                 void* chunk_offs, void* total_bits, void* words,
                 long long cap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long chunks = blocks_for(s, kChunk);
  const int group = pack_group(rows, chunks);
  const long long groups = (chunks + group - 1) / group;
  unsigned long long* sw = static_cast<unsigned long long*>(status);
  const long long tickets = rows * groups;
  int err = static_cast<int>(cudaMemsetAsync(
      sw, 0, (tickets + 1) * sizeof(unsigned long long), st));
  for (long long done = 0; done < tickets;) {
    const long long grid = tickets - done < 0x7FFFFFFFLL ? tickets - done
                                                          : 0x7FFFFFFFLL;
    huff_pack_kernel<<<static_cast<unsigned>(grid), kPackThreads, 0, st>>>(
        static_cast<const uint8_t*>(syms), s,
        static_cast<const long long*>(lens_tab),
        static_cast<const long long*>(codes_tab), static_cast<int>(chunks),
        group, static_cast<int>(groups), tickets, sw, sw + tickets,
        static_cast<long long*>(chunk_offs),
        static_cast<long long*>(total_bits), static_cast<uint32_t*>(words),
        cap);
    err = first_error(err);
    done += grid;
  }
  return err;
}

// words: (rows, n_words) uint32 bits; chunk_offs: (rows, chunks) int64;
// lut_sym, lut_len: (rows, 65536) uint8; primary: (rows, kPrim) uint16
// scratch; walks: 4 uint64 added to (or null); lanes: a chunk's lanes, a
// multiple of 32 up to kMaxLanes, or 0 for decode_lanes'; out: (rows, n)
int huffman_decode(const void* words, long long rows, long long n_words,
                   const void* chunk_offs, int chunks, const void* lut_sym,
                   const void* lut_len, void* primary, void* walks, int lanes,
                   void* out, long long n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long used = blocks_for(n, kChunk);
  if (used > chunks) used = chunks;
  if (lanes == 0) lanes = decode_lanes(used * rows);
  if (lanes < 32 || lanes > kMaxLanes || lanes % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint8_t* ls = static_cast<const uint8_t*>(lut_sym);
  const uint8_t* ll = static_cast<const uint8_t*>(lut_len);
  uint16_t* prim = static_cast<uint16_t*>(primary);
  int err = 0;
  for (long long r0 = 0; r0 < rows; r0 += kMaxRows) {
    const long long nr = rows - r0 < kMaxRows ? rows - r0 : kMaxRows;
    const unsigned y = static_cast<unsigned>(nr);
    huff_primary_kernel<<<dim3(kPrim / 256, y), 256, 0, st>>>(
        ls + r0 * kLut, ll + r0 * kLut, prim + r0 * kPrim);
    err = first_error(err);
    huff_decode_kernel<<<dim3(static_cast<unsigned>(used), y), lanes, 0,
                         st>>>(
        static_cast<const uint32_t*>(words) + r0 * n_words, n_words,
        static_cast<const long long*>(chunk_offs) + r0 * chunks, chunks,
        static_cast<int>(used), prim + r0 * kPrim, ls + r0 * kLut,
        ll + r0 * kLut, static_cast<unsigned long long*>(walks),
        static_cast<uint8_t*>(out) + r0 * n, n);
    err = first_error(err);
  }
  return err;
}

// status: (rows * tiles + 1) uint64 scratch (each tile's word, tiles =
// ceil(s / RLE_BREAK) a row, then the ticket counter), zeroed here;
// values: (rows, s) uint8; lengths: (rows, s) uint16 bits; nruns: (rows,)
// int64.  Blocks of kRleWide threads where every tile fits on the card at
// two blocks an SM, else of kRleNarrow (four an SM).  Two launches (more
// only past 2^31 - 1 blocks).
int rle_scan(const void* syms, long long rows, long long s, void* status,
             void* values, void* lengths, void* nruns, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = blocks_for(s, kRleBreak);
  unsigned long long* words = static_cast<unsigned long long*>(status);
  const long long tickets = rows * tiles;
  const bool wide = tickets <= 2LL * sm_count();
  int err = static_cast<int>(cudaMemsetAsync(
      words, 0, (tickets + 1) * sizeof(unsigned long long), st));
  for (long long done = 0; done < tickets;) {
    const long long grid = tickets - done < 0x7FFFFFFFLL ? tickets - done
                                                          : 0x7FFFFFFFLL;
    const unsigned g = static_cast<unsigned>(grid);
    const uint8_t* sy = static_cast<const uint8_t*>(syms);
    uint8_t* va = static_cast<uint8_t*>(values);
    uint16_t* le = static_cast<uint16_t*>(lengths);
    long long* nr = static_cast<long long*>(nruns);
    const int nt = static_cast<int>(tiles);
    if (wide) {
      rle_scan_kernel<kRleWide, 2><<<g, kRleWide, 0, st>>>(
          sy, s, nt, tickets, words, words + tickets, va, le, nr);
    } else {
      rle_scan_kernel<kRleNarrow, 4><<<g, kRleNarrow, 0, st>>>(
          sy, s, nt, tickets, words, words + tickets, va, le, nr);
    }
    err = first_error(err);
    done += grid;
  }
  return err;
}

// values: (rows, r) uint8; lengths: (rows, r) int32; status: (rows *
// ceil(r / kExpTile) + 1) uint64 scratch (the tiles' words, then the
// ticket counter), zeroed here; slices: blocks a tile, or 0 for
// expand_slices'; out: (rows, n).  Two launches (more only past 2^31 - 1
// blocks).
int rle_expand(const void* values, const void* lengths, long long rows,
               long long r, void* status, int slices, void* out, long long n,
               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = blocks_for(r, kExpTile);
  if (slices == 0) slices = expand_slices(n, tiles);
  if (slices < 1 || slices > kMaxSlices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned long long* words = static_cast<unsigned long long*>(status);
  const long long tickets = rows * tiles * slices;
  int err = static_cast<int>(cudaMemsetAsync(
      words, 0, (rows * tiles + 1) * sizeof(unsigned long long), st));
  for (long long done = 0; done < tickets;) {
    const long long grid = tickets - done < 0x7FFFFFFFLL ? tickets - done
                                                          : 0x7FFFFFFFLL;
    rle_expand_kernel<<<static_cast<unsigned>(grid), kExpThreads, 0, st>>>(
        static_cast<const uint8_t*>(values),
        static_cast<const int32_t*>(lengths), r, static_cast<int>(tiles),
        slices, tickets, words, words + rows * tiles,
        static_cast<uint8_t*>(out), n);
    err = first_error(err);
    done += grid;
  }
  return err;
}

}  // extern "C"
