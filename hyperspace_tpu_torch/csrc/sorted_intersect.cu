// K2: sorted-intersection join counts, for Hopper (sm_90a).
//
// Replaces the Pallas kernel hyperspace_tpu/ops/kernels.py:_build_smj_call
// (pl.pallas_call at :549). For every left key and an ascending right key
// array it computes lt = #right < key and eq = #right == key: the
// [lt, lt + eq) match range of a sort-merge join.
//
// The host plan is the reference's (ops/kernels.py:_plan_sorted_intersect):
// keys are jointly narrowed to int32 (real keys then lie in
// [0, INT32_MAX - 2]), both sides are padded with INT32_MAX to whole
// tiles of 1024, and each left tile t gets the run of right tiles
// [s_tile[t], s_tile[t] + span[t]) that its [min, max] range can match,
// plus base[t] = 1024 * s_tile[t], the count of right keys wholly below
// that run. Tiles the plan marks wide arrive with span 0 and are fixed up
// on the host, exactly as in the reference.
//
// Semantics, bit for bit the reference's, for every padded left key l[i]
// in tile t = i / 1024 (pad keys l = INT32_MAX included):
//   span[t] > 0:  lt[i] = base[t] + #{ r[j] <  l[i] : j in the span }
//                 eq[i] =           #{ r[j] == l[i] : j in the span }
//   span[t] == 0: lt[i] = base[t], eq[i] = 0.
// For a pad key that counts the span's real keys in lt and its pads in
// eq, as the TPU kernel's dense compare does.
//
// What bounds it on this card. The function must read l and r once and
// write two int32 per left key, about 13 bytes a key: its byte bound at
// TPC-H SF1 is 0.023 ms. The work in between is a search. In the index
// layout a 1024-key left tile lies in one hash bucket while r is sorted
// globally, so a tile's span holds ~51 right tiles (52,000 keys), of which
// each left key needs one position. The first design, a binary search per
// thread over the span in device memory, took 16 dependent loads per
// bound, the lower ~6 of them a round trip to L2 each, and nothing hid
// them. What remains here is the traffic that no search avoids: the keys
// and counts to and from HBM, one 32-byte sector of r per key from L2
// (each key's answer lies in its own line), and the fence slices; the
// times of each part are in PERF.md (tools/k2_probe.py).
//
// The design moves the search into shared memory and leaves one sector of
// r per key:
//   * a fence array holds every FENCE-th key of the padded r (one fence
//     per 32-byte sector of r), n_r_pad / FENCE int32, built on the card
//     by the second entry below;
//   * one CTA per left tile: 256 threads, 4 keys each (key_at: 32 apart,
//     so each load, store and search step of a warp covers 32 neighbouring
//     keys); span, s_tile and base are read once per thread as broadcasts;
//     all index arithmetic is int32;
//   * the CTA copies its span's slice of fences (at most 64 * 1024 / FENCE
//     = 32 KB) into shared memory with 16-byte cp.async copies, coalesced,
//     where a search through L2 would pull one sector per fence;
//   * each thread searches the slice for #fences < key: its 4 keys
//     interleaved step by step (4 independent chains), each step a load
//     at an immediate offset, a compare and a predicated add, the trip
//     count the same for the whole CTA;
//   * that count names one FENCE-key line of r, read as two 16-byte loads
//     (one sector, one L2 round trip, the thread's 4 keys' loads in
//     flight together); it holds the lower bound and, unless the key's run
//     of equal right keys reaches the next fence, the upper bound too. A
//     run that does (a key equal to a fence value) reads the next line; a
//     run longer than a line searches the slice again for #fences <= key.
// FENCE = 8 was chosen on the card against 16 and 32 (PERF.md): a longer
// line halves the slices but reads two or four sectors of r per key.
//
// K2p (hs_sorted_intersect_packed) is the same function over right keys
// kept FoR-delta packed (ops/bitpack.py:for_spec/pack_for, block 128):
// value i is refs[i / 128] + ((words[i / vpw] >> (i % vpw) * bits) & mask),
// the codes before the plan's narrowing, so the kernel subtracts lo_all
// after the decode; rows at or past n_r read as INT32_MAX, K2's pads. It
// replaces the reference's XLA programs ranges_fn_packed and
// unpack_for_jnp (hyperspace_tpu/exec/join_residency.py:952,
// hyperspace_tpu/ops/bitpack.py:171).
//
// What bounds K2p. Bytes: the left keys, the words, refs and fences read
// once, (lt, eq) written once, 75.8 MB at the join region's shape (TPC-H
// SF1: 6,001,215 lineitem keys in index layout against 1,500,000 order
// keys packed at 9 bits, vpw 2), 0.0226 ms at 3.35 TB/s. K2's way of
// reaching the right keys is what wastes time here: each tile (one hash
// bucket's keys) spans ~51 right tiles of the globally sorted right side,
// so a CTA a tile copies a ~26 KB fence slice from L2 (~150 MB over the
// 5,861 tiles) and each key waits on one L2 round trip for its line.
//
// The design puts the whole right side of a span in shared memory, which
// packing makes possible. A right tile takes 4 * (1024 / vpw + 128 + 8)
// bytes in a window (words, raw fences, refs): 2,592 at vpw 2, the widest
// case (bits <= 16), so the plan's 64-tile span cap needs 165,888 bytes,
// inside the 232,448 a CTA may use; raw keys (4,608 bytes a tile, 294,912
// at the cap) would not fit. The host's group plan (ops/kernels.py:
// plan_k2p_groups) orders the tiles with a span by s_tile and cuts that
// order into groups whose union of spans, the group's window, fits this
// shared memory: tiles of different buckets at the same place in their
// buckets cover almost the same right keys, so ~44 tiles share one window
// of ~62 right tiles at the region's shape. So:
//   * one CTA a group, 1024 threads in four teams of 256; each team takes
//     every fourth tile of the group (four tiles in flight: a window of
//     ~160 KB leaves room for one CTA an SM, and its 32 warps hide the
//     shared-memory search's latency), 4 keys a thread laid out as K2's
//     (key_at), and loads its next tile (span, base, s_tile, keys) into
//     registers while it searches the current one;
//   * one thread brings the window in with three 1-D bulk copies
//     (cp.async.bulk, no register on the way; bulk_copy.cuh): the fences
//     on one mbarrier, the words and refs on a second, so the first
//     tiles' searches start while the words land; meanwhile the CTA loads
//     its first keys. The window's bytes come from L2 (the distinct right
//     side is 3.8 MB), ~23 MB over all windows in place of ~150 MB of
//     slices;
//   * each tile then runs K2's search (span_counts) over its span's fence
//     slice in the window, and reads its line of 8 keys from the window's
//     words and ref, decoded in registers and specialised by vpw (a
//     template chosen once per launch): no key waits on L2;
//   * tiles with span 0 (wide ones, answered on the host) ride in the
//     groups, spread over them, and write base and 0, as K2's do.
// What remains is the HBM stream of keys in and counts out.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"

namespace {

constexpr int TILE = 1024;          // left keys per tile (the plan's tile): one CTA
constexpr int THREADS = 256;        // threads per CTA
constexpr int KEYS = 4;             // left keys per thread, 32 apart (key_at)
constexpr int FENCE = 8;            // right keys per fence: a 32-byte line of r
constexpr int MAX_SPAN_TILES = 64;  // the plan's span cap (SMJ_MAX_SPAN_TILES)
constexpr int MAX_FENCES = MAX_SPAN_TILES * TILE / FENCE;  // the largest slice
static_assert(MAX_FENCES * 4 <= 48 * 1024,
              "the largest slice fits the shared memory a launch gets unasked");
static_assert(THREADS * KEYS == TILE && THREADS % 32 == 0,
              "a CTA covers a left tile at a time, a warp 32 * KEYS keys of it");
static_assert(FENCE % 4 == 0 && TILE % FENCE == 0, "a line of r moves as int4");
constexpr int ilog2(int n) { return n > 1 ? 1 + ilog2(n / 2) : 0; }
constexpr int LOG_MAX_FENCES = ilog2(MAX_FENCES);  // the search's depth
static_assert(MAX_FENCES == 1 << LOG_MAX_FENCES, "the span cap is a power of two");

// K2p's CTA and window (ops/kernels.py mirrors these: k2p_tile_bytes,
// k2p_window_capacity)
constexpr int K2P_THREADS = 1024;    // one CTA a group: 32 warps
constexpr int K2P_IN_FLIGHT = 4;     // tiles a CTA searches at once, one a team
constexpr int K2P_TEAM = K2P_THREADS / K2P_IN_FLIGHT;
constexpr int K2P_KEYS = TILE / K2P_TEAM;  // left keys a thread of a team
constexpr int FOR_BLOCK = 128;             // values a FoR block ref covers
constexpr int K2P_SMEM_MAX = 232448;       // dynamic shared memory a CTA may use (H100)
constexpr int K2P_SMEM_FIXED = 16;         // the window's two mbarriers
static_assert(K2P_TEAM % 32 == 0 && K2P_KEYS * K2P_TEAM == TILE,
              "a team covers a tile at a time, a warp 32 * K2P_KEYS keys of it");
// bytes of one right tile in a window: its packed words, raw fences and
// block refs, each a multiple of 16 (bulk copies move 16-byte units)
__host__ __device__ constexpr int k2p_tile_bytes(int vpw) {
  return 4 * (TILE / vpw + TILE / FENCE + TILE / FOR_BLOCK);
}
static_assert((TILE / 32) % 4 == 0 && (TILE / FENCE) % 4 == 0 && (TILE / FOR_BLOCK) % 4 == 0,
              "each part of a window tile is whole 16-byte units at every vpw");
static_assert(K2P_SMEM_FIXED + MAX_SPAN_TILES * k2p_tile_bytes(2) <= K2P_SMEM_MAX,
              "a window of the largest span fits at vpw 2, the widest packing");

__global__ void __launch_bounds__(256) fence_build_kernel(const int32_t* __restrict__ r,
                                                          long long n_fences,
                                                          int32_t* __restrict__ fences) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n_fences) fences[k] = __ldg(r + k * FENCE);
}

// lt += #(v's keys < x), le += #(v's keys <= x): a compare and a
// predicated add each, where the compiler's selects take twice as many.
__device__ __forceinline__ void count4(int4 v, int x, int& lt, int& le) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.lt.s32 p, %2, %6;\n\t@p add.s32 %0, %0, 1;\n\t"
      "setp.le.s32 p, %2, %6;\n\t@p add.s32 %1, %1, 1;\n\t"
      "setp.lt.s32 p, %3, %6;\n\t@p add.s32 %0, %0, 1;\n\t"
      "setp.le.s32 p, %3, %6;\n\t@p add.s32 %1, %1, 1;\n\t"
      "setp.lt.s32 p, %4, %6;\n\t@p add.s32 %0, %0, 1;\n\t"
      "setp.le.s32 p, %4, %6;\n\t@p add.s32 %1, %1, 1;\n\t"
      "setp.lt.s32 p, %5, %6;\n\t@p add.s32 %0, %0, 1;\n\t"
      "setp.le.s32 p, %5, %6;\n\t@p add.s32 %1, %1, 1;\n\t}"
      : "+r"(lt), "+r"(le)
      : "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(x));
}

// Counts of r's keys below (lt) and up to (le) x in the FENCE-key line
// starting at p: FENCE / 4 16-byte loads.
__device__ __forceinline__ void line_counts(const int32_t* p, int x, int& lt, int& le) {
  lt = le = 0;
#pragma unroll
  for (int q = 0; q < FENCE / 4; ++q) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p) + q);
    count4(v, x, lt, le);
  }
}

// The lines of a span's raw right keys (K2): line k is rw[8k .. 8k + 8).
struct RawLines {
  static constexpr bool kKeyReads = false;  // a key costs a line's L2 round trip
  const int32_t* rw;  // r + s_tile * TILE
  __device__ __forceinline__ void counts(int line, int x, int& lt, int& le) const {
    line_counts(rw + line * FENCE, x, lt, le);
  }
};

// The lines of a span's FoR-packed right keys (K2p), read from the
// group's window in shared memory and decoded in registers: the line's
// block ref and its VPW-specialised word loads.
template <int VPW>
struct PackedLines {
  static_assert(VPW >= 2 && VPW <= 32 && (VPW & (VPW - 1)) == 0, "vpw is a power of two");
  static_assert(FENCE == 8 && FOR_BLOCK % FENCE == 0, "a line lies inside one FoR block");
  static constexpr bool kKeyReads = true;  // a key costs a shared-memory read
  const uint32_t* words;  // the window's words (shared memory)
  const int* refs;        // the window's block refs (shared memory)
  int first;   // the window-relative value index of the span's line 0: (s_tile - w0) * TILE
  int n_real;  // real keys from the window's start on: rows at or past it read as INT32_MAX
  int bits, lo_all;
  // The span's key idx (0 <= idx < the span's keys), decoded.
  __device__ __forceinline__ int key(int idx) const {
    const int i = first + idx;
    const unsigned u = (unsigned)i;
    const unsigned off = (words[u / VPW] >> ((u % VPW) * bits)) & ((1u << bits) - 1u);
    const int v = (int)((unsigned)refs[u / FOR_BLOCK] - (unsigned)lo_all + off);
    return i < n_real ? v : INT32_MAX;
  }
  // The line's 8 offsets f[j] and its block's narrowed ref: key j is
  // ref + f[j]. A word's top lane needs no mask (the bits above it are 0).
  __device__ __forceinline__ unsigned load(int i0, int (&f)[FENCE]) const {
    const unsigned u0 = (unsigned)i0;  // i0 >= 0; unsigned: divisions are shifts
    const unsigned mask = (1u << bits) - 1u;
    if constexpr (VPW == 2) {  // 4 words, 2 keys each: one 16-byte load
      const uint4 q = *reinterpret_cast<const uint4*>(words + u0 / 2);
      const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        f[2 * k] = (int)(w[k] & mask);
        f[2 * k + 1] = (int)(w[k] >> bits);
      }
    } else if constexpr (VPW == 4) {  // 2 words, 4 keys each
      const uint2 q = *reinterpret_cast<const uint2*>(words + u0 / 4);
      const unsigned w[2] = {q.x, q.y};
#pragma unroll
      for (int j = 0; j < FENCE; ++j)
        f[j] = (int)(j % 4 == 3 ? w[j / 4] >> (3 * bits) : (w[j / 4] >> ((j % 4) * bits)) & mask);
    } else {  // one word holds the line, from lane (i0 % VPW) on
      const unsigned w = words[u0 / VPW];
      const int shift0 = (int)(u0 % VPW) * bits;
#pragma unroll
      for (int j = 0; j < FENCE; ++j) f[j] = (int)((w >> (shift0 + j * bits)) & mask);
    }
    // ref - lo_all: the plan's narrowed key, computed unsigned (a pad
    // block's ref may be anything; its rows are masked)
    return (unsigned)refs[u0 / FOR_BLOCK] - (unsigned)lo_all;
  }
  __device__ __forceinline__ void counts(int line, int x, int& lt, int& le) const {
    const int i0 = first + line * FENCE;
    int f[FENCE];
    const unsigned ref = load(i0, f);
    // Branch-free, so the loads of a thread's lines can all be in flight
    // at once. Key j is ref + f[j] < x exactly where f[j] < d = x - ref
    // (both in [0, 2^31 - 1): no overflow), with d clamped into [-1, 2^16]
    // as offsets lie in [0, 2^16). Rows at or past n_real (the line's
    // last `pads`) are packed as offset 0 (pack_for pads with zeros) and
    // read as INT32_MAX: their offset-0 counts come off (below d where
    // d > 0, up to it where d >= 0), and they are up to x only where x is
    // INT32_MAX. A line of pads alone has a stale ref: d wraps, harmless.
    const int d = min(max((int)((unsigned)x - ref), -1), 1 << 16);
    const int pads = min(max(i0 + FENCE - n_real, 0), FENCE);
    lt = le = 0;
    count4(make_int4(f[0], f[1], f[2], f[3]), d, lt, le);
    count4(make_int4(f[4], f[5], f[6], f[7]), d, lt, le);
    lt -= pads * (d > 0);
    le += pads * ((x == INT32_MAX) - (d >= 0));
  }
};

// One search step of size S for a key x whose count c of fences below it
// is held as the shared-memory address a of fence c: c += S where fence
// c + S - 1 < x. Three instructions (a load at an immediate offset, a
// compare, a predicated add), where the compiler's select takes six.
template <int S>
__device__ __forceinline__ void search_step(unsigned& a, int x) {
  asm volatile(
      "{\n\t.reg .s32 v;\n\t.reg .pred p;\n\t"
      "ld.shared.b32 v, [%0+%2];\n\t"
      "setp.lt.s32 p, v, %1;\n\t"
      "@p add.u32 %0, %0, %3;\n\t}"
      : "+r"(a)
      : "r"(x), "n"((S - 1) * 4), "n"(S * 4));
}

// The steps of sizes S, S / 2, .., 1 that lie below top, for each of a
// thread's N keys in turn: N independent chains.
template <int S, int N>
__device__ __forceinline__ void search_steps(unsigned (&a)[N], const int (&x)[N], int top) {
  if (S < top) {
#pragma unroll
    for (int j = 0; j < N; ++j) search_step<S>(a[j], x[j]);
  }
  if constexpr (S > 1) search_steps<S / 2, N>(a, x, top);
}

struct NoWait {
  __device__ __forceinline__ void operator()() const {}
};

// Span-relative bounds of a thread's N keys x over the span's right
// keys (the lines of rl, nf * FENCE keys), whose fences are in
// slice[0 .. nf): lo = #keys < x, hi = #keys <= x. before_lines() runs
// between the fence search and the first line read (K2p: the wait for
// its window's words on the first tile).
template <int N, class Lines, class Wait = NoWait>
__device__ __forceinline__ void span_counts(const int* slice, int nf, const Lines& rl,
                                            const int (&x)[N], int (&lo)[N], int (&hi)[N],
                                            const Wait& before_lines = Wait{}) {
  // 1. c = #fences < x. The first step aligns the range to a power of
  // two, so no later step checks a bound; every thread of the CTA takes
  // the same steps, unrolled (a step's size is an immediate offset of its
  // shared-memory load) and skipped as a whole above the slice's depth.
  const int top = 1 << (31 - __clz(nf));  // largest power of two <= nf
  const int first = nf - top;
  const unsigned at0 = (unsigned)__cvta_generic_to_shared(slice);
  unsigned a[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    a[j] = at0 + 4 * ((first > 0 && slice[first - 1] < x[j]) ? first : 0);
  search_steps<1 << (LOG_MAX_FENCES - 1), N>(a, x, top);
  int c[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c[j] = (a[j] - at0) >> 2;
    c[j] += slice[c[j]] < x[j];  // here c[j] < nf
  }
  before_lines();

  // 2. the line below fence c holds the lower bound (line 0 when c = 0:
  // then all of it is >= x), and the upper bound too unless x's run of
  // equal keys fills the line to its end: one 32-byte sector of r a key,
  // the loads of the thread's N keys in flight together
  int line[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    line[j] = c[j] > 0 ? c[j] - 1 : 0;
    rl.counts(line[j], x[j], lo[j], hi[j]);
    lo[j] += line[j] * FENCE;
    hi[j] += line[j] * FENCE;
  }
  // 3. a run that fills its line and equals the next fence goes on:
  // c2 = #fences <= x is at least line + 2; a run longer than a line
  // searches the slice on from there. Where the lines can hand out one
  // key (K2p's, from shared memory), a run that ends at that fence (the
  // key after it above x: every unique key equal to a fence) takes one
  // key's read in place of the next line's.
#pragma unroll
  for (int j = 0; j < N; ++j) {
    int c2 = line[j] + 2;
    if (hi[j] == c2 * FENCE - FENCE && c2 <= nf && slice[c2 - 1] <= x[j]) {
      if constexpr (Lines::kKeyReads) {
        if (rl.key((c2 - 1) * FENCE + 1) > x[j]) {
          hi[j] = (c2 - 1) * FENCE + 1;
          continue;
        }
      }
      if (c2 < nf && slice[c2] <= x[j]) {
        for (int s = top; s > 0; s >>= 1) {
          const int k = c2 + s;
          if (k <= nf && slice[k - 1] <= x[j]) c2 = k;
        }
      }
      int n_lt, n_le;
      rl.counts(c2 - 1, x[j], n_lt, n_le);
      hi[j] = (c2 - 1) * FENCE + n_le;
    }
  }
}

// Where a thread's key j lies in its tile: a warp takes 128 consecutive
// keys and its lanes' key j are 32 consecutive ones, so one load or store
// moves 128 contiguous bytes, and one search step reads the fences of 32
// neighbouring keys (one broadcast, or words on distinct banks, where the
// tile is sorted, as the index layout keeps it).
__device__ __forceinline__ int key_at(int j) {
  return (threadIdx.x >> 5) * (32 * KEYS) + j * 32 + (threadIdx.x & 31);
}

// A K2 CTA's prologue: it loads the tile's keys, answers a span-0 tile
// (or one over max_span) at once, and copies the fences of the tile's
// span into shared memory. False: the CTA is done.
__device__ __forceinline__ bool tile_prologue(const int32_t* __restrict__ l,
                                              const int32_t* __restrict__ fences,
                                              const int32_t* __restrict__ s_tile,
                                              const int32_t* __restrict__ span,
                                              const int32_t* __restrict__ base, int max_span,
                                              int32_t* __restrict__ lt, int32_t* __restrict__ eq,
                                              int4* slice4, int (&x)[KEYS], int& sp, int& b,
                                              int& s) {
  const long long at = (long long)blockIdx.x * TILE;  // the tile's first key
#pragma unroll
  for (int j = 0; j < KEYS; ++j) x[j] = __ldg(l + at + key_at(j));
  sp = __ldg(span + blockIdx.x);
  b = __ldg(base + blockIdx.x);
  if (sp <= 0 || sp > max_span) {
    // span 0: lt = base, eq = 0 (the reference's initialisation). A span
    // over the launch's max_span (the wrapper passes the plan's largest):
    // -1, an impossible count, marks it instead of a read past the slice.
    const int v = sp <= 0 ? b : -1, e = sp <= 0 ? 0 : -1;
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      lt[at + key_at(j)] = v;
      eq[at + key_at(j)] = e;
    }
    return false;  // the whole CTA: the barrier below is not reached
  }
  s = __ldg(s_tile + blockIdx.x);
  // the span's fences, 16 bytes a thread at a time, straight into shared
  // memory (cp.async: no register holds them on the way)
  const int4* src = reinterpret_cast<const int4*>(fences) + s * (TILE / FENCE / 4);
  const int n4 = sp * (TILE / FENCE / 4);
  const unsigned dst = (unsigned)__cvta_generic_to_shared(slice4);
#pragma unroll 4
  for (int i = threadIdx.x; i < n4; i += THREADS)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst + 16 * i), "l"(src + i));
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  return true;
}

__device__ __forceinline__ void tile_store(int32_t* __restrict__ lt, int32_t* __restrict__ eq,
                                           int b, const int (&lo)[KEYS], const int (&hi)[KEYS]) {
  const long long at = (long long)blockIdx.x * TILE;
#pragma unroll
  for (int j = 0; j < KEYS; ++j) {
    lt[at + key_at(j)] = b + lo[j];
    eq[at + key_at(j)] = hi[j] - lo[j];
  }
}

// One CTA per left tile t: it copies the fences of t's span into shared
// memory, searches them for each of its keys, reads one line of r a key
// and writes the span's counts.
__global__ void __launch_bounds__(THREADS) sorted_intersect_kernel(
    const int32_t* __restrict__ l, const int32_t* __restrict__ r,
    const int32_t* __restrict__ fences, const int32_t* __restrict__ s_tile,
    const int32_t* __restrict__ span, const int32_t* __restrict__ base, int max_span,
    int32_t* __restrict__ lt, int32_t* __restrict__ eq) {
  extern __shared__ int4 slice4[];  // max_span * TILE / FENCE fences
  int x[KEYS], sp, b, s;
  if (!tile_prologue(l, fences, s_tile, span, base, max_span, lt, eq, slice4, x, sp, b, s))
    return;
  int lo[KEYS], hi[KEYS];
  span_counts(reinterpret_cast<const int*>(slice4), sp * (TILE / FENCE), RawLines{r + s * TILE},
              x, lo, hi);
  tile_store(lt, eq, b, lo, hi);
}

// Where a K2p thread's key 0 lies in its team's tile: key_at's layout
// over the team's threads; key j lies 32 * j after it.
__device__ __forceinline__ int team_key0() {
  const int t = threadIdx.x % K2P_TEAM;
  return (t >> 5) * (32 * K2P_KEYS) + (t & 31);
}

// What a team reads of tile order[k] before its search: the tile, its
// span, base and s_tile, and the thread's keys.
struct TeamTile {
  int t, sp, b, s;
  int x[K2P_KEYS];
};

__device__ __forceinline__ void team_load(const int32_t* __restrict__ l,
                                          const int32_t* __restrict__ order,
                                          const int32_t* __restrict__ span,
                                          const int32_t* __restrict__ base,
                                          const int32_t* __restrict__ s_tile, int k,
                                          TeamTile& in) {
  in.t = __ldg(order + k);
  in.sp = __ldg(span + in.t);
  in.b = __ldg(base + in.t);
  in.s = __ldg(s_tile + in.t);
  const int32_t* p = l + (long long)in.t * TILE + team_key0();
#pragma unroll
  for (int j = 0; j < K2P_KEYS; ++j) in.x[j] = __ldg(p + 32 * j);
}

// K2p: one CTA a group g of the group plan (ops/kernels.py:
// plan_k2p_groups): tiles order[group_at[g] .. group_at[g + 1]), whose
// spans lie in the window of right tiles [win_lo[g], win_lo[g] +
// win_len[g]). The window's fences, words and refs are copied into shared
// memory once; each team then answers every K2P_IN_FLIGHT-th tile of the
// group from there. max_window (the launch's largest window, which sized
// the shared memory) and n_r_tiles bound what a window may copy; a tile
// whose span lies outside its group's window comes back as -1s, an
// impossible count.
template <int VPW>
__global__ void __launch_bounds__(K2P_THREADS, 1) sorted_intersect_packed_kernel(
    const int32_t* __restrict__ l, const int32_t* __restrict__ words,
    const int32_t* __restrict__ refs, const int32_t* __restrict__ fences,
    const int32_t* __restrict__ s_tile, const int32_t* __restrict__ span,
    const int32_t* __restrict__ base, const int32_t* __restrict__ order,
    const int32_t* __restrict__ group_at, const int32_t* __restrict__ win_lo,
    const int32_t* __restrict__ win_len, int max_window, int n_r_tiles, int bits, int lo_all,
    int n_r, int32_t* __restrict__ lt, int32_t* __restrict__ eq) {
  extern __shared__ __align__(16) unsigned char win[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(win);
  const int w0 = __ldg(win_lo + blockIdx.x);
  int wn = __ldg(win_len + blockIdx.x);
  if (wn < 0 || wn > max_window || w0 < 0 || w0 > n_r_tiles - wn) wn = 0;
  int* fs = reinterpret_cast<int*>(win + K2P_SMEM_FIXED);       // wn * TILE / FENCE fences
  const uint32_t* ws = reinterpret_cast<const uint32_t*>(fs + wn * (TILE / FENCE));
  const int* rs = reinterpret_cast<const int*>(ws + wn * (TILE / VPW));  // wn * TILE / 128 refs
  if (threadIdx.x == 0 && wn > 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the fences first (bar[0]: the search starts on them), then the words
  // and refs (bar[1]: the line reads wait for them on the first tile)
  if (threadIdx.x == 0 && wn > 0) {
    const int fb = wn * (TILE / FENCE) * 4, wb = wn * (TILE / VPW) * 4;
    const int rb = wn * (TILE / FOR_BLOCK) * 4;
    mbar_expect_tx(bar, fb);
    bulk_copy(fs, fences + (long long)w0 * (TILE / FENCE), fb, bar);
    mbar_expect_tx(bar + 1, wb + rb);
    bulk_copy((void*)ws, words + (long long)w0 * (TILE / VPW), wb, bar + 1);
    bulk_copy((void*)rs, refs + (long long)w0 * (TILE / FOR_BLOCK), rb, bar + 1);
  }
  // the team's first tile loads while the window comes in
  const int end = __ldg(group_at + blockIdx.x + 1);
  int k = __ldg(group_at + blockIdx.x) + (int)(threadIdx.x / K2P_TEAM);
  TeamTile cur;
  if (k < end) team_load(l, order, span, base, s_tile, k, cur);
  if (wn > 0) mbar_wait(bar, 0);
  bool words_in = false;
  const auto wait_words = [&] {
    if (!words_in) {
      mbar_wait(bar + 1, 0);
      words_in = true;
    }
  };
  const int n_real = n_r - w0 * TILE;
  for (; k < end; k += K2P_IN_FLIGHT) {
    // the team's next tile, in flight during this one's search
    TeamTile nxt;
    if (k + K2P_IN_FLIGHT < end) team_load(l, order, span, base, s_tile, k + K2P_IN_FLIGHT, nxt);
    const int sp = cur.sp, b = cur.b, s = cur.s;
    const int(&x)[K2P_KEYS] = cur.x;
    const long long at = (long long)cur.t * TILE + team_key0();  // key j at at + 32 * j
    if (sp <= 0 || s < w0 || s - w0 > wn - sp) {
      // span 0: lt = base, eq = 0 (the reference's initialisation)
      const int v = sp <= 0 ? b : -1, e = sp <= 0 ? 0 : -1;
#pragma unroll
      for (int j = 0; j < K2P_KEYS; ++j) {
        lt[at + 32 * j] = v;
        eq[at + 32 * j] = e;
      }
    } else {
      int lo[K2P_KEYS], hi[K2P_KEYS];
      const PackedLines<VPW> rl{ws, rs, (s - w0) * TILE, n_real, bits, lo_all};
      span_counts(fs + (s - w0) * (TILE / FENCE), sp * (TILE / FENCE), rl, x, lo, hi,
                  wait_words);
#pragma unroll
      for (int j = 0; j < K2P_KEYS; ++j) {
        lt[at + 32 * j] = b + lo[j];
        eq[at + 32 * j] = hi[j] - lo[j];
      }
    }
    cur = nxt;
  }
  // no copy may outlive the CTA (a team whose tiles all lack a span
  // never waited for the words)
  if (threadIdx.x == 0 && wn > 0) mbar_wait(bar + 1, 0);
}

using PackedKernel = void (*)(const int32_t*, const int32_t*, const int32_t*, const int32_t*,
                              const int32_t*, const int32_t*, const int32_t*, const int32_t*,
                              const int32_t*, const int32_t*, const int32_t*, int, int, int,
                              int, int, int32_t*, int32_t*);
// K2p's instantiations by log2(vpw) - 1
const PackedKernel PACKED_KERNELS[5] = {
    sorted_intersect_packed_kernel<2>, sorted_intersect_packed_kernel<4>,
    sorted_intersect_packed_kernel<8>, sorted_intersect_packed_kernel<16>,
    sorted_intersect_packed_kernel<32>};

// Per device, a bit for each instantiation already allowed K2P_SMEM_MAX
// of dynamic shared memory: the attribute is set on first need.
constexpr int MAX_DEVICES = 64;
std::atomic<uint32_t> big_smem_set[MAX_DEVICES];

int allow_big_smem(int which) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const uint32_t bit = 1u << which;
  if (dev < MAX_DEVICES && (big_smem_set[dev].load(std::memory_order_relaxed) & bit)) return 0;
  e = cudaFuncSetAttribute(PACKED_KERNELS[which], cudaFuncAttributeMaxDynamicSharedMemorySize,
                           K2P_SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES) big_smem_set[dev].fetch_or(bit, std::memory_order_relaxed);
  return 0;
}

}  // namespace

// r: device int32[n_r] (n_r a multiple of FENCE); fences: device
// int32[n_r / FENCE], fences[k] = r[k * FENCE]. Launches on ``stream``;
// returns the launch's cudaGetLastError().
extern "C" int hs_sorted_intersect_fences(const void* r, long long n_r, void* fences,
                                          void* stream) {
  const long long n = n_r / FENCE;
  if (n <= 0) return 0;
  fence_build_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)r, n, (int32_t*)fences);
  return (int)cudaGetLastError();
}

// l: device int32[n_l] (n_l a multiple of TILE), r: device int32[n_r_pad]
// (a multiple of TILE, below 2^31), fences: r's fence array,
// s_tile/span/base: device int32[n_l / TILE]; max_span: the largest span
// (at most MAX_SPAN_TILES), which sizes each CTA's shared memory; lt/eq:
// device int32[n_l]. r and fences are 16-byte aligned. Launches on
// ``stream``; returns the launch's cudaGetLastError().
extern "C" int hs_sorted_intersect(const void* l, const void* r, const void* fences,
                                   const void* s_tile, const void* span, const void* base,
                                   long long n_l, int max_span, void* lt, void* eq,
                                   void* stream) {
  if (n_l <= 0) return 0;
  if (max_span < 0 || max_span > MAX_SPAN_TILES) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)max_span * (TILE / FENCE) * sizeof(int);
  sorted_intersect_kernel<<<(unsigned)(n_l / TILE), THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)l, (const int32_t*)r, (const int32_t*)fences, (const int32_t*)s_tile,
      (const int32_t*)span, (const int32_t*)base, max_span, (int32_t*)lt, (int32_t*)eq);
  return (int)cudaGetLastError();
}

// K2p. l, fences, s_tile, span, base, lt, eq as for hs_sorted_intersect
// (n_l = TILE * the tiles of order), n_r_pad = 8 * the fences' length;
// words: device int32 FoR words of the right keys, vpw values a word (2,
// 4, 8, 16 or 32) of ``bits`` bits, at least n_r_pad / vpw of them, the
// rows at or past n_r packed as offset 0 (pack_for's padding); refs:
// device int32 block references, one per 128 keys, at least n_r_pad / 128;
// words, refs and fences 16-byte aligned (bulk copies); lo_all: the plan's
// narrowing, subtracted after the decode; n_r: the real keys. The group
// plan: order (every tile once), group_at (n_groups + 1 offsets into
// order), win_lo/win_len (each group's window of right tiles, each inside
// [0, n_r_pad / TILE)); max_window: the largest win_len, which sizes the
// launch's shared memory (K2P_SMEM_FIXED + max_window *
// k2p_tile_bytes(vpw), at most K2P_SMEM_MAX). Launches on ``stream``;
// returns the launch's cudaGetLastError().
extern "C" int hs_sorted_intersect_packed(const void* l, const void* words, const void* refs,
                                          const void* fences, const void* s_tile,
                                          const void* span, const void* base, const void* order,
                                          const void* group_at, const void* win_lo,
                                          const void* win_len, int n_groups, int max_window,
                                          long long n_r_pad, int vpw, int bits, int lo_all,
                                          long long n_r, void* lt, void* eq, void* stream) {
  if (n_groups <= 0) return 0;
  if (vpw < 2 || vpw > 32 || (vpw & (vpw - 1)) || bits < 1 || bits > 16 || vpw * bits > 32 ||
      n_r < 0 || n_r_pad % TILE || n_r > n_r_pad || n_r_pad >= (1LL << 31) || max_window < 0)
    return (int)cudaErrorInvalidValue;
  const int which = __builtin_ctz((unsigned)vpw) - 1;  // vpw 2 -> 0 .. 32 -> 4
  const long long smem = K2P_SMEM_FIXED + (long long)max_window * k2p_tile_bytes(vpw);
  if (smem > K2P_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const int e = allow_big_smem(which);
    if (e) return e;
  }
  PACKED_KERNELS[which]<<<(unsigned)n_groups, K2P_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int32_t*)l, (const int32_t*)words, (const int32_t*)refs, (const int32_t*)fences,
      (const int32_t*)s_tile, (const int32_t*)span, (const int32_t*)base,
      (const int32_t*)order, (const int32_t*)group_at, (const int32_t*)win_lo,
      (const int32_t*)win_len, max_window, (int)(n_r_pad / TILE), bits, lo_all, (int)n_r,
      (int32_t*)lt, (int32_t*)eq);
  return (int)cudaGetLastError();
}
