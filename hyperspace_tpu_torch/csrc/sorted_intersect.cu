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

#include <cstdint>
#include <cuda_runtime.h>

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
// thread's keys in turn: KEYS independent chains.
template <int S>
__device__ __forceinline__ void search_steps(unsigned (&a)[KEYS], const int (&x)[KEYS], int top) {
  if (S < top) {
#pragma unroll
    for (int j = 0; j < KEYS; ++j) search_step<S>(a[j], x[j]);
  }
  if constexpr (S > 1) search_steps<S / 2>(a, x, top);
}

// Span-relative bounds of a thread's KEYS keys x over the right keys
// rw[0 .. nf * FENCE), whose fences are in slice[0 .. nf):
// lo = #rw < x, hi = #rw <= x.
__device__ __forceinline__ void span_counts(const int* slice, int nf, const int32_t* rw,
                                            const int (&x)[KEYS], int (&lo)[KEYS],
                                            int (&hi)[KEYS]) {
  // 1. c = #fences < x. The first step aligns the range to a power of
  // two, so no later step checks a bound; every thread of the CTA takes
  // the same steps, unrolled (a step's size is an immediate offset of its
  // shared-memory load) and skipped as a whole above the slice's depth.
  const int top = 1 << (31 - __clz(nf));  // largest power of two <= nf
  const int first = nf - top;
  const unsigned at0 = (unsigned)__cvta_generic_to_shared(slice);
  unsigned a[KEYS];
#pragma unroll
  for (int j = 0; j < KEYS; ++j)
    a[j] = at0 + 4 * ((first > 0 && slice[first - 1] < x[j]) ? first : 0);
  search_steps<1 << (LOG_MAX_FENCES - 1)>(a, x, top);
  int c[KEYS];
#pragma unroll
  for (int j = 0; j < KEYS; ++j) {
    c[j] = (a[j] - at0) >> 2;
    c[j] += slice[c[j]] < x[j];  // here c[j] < nf
  }

  // 2. the line below fence c holds the lower bound (line 0 when c = 0:
  // then all of it is >= x), and the upper bound too unless x's run of
  // equal keys fills the line to its end: one 32-byte sector of r a key,
  // the loads of the thread's KEYS keys in flight together
  int line[KEYS];
#pragma unroll
  for (int j = 0; j < KEYS; ++j) {
    line[j] = c[j] > 0 ? c[j] - 1 : 0;
    line_counts(rw + line[j] * FENCE, x[j], lo[j], hi[j]);
    lo[j] += line[j] * FENCE;
    hi[j] += line[j] * FENCE;
  }
  // 3. a run that fills its line and equals the next fence goes on:
  // c2 = #fences <= x is at least line + 2; a run longer than a line
  // searches the slice on from there
#pragma unroll
  for (int j = 0; j < KEYS; ++j) {
    int c2 = line[j] + 2;
    if (hi[j] == c2 * FENCE - FENCE && c2 <= nf && slice[c2 - 1] <= x[j]) {
      if (c2 < nf && slice[c2] <= x[j]) {
        for (int s = top; s > 0; s >>= 1) {
          const int k = c2 + s;
          if (k <= nf && slice[k - 1] <= x[j]) c2 = k;
        }
      }
      int n_lt, n_le;
      line_counts(rw + (c2 - 1) * FENCE, x[j], n_lt, n_le);
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

// One CTA per left tile t: it copies the fences of t's span into shared
// memory, searches them for each of its keys, reads one line of r a key
// and writes the span's counts.
__global__ void __launch_bounds__(THREADS) sorted_intersect_kernel(
    const int32_t* __restrict__ l, const int32_t* __restrict__ r,
    const int32_t* __restrict__ fences, const int32_t* __restrict__ s_tile,
    const int32_t* __restrict__ span, const int32_t* __restrict__ base, int max_span,
    int32_t* __restrict__ lt, int32_t* __restrict__ eq) {
  extern __shared__ int4 slice4[];  // max_span * TILE / FENCE fences
  const long long at = (long long)blockIdx.x * TILE;  // the tile's first key
  int x[KEYS];
#pragma unroll
  for (int j = 0; j < KEYS; ++j) x[j] = __ldg(l + at + key_at(j));
  const int sp = __ldg(span + blockIdx.x), b = __ldg(base + blockIdx.x);
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
    return;  // the whole CTA: the barrier below is not reached
  }
  const int s = __ldg(s_tile + blockIdx.x);
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
  int lo[KEYS], hi[KEYS];
  span_counts(reinterpret_cast<const int*>(slice4), sp * (TILE / FENCE), r + s * TILE, x, lo, hi);
#pragma unroll
  for (int j = 0; j < KEYS; ++j) {
    lt[at + key_at(j)] = b + lo[j];
    eq[at + key_at(j)] = hi[j] - lo[j];
  }
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
