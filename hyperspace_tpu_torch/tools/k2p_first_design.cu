// K2p's first design, kept for tools/k2_probe.py to time beside the
// current one (csrc/sorted_intersect.cu): the probe builds it on its own.
// One CTA a left tile, as K2: the CTA copies its span's fence slice into
// shared memory with cp.async, searches it, and reads each key's line of
// 8 right keys from device memory (the block ref and 8 / vpw packed
// words, decoded in registers, specialised by vpw). Its entry,
// hs_sorted_intersect_packed, takes K2's per-tile plan and the largest
// span, which sizes each CTA's shared memory.

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

// The lines of a span's FoR-packed right keys (K2p), decoded in
// registers: the line's block ref and its VPW-specialised word loads.
template <int VPW>
struct PackedLines {
  static_assert(VPW >= 2 && VPW <= 32 && (VPW & (VPW - 1)) == 0, "vpw is a power of two");
  static_assert(FENCE == 8 && 128 % FENCE == 0, "a line lies inside one FoR block");
  const int32_t* words;
  const int32_t* refs;
  int first;  // the value index of the span's line 0: s_tile * TILE (< 2^31)
  int n_r;    // real keys; rows at or past it read as INT32_MAX
  int bits, lo_all;
  __device__ __forceinline__ void counts(int line, int x, int& lt, int& le) const {
    const int i0 = first + line * FENCE;
    // ref - lo_all + offset: the plan's narrowed key, computed unsigned
    // (a pad block's ref may be anything; its rows are masked below)
    const unsigned ref = (unsigned)__ldg(refs + (i0 >> 7)) - (unsigned)lo_all;
    const unsigned mask = (1u << bits) - 1u;
    unsigned off[FENCE];
    if constexpr (VPW == 2) {  // 4 words, 2 keys each
      const int4 q = __ldg(reinterpret_cast<const int4*>(words + (i0 >> 1)));
      const unsigned w[4] = {(unsigned)q.x, (unsigned)q.y, (unsigned)q.z, (unsigned)q.w};
#pragma unroll
      for (int j = 0; j < FENCE; ++j) off[j] = (w[j / 2] >> ((j % 2) * bits)) & mask;
    } else if constexpr (VPW == 4) {  // 2 words, 4 keys each
      const int2 q = __ldg(reinterpret_cast<const int2*>(words + (i0 >> 2)));
      const unsigned w[2] = {(unsigned)q.x, (unsigned)q.y};
#pragma unroll
      for (int j = 0; j < FENCE; ++j) off[j] = (w[j / 4] >> ((j % 4) * bits)) & mask;
    } else {  // one word holds the line, from lane (i0 % VPW) on
      const unsigned w = (unsigned)__ldg(words + i0 / VPW);
      const int shift0 = (int)(i0 % VPW) * bits;
#pragma unroll
      for (int j = 0; j < FENCE; ++j) off[j] = (w >> (shift0 + j * bits)) & mask;
    }
    int v[FENCE];
#pragma unroll
    for (int j = 0; j < FENCE; ++j) v[j] = i0 + j < n_r ? (int)(ref + off[j]) : INT32_MAX;
    lt = le = 0;
    count4(make_int4(v[0], v[1], v[2], v[3]), x, lt, le);
    count4(make_int4(v[4], v[5], v[6], v[7]), x, lt, le);
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
// thread's keys in turn: KEYS independent chains.
template <int S>
__device__ __forceinline__ void search_steps(unsigned (&a)[KEYS], const int (&x)[KEYS], int top) {
  if (S < top) {
#pragma unroll
    for (int j = 0; j < KEYS; ++j) search_step<S>(a[j], x[j]);
  }
  if constexpr (S > 1) search_steps<S / 2>(a, x, top);
}

// Span-relative bounds of a thread's KEYS keys x over the span's right
// keys (the lines of rl, nf * FENCE keys), whose fences are in
// slice[0 .. nf): lo = #keys < x, hi = #keys <= x.
template <class Lines>
__device__ __forceinline__ void span_counts(const int* slice, int nf, const Lines& rl,
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
    rl.counts(line[j], x[j], lo[j], hi[j]);
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

// A CTA's prologue: it loads the tile's
// keys, answers a span-0 tile (or one over max_span) at once, and copies
// the fences of the tile's span into shared memory. False: the CTA is done.
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

// K2p: K2 over FoR-packed right keys (words, refs), VPW values a word.
template <int VPW>
__global__ void __launch_bounds__(THREADS) sorted_intersect_packed_kernel(
    const int32_t* __restrict__ l, const int32_t* __restrict__ words,
    const int32_t* __restrict__ refs, const int32_t* __restrict__ fences,
    const int32_t* __restrict__ s_tile, const int32_t* __restrict__ span,
    const int32_t* __restrict__ base, int max_span, int bits, int lo_all, int n_r,
    int32_t* __restrict__ lt, int32_t* __restrict__ eq) {
  extern __shared__ int4 slice4[];
  int x[KEYS], sp, b, s;
  if (!tile_prologue(l, fences, s_tile, span, base, max_span, lt, eq, slice4, x, sp, b, s))
    return;
  int lo[KEYS], hi[KEYS];
  const PackedLines<VPW> rl{words, refs, s * TILE, n_r, bits, lo_all};
  span_counts(reinterpret_cast<const int*>(slice4), sp * (TILE / FENCE), rl, x, lo, hi);
  tile_store(lt, eq, b, lo, hi);
}

}  // namespace

// K2p. l, fences, s_tile, span, base, max_span, lt, eq as for
// hs_sorted_intersect, n_r_pad = 8 * the fences' length; words: device
// int32 FoR words of the right keys, vpw values a word (2, 4, 8, 16 or
// 32) of ``bits`` bits, at least n_r_pad / vpw of them (16-byte
// aligned); refs: device int32 block references, one per 128 keys, at
// least n_r_pad / 128; lo_all: the plan's narrowing, subtracted after the
// decode; n_r: the real keys. Launches on ``stream``; returns the
// launch's cudaGetLastError().
extern "C" int hs_sorted_intersect_packed(const void* l, const void* words, const void* refs,
                                          const void* fences, const void* s_tile,
                                          const void* span, const void* base, long long n_l,
                                          int max_span, int vpw, int bits, int lo_all,
                                          long long n_r, void* lt, void* eq, void* stream) {
  if (n_l <= 0) return 0;
  if (max_span < 0 || max_span > MAX_SPAN_TILES || bits < 1 || bits > 16 || vpw * bits > 32 ||
      n_r < 0 || n_r >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)max_span * (TILE / FENCE) * sizeof(int);
  const dim3 grid((unsigned)(n_l / TILE));
  const auto L = (const int32_t*)l;
  const auto W = (const int32_t*)words;
  const auto R = (const int32_t*)refs;
  const auto F = (const int32_t*)fences;
  const auto S = (const int32_t*)s_tile;
  const auto P = (const int32_t*)span;
  const auto B = (const int32_t*)base;
  const auto st = (cudaStream_t)stream;
  switch (vpw) {
    case 2:
      sorted_intersect_packed_kernel<2><<<grid, THREADS, smem, st>>>(
          L, W, R, F, S, P, B, max_span, bits, lo_all, (int)n_r, (int32_t*)lt, (int32_t*)eq);
      break;
    case 4:
      sorted_intersect_packed_kernel<4><<<grid, THREADS, smem, st>>>(
          L, W, R, F, S, P, B, max_span, bits, lo_all, (int)n_r, (int32_t*)lt, (int32_t*)eq);
      break;
    case 8:
      sorted_intersect_packed_kernel<8><<<grid, THREADS, smem, st>>>(
          L, W, R, F, S, P, B, max_span, bits, lo_all, (int)n_r, (int32_t*)lt, (int32_t*)eq);
      break;
    case 16:
      sorted_intersect_packed_kernel<16><<<grid, THREADS, smem, st>>>(
          L, W, R, F, S, P, B, max_span, bits, lo_all, (int)n_r, (int32_t*)lt, (int32_t*)eq);
      break;
    case 32:
      sorted_intersect_packed_kernel<32><<<grid, THREADS, smem, st>>>(
          L, W, R, F, S, P, B, max_span, bits, lo_all, (int)n_r, (int32_t*)lt, (int32_t*)eq);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
