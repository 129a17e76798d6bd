// K2: sorted-intersection join counts, for Hopper (sm_90a).
//
// Replaces the Pallas kernel hyperspace_tpu/ops/kernels.py:_build_smj_call
// (pl.pallas_call at :549). For every left key and an ascending right key
// array it computes lt = #right < key and eq = #right == key: the
// [lt, lt + eq) match range of a sort-merge join.
//
// The host plan is the reference's (ops/kernels.py:_plan_sorted_intersect):
// keys are jointly narrowed to int32, left keys are cut into tiles of 1024,
// and each tile t gets the run of right tiles [s_tile[t], s_tile[t] +
// span[t]) (1024 keys each) that its [min, max] range can match, plus
// base[t] = 1024 * s_tile[t], the count of right keys wholly below that
// run. Tiles the plan marks wide arrive with span 0 and are fixed up on
// the host, exactly as in the reference.
//
// The TPU kernel walked the span with a (left tile x span) grid and a
// dense VPU compare of every key against every right key of the span
// (the VPU has no gather, so binary search was the wrong shape there).
// Hopper gathers freely, so each thread binary-searches its key within
// its tile's span instead: lower and upper bound over span * 1024 sorted
// keys, O(log) compares in place of O(span * 1024). Both count the same
// keys, so lt = base + (lower bound - run start) and eq = upper - lower
// equal the reference bit for bit. All threads of a block search the same
// run (one left tile = 1024 consecutive keys = 4 blocks of 256), so the
// run's upper search levels stay in L1/L2.
//
// Bound: memory. The function must read the left keys and the right keys
// once and write two int32 per left key; the searches do about
// 2 * log2(span * 1024) compares per key, a few operations per byte
// moved — far below the card's compute rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kTile = 1024;

__global__ void sorted_intersect_kernel(const int32_t* __restrict__ l,
                                        const int32_t* __restrict__ r,
                                        const int32_t* __restrict__ s_tile,
                                        const int32_t* __restrict__ span,
                                        const int32_t* __restrict__ base,
                                        long long n_l, int32_t* __restrict__ lt,
                                        int32_t* __restrict__ eq) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_l) return;
  const long long t = i / kTile;
  const int32_t sp = __ldg(span + t);
  const int32_t b = __ldg(base + t);
  if (sp <= 0) {
    lt[i] = b;
    eq[i] = 0;
    return;
  }
  const int32_t key = __ldg(l + i);
  const long long start = (long long)__ldg(s_tile + t) * kTile;
  const long long end = start + (long long)sp * kTile;
  long long lo = start, hi = end;
  while (lo < hi) {  // first position with r >= key
    const long long mid = (lo + hi) >> 1;
    if (__ldg(r + mid) < key) lo = mid + 1; else hi = mid;
  }
  const long long lower = lo;
  hi = end;
  while (lo < hi) {  // first position with r > key
    const long long mid = (lo + hi) >> 1;
    if (__ldg(r + mid) <= key) lo = mid + 1; else hi = mid;
  }
  lt[i] = b + (int32_t)(lower - start);
  eq[i] = (int32_t)(lo - lower);
}

}  // namespace

// l: device int32[n_l] (n_l a multiple of 1024), r: device int32[n_r_pad],
// s_tile/span/base: device int32[n_l / 1024]; lt/eq: device int32[n_l].
// Launches on ``stream``; returns the launch's cudaGetLastError().
extern "C" int hs_sorted_intersect(const void* l, const void* r,
                                   const void* s_tile, const void* span,
                                   const void* base, long long n_l, void* lt,
                                   void* eq, void* stream) {
  if (n_l <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n_l + threads - 1) / threads;
  sorted_intersect_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)l, (const int32_t*)r, (const int32_t*)s_tile,
      (const int32_t*)span, (const int32_t*)base, n_l, (int32_t*)lt,
      (int32_t*)eq);
  return (int)cudaGetLastError();
}
