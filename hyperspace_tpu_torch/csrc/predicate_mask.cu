// K1: predicate mask over int32 columns, for Hopper (sm_90a).
//
// Replaces the Pallas kernel hyperspace_tpu/ops/kernels.py:_build_mask_call
// (pl.pallas_call at :237), which traced the bound predicate into one
// program per (predicate, literal values, shape) and streamed (256, 128)
// int32 tiles of every referenced column through VMEM.
//
// Here the host lowers the narrowed predicate once into a postfix program
// of 4-int32 instructions (ops/kernels.py:lower_predicate), so ONE build
// serves every predicate and every literal:
//
//   {OP_CMP_LIT, col, cmp, literal}   push  cols[col][row] <cmp> literal
//   {OP_CMP_COL, col, cmp, col2}      push  cols[col][row] <cmp> cols[col2][row]
//   {OP_AND, 0, 0, 0} / {OP_OR, ...}  pop two, push their and / or
//   {OP_NOT, 0, 0, 0}                 negate the top
//
// Each thread evaluates the program for its rows (grid-stride) on a bit
// stack held in one 64-bit register and writes one uint8 per row. The
// lowering emits the deeper operand of every AND/OR first, so a tree of
// n leaves needs at most log2(n) + 1 stack slots.
//
// Bound: memory. Per row the kernel must read 4 bytes of every referenced
// column and write 1 byte of mask; the compares are a few integer
// operations per byte moved, far below the card's compute rate. The
// design keeps it one pass: consecutive threads read consecutive rows
// (coalesced), every instruction word is uniform across a warp (one
// cached broadcast load), and no intermediate mask touches device memory.
//
// K1c (hs_predicate_block_counts) replaces the Pallas arm of
// hyperspace_tpu/exec/hbm_cache.py:_counts_fn (:476-483), which ran the
// mask kernel over the HBM-resident planes and summed the mask per
// 8192-row block in the same executable. Here the interpreter above is
// shared and the block sum is fused into the kernel, so only the count
// vector (4 B per 8192 rows) is written. Bound: memory — 4 B per plane per
// padded row read once, 4 B per block written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum : int32_t { OP_CMP_LIT = 0, OP_CMP_COL = 1, OP_AND = 2, OP_OR = 3, OP_NOT = 4 };
enum : int32_t { CMP_EQ = 0, CMP_NE = 1, CMP_LT = 2, CMP_LE = 3, CMP_GT = 4, CMP_GE = 5 };

__device__ __forceinline__ uint64_t compare(int32_t x, int32_t op, int32_t y) {
  switch (op) {
    case CMP_EQ: return x == y;
    case CMP_NE: return x != y;
    case CMP_LT: return x < y;
    case CMP_LE: return x <= y;
    case CMP_GT: return x > y;
    default: return x >= y;
  }
}

// The postfix interpreter for one row, shared by both kernels: the bit
// stack lives in one 64-bit register; the lowering keeps it shallow.
__device__ __forceinline__ bool eval_row(const int32_t* const* __restrict__ cols,
                                         const int32_t* __restrict__ prog,
                                         int n_instr, long long row) {
  uint64_t stack = 0;
  for (int i = 0; i < n_instr; ++i) {
    const int32_t opc = __ldg(prog + 4 * i);
    const int32_t a = __ldg(prog + 4 * i + 1);
    const int32_t b = __ldg(prog + 4 * i + 2);
    const int32_t c = __ldg(prog + 4 * i + 3);
    if (opc == OP_CMP_LIT) {
      stack = (stack << 1) | compare(__ldg(cols[a] + row), b, c);
    } else if (opc == OP_CMP_COL) {
      stack = (stack << 1) |
              compare(__ldg(cols[a] + row), b, __ldg(cols[c] + row));
    } else if (opc == OP_NOT) {
      stack ^= 1ull;
    } else {
      const uint64_t top = stack & 1ull;
      stack >>= 1;
      const uint64_t v = (opc == OP_AND) ? (top & stack) : (top | stack);
      stack = (stack & ~1ull) | (v & 1ull);
    }
  }
  return (stack & 1ull) != 0;
}

__global__ void predicate_mask_kernel(const int32_t* const* __restrict__ cols,
                                      const int32_t* __restrict__ prog,
                                      int n_instr, long long n_rows,
                                      uint8_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n_rows; row += stride) {
    out[row] = (uint8_t)eval_row(cols, prog, n_instr, row);
  }
}

// K1c: the same predicate, reduced to one int32 match count per block of
// BLOCK_ROWS rows. One CTA per block; each thread evaluates ROWS_AT_ONCE
// rows per pass (independent loads in flight), a warp counts its matches
// with __ballot_sync + __popc, and the CTA sums its warps' counts in
// shared memory. Thread 0 writes counts[blockIdx.x]: no mask ever reaches
// device memory, no atomics, and the result is deterministic.
constexpr int BLOCK_ROWS = 8192;
constexpr int COUNT_THREADS = 256;
constexpr int ROWS_AT_ONCE = 4;

__global__ void __launch_bounds__(COUNT_THREADS)
predicate_block_counts_kernel(const int32_t* const* __restrict__ cols,
                              const int32_t* __restrict__ prog, int n_instr,
                              int32_t* __restrict__ counts) {
  __shared__ int warp_counts[COUNT_THREADS / 32];
  const long long base = (long long)blockIdx.x * BLOCK_ROWS;
  int mine = 0;  // this warp's matches (kept by every lane alike)
  for (int r0 = threadIdx.x; r0 < BLOCK_ROWS;
       r0 += COUNT_THREADS * ROWS_AT_ONCE) {
    bool hit[ROWS_AT_ONCE];
#pragma unroll
    for (int k = 0; k < ROWS_AT_ONCE; ++k) {
      hit[k] = eval_row(cols, prog, n_instr, base + r0 + k * COUNT_THREADS);
    }
#pragma unroll
    for (int k = 0; k < ROWS_AT_ONCE; ++k) {
      mine += __popc(__ballot_sync(0xffffffffu, hit[k]));
    }
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) warp_counts[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < COUNT_THREADS / 32; ++w) total += warp_counts[w];
    counts[blockIdx.x] = total;
  }
}

static_assert(BLOCK_ROWS % (COUNT_THREADS * ROWS_AT_ONCE) == 0,
              "a CTA's passes must tile its block exactly");

}  // namespace

// cols: device array of n column pointers; prog: device int32[4 * n_instr];
// out: device uint8[n_rows]. Launches on ``stream``; returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int hs_predicate_mask(const void* cols, const void* prog, int n_instr,
                                 long long n_rows, void* out, void* stream) {
  if (n_rows <= 0) return 0;
  const int threads = 256;
  long long blocks = (n_rows + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  predicate_mask_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t* const*)cols, (const int32_t*)prog, n_instr, n_rows,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

// cols: device array of n column pointers, each n_rows_padded int32;
// prog: device int32[4 * n_instr]; counts: device int32[n_rows_padded /
// 8192]. n_rows_padded must be a positive multiple of 8192 (the caller
// zero-pads its resident planes so). Launches on ``stream``; returns the
// launch's cudaGetLastError() (0 on success).
extern "C" int hs_predicate_block_counts(const void* cols, const void* prog,
                                         int n_instr, long long n_rows_padded,
                                         void* counts, void* stream) {
  if (n_rows_padded <= 0) return 0;
  if (n_rows_padded % BLOCK_ROWS) return (int)cudaErrorInvalidValue;
  const long long blocks = n_rows_padded / BLOCK_ROWS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  predicate_block_counts_kernel<<<(unsigned)blocks, COUNT_THREADS, 0,
                                  (cudaStream_t)stream>>>(
      (const int32_t* const*)cols, (const int32_t*)prog, n_instr,
      (int32_t*)counts);
  return (int)cudaGetLastError();
}
