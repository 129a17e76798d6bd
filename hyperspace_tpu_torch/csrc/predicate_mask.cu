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
// Bound: memory. Per row the kernel must read 4 bytes of every referenced
// column and write 1 byte of mask (K1) or nothing but a count per 8192 rows
// (K1c); the compares are a few integer operations per byte moved. The
// design keeps the instruction stream far below that:
//
// * The program and the column addresses travel in the launch's parameter
//   block (struct Params, __grid_constant__), so no host->device copy
//   precedes a launch and every warp-uniform read of an instruction or an
//   address comes from the constant bank. A program longer than
//   MAX_PARAM_INSTR is uploaded once by the caller (Params::staged) and
//   each CTA stages it in shared memory before it starts. A predicate over
//   more than MAX_COLS columns gets its addresses from a device array
//   instead (Params::col_table, copied by the caller for that launch).
// * One decode serves 32 rows: each thread owns the 32 rows
//   tile + k*128 + lane*4 + j (k < 8, j < 4), bit 4k + j of a 32-bit word,
//   and reads a column as eight 16-byte loads; a warp's load covers 512
//   contiguous bytes. A compare yields a word; AND / OR / NOT are single
//   word operations.
// * Where the program names at most 4 columns, every column's 32 values
//   are loaded into registers before the first instruction (all loads in
//   flight at once) and a column compared twice is read once, by both
//   program sources. A program over more columns loads per compare (a
//   second read of a row hits L1).
// * The evaluation stack holds 32-bit words: the top two in registers, the
//   rest in shared memory laid out [slot][thread] (conflict-free, no
//   runtime-indexed register array, so nothing goes to local memory). The
//   caller sizes it to the program's exact peak (at most 64 slots).
//
// K1 writes each thread's 32 mask bytes as eight 4-byte stores (128
// contiguous bytes per warp store); a ragged last tile loads and stores
// element by element.
//
// K1c (hs_predicate_block_counts) replaces the Pallas arm of
// hyperspace_tpu/exec/hbm_cache.py:_counts_fn (:476-483), which ran the
// mask kernel over the HBM-resident planes and summed the mask per
// 8192-row block in the same executable. One CTA of 256 threads x 32 rows
// covers one block in one pass: __popc of each thread's word, a warp sum
// (__reduce_add_sync), a shared-memory sum of the 8 warps. No atomics,
// deterministic; only the count vector (4 B per 8192 rows) is written.

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum : int32_t { OP_CMP_LIT = 0, OP_CMP_COL = 1, OP_AND = 2, OP_OR = 3, OP_NOT = 4 };
enum : int32_t { CMP_EQ = 0, CMP_NE = 1, CMP_LT = 2, CMP_LE = 3, CMP_GT = 4, CMP_GE = 5 };

constexpr int MAX_COLS = 16;
constexpr int MAX_PARAM_INSTR = 240;
constexpr int STACK_SLOTS = 64;
constexpr int MAX_CACHED_COLS = 4;
constexpr int ROWS_PER_THREAD = 32;
constexpr int WARP_ROWS = 32 * ROWS_PER_THREAD;  // 1024
constexpr int K1_THREADS = 128;                  // 4096 rows per CTA
constexpr int K1_SMALL_THREADS = 32;             // 1024 rows per CTA
constexpr long long K1_SMALL_BELOW = 2LL * 132 * K1_THREADS * ROWS_PER_THREAD;
constexpr int BLOCK_ROWS = 8192;
constexpr int COUNT_THREADS = BLOCK_ROWS / ROWS_PER_THREAD;  // 256
// dynamic shared memory a launch may ask for (H100: 232,448 B per block,
// less a margin for the kernels' static shared memory)
constexpr int MAX_DYN_SMEM = 232448 - 1024;

// The launch's parameter block. ops/kernels.py:_PARAM_DTYPE mirrors this
// layout field by field; hs_predicate_param_bytes() lets it check.
struct Params {
  int4 prog[MAX_PARAM_INSTR];       // the program, when it fits
  const int32_t* cols[MAX_COLS];    // column addresses, 16-byte aligned
  const int4* staged;               // the program on the card, else null
  long long n_rows;
  void* out;                        // uint8 mask (K1) / int32 counts (K1c)
  int n_cols;
  int n_instr;
  int depth;                        // stack slots the program needs
  // n_cols > MAX_COLS: the addresses, on the card (``cols`` unused)
  const int32_t* const* col_table;
};
static_assert(sizeof(Params) == 4016, "ops/kernels.py:_PARAM_DTYPE mirrors this");
static_assert(offsetof(Params, cols) == 3840 && offsetof(Params, staged) == 3968 &&
                  offsetof(Params, n_rows) == 3976 && offsetof(Params, out) == 3984 &&
                  offsetof(Params, n_cols) == 3992 && offsetof(Params, n_instr) == 3996 &&
                  offsetof(Params, depth) == 4000 && offsetof(Params, col_table) == 4008,
              "ops/kernels.py:_PARAM_DTYPE mirrors this");

// Column c's address: from the parameters, or from the caller's device
// array when the predicate names more columns than they hold. Only the
// NC = 0 instantiations (more than MAX_CACHED_COLS columns) can see the
// latter.
__device__ __forceinline__ const int32_t* col_addr(const Params& p, int c) {
  return p.n_cols > MAX_COLS ? p.col_table[c] : p.cols[c];
}

template <int OP>
__device__ __forceinline__ bool cmp1(int32_t x, int32_t y) {
  if constexpr (OP == CMP_EQ) return x == y;
  if constexpr (OP == CMP_NE) return x != y;
  if constexpr (OP == CMP_LT) return x < y;
  if constexpr (OP == CMP_LE) return x <= y;
  if constexpr (OP == CMP_GT) return x > y;
  return x >= y;
}

// Operand sources: chunk k (rows k*128 + lane*4 + 0..3) of a column.
struct Lit {
  int32_t c;
  __device__ __forceinline__ int4 operator()(int) const { return make_int4(c, c, c, c); }
};

struct Cached {
  const int4 (&v)[8];
  __device__ __forceinline__ int4 operator()(int k) const { return v[k]; }
};

// ``off`` is the element offset of the thread's chunk 0; ``full`` (warp
// uniform) says the warp's 1024 rows all lie below n.
__device__ __forceinline__ int4 load_chunk(const int32_t* col, long long e, long long n,
                                           bool full) {
  if (full) return __ldg(reinterpret_cast<const int4*>(col + e));
  int4 r;
  r.x = e < n ? __ldg(col + e) : 0;
  r.y = e + 1 < n ? __ldg(col + e + 1) : 0;
  r.z = e + 2 < n ? __ldg(col + e + 2) : 0;
  r.w = e + 3 < n ? __ldg(col + e + 3) : 0;
  return r;
}

struct Global {
  const int32_t* col;
  long long off, n;
  bool full;
  __device__ __forceinline__ int4 operator()(int k) const {
    return load_chunk(col, off + k * 128, n, full);
  }
};

template <int OP, class X, class Y>
__device__ __forceinline__ uint32_t cmp_word(const X& x, const Y& y) {
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int4 a = x(k);
    const int4 b = y(k);
    w |= ((uint32_t)cmp1<OP>(a.x, b.x) << (4 * k)) |
         ((uint32_t)cmp1<OP>(a.y, b.y) << (4 * k + 1)) |
         ((uint32_t)cmp1<OP>(a.z, b.z) << (4 * k + 2)) |
         ((uint32_t)cmp1<OP>(a.w, b.w) << (4 * k + 3));
  }
  return w;
}

template <class X, class Y>
__device__ __forceinline__ uint32_t cmp_dispatch(const X& x, const Y& y, int op) {
  switch (op) {
    case CMP_EQ: return cmp_word<CMP_EQ>(x, y);
    case CMP_NE: return cmp_word<CMP_NE>(x, y);
    case CMP_LT: return cmp_word<CMP_LT>(x, y);
    case CMP_LE: return cmp_word<CMP_LE>(x, y);
    case CMP_GT: return cmp_word<CMP_GT>(x, y);
    default: return cmp_word<CMP_GE>(x, y);
  }
}

// Stage an over-cap program in shared memory; returns the program and the
// stack base (both in the dynamic shared memory block).
template <bool STAGED>
__device__ __forceinline__ uint32_t* setup(const Params& p, int4* smem,
                                           const int4*& prog) {
  if constexpr (STAGED) {
    for (int i = threadIdx.x; i < p.n_instr; i += blockDim.x) smem[i] = p.staged[i];
    __syncthreads();
    prog = smem;
    return reinterpret_cast<uint32_t*>(smem + p.n_instr);
  } else {
    prog = nullptr;
    return reinterpret_cast<uint32_t*>(smem);
  }
}

// The interpreter: the program's value for the thread's 32 rows, bit
// 4k + j for row off + k*128 + j. NC > 0: the program names exactly NC
// columns, all loaded into registers first.
template <bool STAGED, int NC>
__device__ __forceinline__ uint32_t eval_rows(const Params& p, const int4* sprog,
                                              uint32_t* stk, long long off, bool full) {
  const long long n = p.n_rows;
  int4 v[NC > 0 ? NC : 1][8];
  if constexpr (NC > 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[c][k] = load_chunk(p.cols[c], off + k * 128, n, full);
    }
  }
  const int T = blockDim.x;
  uint32_t* my = stk + threadIdx.x;  // slot s of this thread: my[s * T]
  // the stack's top two words live in registers, the rest in slots
  // 0..sp-1 (slot 0 holds the empty stack's placeholder): an AND / OR
  // combines registers and its refill load is not waited for until the
  // next one
  uint32_t top = 0, second = 0;
  int sp = 0;
  for (int i = 0; i < p.n_instr; ++i) {
    int4 ins;
    if constexpr (STAGED) ins = sprog[i]; else ins = p.prog[i];
    if (ins.x == OP_CMP_LIT || ins.x == OP_CMP_COL) {
      uint32_t w = 0;
      if constexpr (NC > 0) {
        // both operands from the registers: no load, no extra register
#pragma unroll
        for (int a = 0; a < NC; ++a) {
          if (a != ins.y) continue;
          if (ins.x == OP_CMP_LIT) {
            w = cmp_dispatch(Cached{v[a]}, Lit{ins.w}, ins.z);
          } else {
#pragma unroll
            for (int b = 0; b < NC; ++b) {
              if (b == ins.w) w = cmp_dispatch(Cached{v[a]}, Cached{v[b]}, ins.z);
            }
          }
        }
      } else if (ins.x == OP_CMP_LIT) {
        w = cmp_dispatch(Global{col_addr(p, ins.y), off, n, full}, Lit{ins.w}, ins.z);
      } else {
        w = cmp_dispatch(Global{col_addr(p, ins.y), off, n, full},
                         Global{col_addr(p, ins.w), off, n, full}, ins.z);
      }
      my[sp * T] = second;
      ++sp;
      second = top;
      top = w;
    } else if (ins.x == OP_NOT) {
      top = ~top;
    } else {
      top = ins.x == OP_AND ? (second & top) : (second | top);
      --sp;
      second = my[sp * T];
    }
  }
  return top;
}

// q < 16: bits 0..3 -> bytes 0..3 as 0/1 (the four products never overlap)
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t q) {
  return (q * 0x00204081u) & 0x01010101u;
}

template <bool STAGED, int NC>
__global__ void __launch_bounds__(K1_THREADS, NC == MAX_CACHED_COLS ? 2 : 3)
predicate_mask_kernel(const __grid_constant__ Params p) {
  extern __shared__ int4 smem[];
  const int4* sprog;
  uint32_t* stk = setup<STAGED>(p, smem, sprog);
  const long long n = p.n_rows;
  const long long base = (long long)blockIdx.x * blockDim.x * ROWS_PER_THREAD +
                         (long long)(threadIdx.x / 32) * WARP_ROWS;
  if (base >= n) return;  // a whole warp past the end (no barrier follows)
  const int lane = threadIdx.x & 31;
  const bool full = base + WARP_ROWS <= n;
  const long long off = base + lane * 4;
  const uint32_t w = eval_rows<STAGED, NC>(p, sprog, stk, off, full);
  uint8_t* out = static_cast<uint8_t*>(p.out);
  if (full) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      *reinterpret_cast<uint32_t*>(out + off + k * 128) = nibble_bytes((w >> (4 * k)) & 0xFu);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long r = off + k * 128 + j;
        if (r < n) out[r] = (uint8_t)((w >> (4 * k + j)) & 1u);
      }
    }
  }
}

template <bool STAGED, int NC>
__global__ void __launch_bounds__(COUNT_THREADS, NC == MAX_CACHED_COLS ? 1 : 2)
predicate_block_counts_kernel(const __grid_constant__ Params p) {
  extern __shared__ int4 smem[];
  __shared__ int warp_counts[COUNT_THREADS / 32];
  const int4* sprog;
  uint32_t* stk = setup<STAGED>(p, smem, sprog);
  const int lane = threadIdx.x & 31;
  const long long off = (long long)blockIdx.x * BLOCK_ROWS +
                        (long long)(threadIdx.x / 32) * WARP_ROWS + lane * 4;
  // the caller's n is a multiple of BLOCK_ROWS: every warp is full
  const uint32_t w = eval_rows<STAGED, NC>(p, sprog, stk, off, true);
  const int c = __reduce_add_sync(0xffffffffu, __popc(w));
  if (lane == 0) warp_counts[threadIdx.x / 32] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int i = 0; i < COUNT_THREADS / 32; ++i) total += warp_counts[i];
    static_cast<int32_t*>(p.out)[blockIdx.x] = total;
  }
}

static_assert(BLOCK_ROWS == COUNT_THREADS * ROWS_PER_THREAD,
              "one K1c CTA covers one block in one pass");

using KernelFn = void (*)(const Params);

#define HS_BY_NC(KERNEL, STAGED)                                              \
  KERNEL<STAGED, 0>, KERNEL<STAGED, 1>, KERNEL<STAGED, 2>, KERNEL<STAGED, 3>, \
      KERNEL<STAGED, 4>
constexpr int N_PER_ENTRY = 2 * (MAX_CACHED_COLS + 1);
// K1's instantiations, then K1c's: program in the parameters or staged,
// times the columns cached in registers (0: more than MAX_CACHED_COLS)
const KernelFn KERNELS[2 * N_PER_ENTRY] = {
    HS_BY_NC(predicate_mask_kernel, false), HS_BY_NC(predicate_mask_kernel, true),
    HS_BY_NC(predicate_block_counts_kernel, false),
    HS_BY_NC(predicate_block_counts_kernel, true)};
#undef HS_BY_NC
static_assert(MAX_CACHED_COLS == 4, "HS_BY_NC lists 0..4");
static_assert(2 * N_PER_ENTRY <= 32, "one bit per instantiation in big_smem_set");

int pick(int entry, const Params& p) {
  return entry * N_PER_ENTRY + (p.staged != nullptr) * (MAX_CACHED_COLS + 1) +
         (p.n_cols <= MAX_CACHED_COLS ? p.n_cols : 0);
}

// Per device, a bit for each instantiation already allowed MAX_DYN_SMEM
// of dynamic shared memory: the attribute is set on first need, not on
// every launch.
constexpr int MAX_DEVICES = 64;
std::atomic<uint32_t> big_smem_set[MAX_DEVICES];

int allow_big_smem(int k) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const uint32_t bit = 1u << k;
  if (dev < MAX_DEVICES && (big_smem_set[dev].load(std::memory_order_relaxed) & bit)) return 0;
  e = cudaFuncSetAttribute(KERNELS[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_DYN_SMEM);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES) big_smem_set[dev].fetch_or(bit, std::memory_order_relaxed);
  return 0;
}

int launch(int k, const Params& p, long long blocks, int threads, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    // dynamic shared memory above the 48 KB default (deep stacks, long
    // staged programs) must be allowed per kernel first
    const int e = allow_big_smem(k);
    if (e != 0) return e;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  KERNELS[k]<<<(unsigned)blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Shared memory of a launch: the staged program, then ``depth`` stack
// slots of one word per thread. -1 when the launch is malformed or does
// not fit.
long long smem_bytes(const Params& p, int threads) {
  if (p.n_cols < 1 || (p.n_cols > MAX_COLS && p.col_table == nullptr) || p.n_instr < 1 ||
      p.depth < 1 || p.depth > STACK_SLOTS || p.out == nullptr)
    return -1;
  if (p.staged == nullptr && p.n_instr > MAX_PARAM_INSTR) return -1;
  const long long bytes = (p.staged ? 16LL * p.n_instr : 0) + 4LL * p.depth * threads;
  return bytes > MAX_DYN_SMEM ? -1 : bytes;
}

}  // namespace

extern "C" int hs_predicate_param_bytes() { return (int)sizeof(Params); }

// params: host pointer to a filled Params (ops/kernels.py packs it); the
// block is copied into the launch, so the caller may free it on return.
// Launches K1 on ``stream``; returns the launch's cudaGetLastError() (0 on
// success) or cudaErrorInvalidValue for a malformed block.
extern "C" int hs_predicate_mask(const void* params, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  if (p.n_rows <= 0) return 0;
  const int threads = p.n_rows < K1_SMALL_BELOW ? K1_SMALL_THREADS : K1_THREADS;
  const long long smem = smem_bytes(p, threads);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const long long rows_per_cta = (long long)threads * ROWS_PER_THREAD;
  const long long blocks = (p.n_rows + rows_per_cta - 1) / rows_per_cta;
  return launch(pick(0, p), p, blocks, threads, smem, (cudaStream_t)stream);
}

// As hs_predicate_mask, for K1c: n_rows must be a positive multiple of
// 8192 (the caller zero-pads its resident planes so) and ``out`` holds
// n_rows / 8192 int32 counts.
extern "C" int hs_predicate_block_counts(const void* params, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  if (p.n_rows <= 0) return 0;
  if (p.n_rows % BLOCK_ROWS) return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(p, COUNT_THREADS);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = p.n_rows / BLOCK_ROWS;
  return launch(pick(1, p), p, blocks, COUNT_THREADS, smem, (cudaStream_t)stream);
}
