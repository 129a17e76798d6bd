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
//
// K1p (hs_predicate_block_counts_packed) replaces the compressed-tier arm
// of hyperspace_tpu/exec/hbm_cache.py:_counts_fn (:447-516, the XLA
// program that decoded bit-packed planes through ops/bitpack.py:
// unpack_plain_jnp and summed the mask per block). The program starts
// with one descriptor per column, {OP_PACK, bits, vpw, ref0} (vpw == 1: a
// raw int32 plane; else value j of a plane is bit (j % vpw) * bits of word
// j / vpw). Bound: memory, and a packed plane moves 32 / vpw bits a row
// instead of 32. A packed plane's 4-byte words fit no 16-byte load of K1c's
// row layout, so K1p has its own body:
//
// * Bulk copies into a ring. The block's rows are cut into sub-tiles of
//   ``sub_rows`` (8192 when two stages fit, else 4096 ... 128: chosen by
//   the wrapper, ops/kernels.py:k1p_plan). One thread copies every
//   column's slice of a sub-tile into a stage of shared memory with one
//   1-D bulk async copy each (cp.async.bulk, completion counted in bytes
//   on the stage's mbarrier), for the CTA's next sub-tile while the CTA
//   evaluates this one. A stage is refilled only after the __syncthreads
//   that ends the evaluation of the sub-tile it held. The ring has
//   K1P_STAGES = 2 stages (a third did not pay at li_st's shape:
//   tools/k1p_probe.py builds it as a variant).
// * Persistent CTAs. The grid is at most the CTAs the card holds at once
//   at the launch's shared memory (the occupancy API's count times the
//   SMs); CTA b takes blocks b, b + gridDim.x, ...; each block's count is
//   written by one thread (no atomics, deterministic).
// * Decode from shared memory, specialised by width. The interpreter's
//   layout stays (bit 4k + j of a thread's word is row k*128 + lane*4 + j
//   of its warp's rows), and every width reads without bank conflicts: raw
//   one int4 a lane, vpw 2 one uint2, vpw 4 one word, vpw >= 8 a word that
//   2-8 lanes share (a broadcast). Each compare switches once on its
//   column's vpw (warp uniform) into a decode templated on it, with 32-bit
//   indices and the shift amounts computed once per column.
//
// Shared memory: the ring, one Slice per column, the staged program, the
// stack; all within MAX_DYN_SMEM.
//
// K1h (hs_hybrid_block_counts) replaces hbm_cache.py:_hybrid_counts_fn
// (:671), which counted a predicate over the resident base planes with
// the rows of deleted source files masked out, then over the appended
// delta's planes, in one program. One launch covers nb_base + nb_delta
// blocks: a block below nb_base reads the base planes (cols[0..n)) and
// clears the bits of deleted rows, one bit a row, laid out so that the
// thread that owns 32 rows reads them as one word (block * 256 + thread);
// a block at or above nb_base reads the delta planes (cols[n..2n)). Both
// sides are raw planes. Bound: memory, the base and delta planes read
// once plus 1 bit a base row.

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum : int32_t { OP_CMP_LIT = 0, OP_CMP_COL = 1, OP_AND = 2, OP_OR = 3, OP_NOT = 4,
                 OP_PACK = 5 };
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

// K1h's second parameter: the deletion bitmask over the base rows (null:
// no deletes) and the number of base blocks.
struct HybridParams {
  const uint32_t* del;
  long long nb_base;
};
static_assert(sizeof(Params) + sizeof(HybridParams) <= 4096, "kernel parameters fit 4 KB");

// Column c's address: from the parameters, or from the caller's device
// array when the launch has more addresses than they hold (col_table set).
// Only the NC = 0 instantiations (more than MAX_CACHED_COLS columns) can
// see the latter.
__device__ __forceinline__ const int32_t* col_addr(const Params& p, int c) {
  return p.col_table != nullptr ? p.col_table[c] : p.cols[c];
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

template <bool STAGED>
__device__ __forceinline__ int4 instr(const Params& p, const int4* sprog, int i) {
  if constexpr (STAGED) return sprog[i]; else return p.prog[i];
}

// The interpreter: the program's value for the thread's 32 rows, bit
// 4k + j for row off + k*128 + j. NC > 0: the program names exactly NC
// columns, all loaded into registers first. DELTA (K1h's delta blocks):
// column c's address is the launch's n_cols + c.
template <bool STAGED, int NC, bool DELTA = false>
__device__ __forceinline__ uint32_t eval_rows(const Params& p, const int4* sprog,
                                              uint32_t* stk, long long off, bool full) {
  const long long n = p.n_rows;
  int4 v[NC > 0 ? NC : 1][8];
  if constexpr (NC > 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int32_t* col = p.cols[(DELTA ? NC : 0) + c];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[c][k] = load_chunk(col, off + k * 128, n, full);
    }
  }
  [[maybe_unused]] const int cb = DELTA ? p.n_cols : 0;
  const int T = blockDim.x;
  uint32_t* my = stk + threadIdx.x;  // slot s of this thread: my[s * T]
  // the stack's top two words live in registers, the rest in slots
  // 0..sp-1 (slot 0 holds the empty stack's placeholder): an AND / OR
  // combines registers and its refill load is not waited for until the
  // next one
  uint32_t top = 0, second = 0;
  int sp = 0;
  for (int i = 0; i < p.n_instr; ++i) {
    const int4 ins = instr<STAGED>(p, sprog, i);
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
        w = cmp_dispatch(Global{col_addr(p, cb + ins.y), off, n, full}, Lit{ins.w}, ins.z);
      } else {
        w = cmp_dispatch(Global{col_addr(p, cb + ins.y), off, n, full},
                         Global{col_addr(p, cb + ins.w), off, n, full}, ins.z);
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

// The CTA's match count: __popc of each thread's word, a warp sum, a
// shared-memory sum of the 8 warps, written by thread 0.
__device__ __forceinline__ void store_block_count(const Params& p, uint32_t w,
                                                  int* warp_counts) {
  const int c = __reduce_add_sync(0xffffffffu, __popc(w));
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x / 32] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int i = 0; i < COUNT_THREADS / 32; ++i) total += warp_counts[i];
    static_cast<int32_t*>(p.out)[blockIdx.x] = total;
  }
}

// The thread's first row within its 8192-row block.
__device__ __forceinline__ long long row_in_block() {
  return (long long)(threadIdx.x / 32) * WARP_ROWS + (threadIdx.x & 31) * 4;
}

// K1c: one CTA counts one block.
template <bool STAGED, int NC>
__global__ void __launch_bounds__(COUNT_THREADS, NC == MAX_CACHED_COLS ? 1 : 2)
predicate_block_counts_kernel(const __grid_constant__ Params p) {
  extern __shared__ int4 smem[];
  __shared__ int warp_counts[COUNT_THREADS / 32];
  const int4* sprog;
  uint32_t* stk = setup<STAGED>(p, smem, sprog);
  const long long off = (long long)blockIdx.x * BLOCK_ROWS + row_in_block();
  // the caller's n is a multiple of BLOCK_ROWS: every warp is full
  const uint32_t w = eval_rows<STAGED, NC>(p, sprog, stk, off, true);
  store_block_count(p, w, warp_counts);
}

template <bool STAGED, int NC>
__global__ void __launch_bounds__(COUNT_THREADS, NC == MAX_CACHED_COLS ? 1 : 2)
hybrid_block_counts_kernel(const __grid_constant__ Params p,
                           const __grid_constant__ HybridParams h) {
  extern __shared__ int4 smem[];
  __shared__ int warp_counts[COUNT_THREADS / 32];
  const int4* sprog;
  uint32_t* stk = setup<STAGED>(p, smem, sprog);
  uint32_t w;
  if ((long long)blockIdx.x < h.nb_base) {  // uniform across the CTA
    const long long off = (long long)blockIdx.x * BLOCK_ROWS + row_in_block();
    w = eval_rows<STAGED, NC, false>(p, sprog, stk, off, true);
    if (h.del != nullptr) w &= ~__ldg(h.del + (long long)blockIdx.x * COUNT_THREADS + threadIdx.x);
  } else {
    const long long off = ((long long)blockIdx.x - h.nb_base) * BLOCK_ROWS + row_in_block();
    w = eval_rows<STAGED, NC, true>(p, sprog, stk, off, true);
  }
  store_block_count(p, w, warp_counts);
}

// ---------------------------------------------------------------------------
// K1p: block counts over packed planes, staged through a shared-memory ring
// ---------------------------------------------------------------------------
// The launch's plan, chosen by ops/kernels.py:k1p_plan and checked by the
// entry point: rows of a block that a stage holds, and bytes of a stage
// (every column's slice of those rows; the host cannot read a staged
// program's descriptors, so the wrapper sends it).
struct PackedPlan {
  int sub_rows;
  int stage_bytes;
};
constexpr int MIN_SUB_ROWS = 128;  // one warp's chunk; a vpw-32 slice is then 16 bytes
constexpr int K1P_STAGES = 2;      // the ring
constexpr int K1P_MIN_CTAS = 2;    // CTAs an SM holds in registers (__launch_bounds__)

// One column of a K1p launch: its plane, its slice's byte offset in a
// stage, log2 of its vpw.
struct Slice {
  const char* src;
  int off;
  int lg;
};
static_assert(sizeof(Slice) == 16, "ops/kernels.py:k1p_plan counts 16 bytes a column");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into this CTA's shared memory; completion counts on ``bar``.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Rows r0 + k*128 + 0..3 (k < KC) of a slice of vpw VPW under descriptor
// d = {OP_PACK, bits, vpw, ref0}, decoded; r0 is a multiple of 4. Shifts
// and masks act on uint32 (a word whose top bit is set must not smear into
// its neighbour), and (offset + ref0) wraps to the int32 value the host
// packed.
template <int VPW, int KC>
__device__ __forceinline__ void decode(const uint32_t* w, unsigned r0, const int4 d,
                                       int4 (&v)[KC]) {
  if constexpr (VPW == 1) {
#pragma unroll
    for (int k = 0; k < KC; ++k) v[k] = reinterpret_cast<const int4*>(w)[(r0 >> 2) + k * 32];
  } else {
    const int bits = d.y;
    const uint32_t mask = (1u << bits) - 1u;  // bits <= 16
    const uint32_t ref = (uint32_t)d.w;
    if constexpr (VPW == 2) {
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const uint2 u = reinterpret_cast<const uint2*>(w)[(r0 >> 2) + k * 32];
        v[k] = make_int4((int32_t)((u.x & mask) + ref), (int32_t)(((u.x >> bits) & mask) + ref),
                         (int32_t)((u.y & mask) + ref), (int32_t)(((u.y >> bits) & mask) + ref));
      }
    } else {
      // the 4 rows sit in one word at the same bit for every chunk (k*128
      // is a multiple of VPW): 4 / VPW of the lane's word
      const int s0 = (int)((r0 >> 2) & (VPW / 4 - 1)) * 4 * bits;
      const int s1 = s0 + bits, s2 = s1 + bits, s3 = s2 + bits;  // s3 < 32
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const uint32_t x = w[(r0 + k * 128) / VPW];
        v[k] = make_int4((int32_t)(((x >> s0) & mask) + ref), (int32_t)(((x >> s1) & mask) + ref),
                         (int32_t)(((x >> s2) & mask) + ref), (int32_t)(((x >> s3) & mask) + ref));
      }
    }
  }
}

// Column c's rows of the thread from the stage: one warp-uniform switch
// into the decode of its width.
template <int KC>
__device__ __forceinline__ void decode_col(const unsigned char* stage, const Slice& s,
                                           const int4 d, unsigned r0, int4 (&v)[KC]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(stage + s.off);
  switch (d.z) {
    case 1: decode<1, KC>(w, r0, d, v); break;
    case 2: decode<2, KC>(w, r0, d, v); break;
    case 4: decode<4, KC>(w, r0, d, v); break;
    case 8: decode<8, KC>(w, r0, d, v); break;
    case 16: decode<16, KC>(w, r0, d, v); break;
    default: decode<32, KC>(w, r0, d, v); break;
  }
}

template <int KC>
struct Chunks {
  const int4 (&v)[KC];
  __device__ __forceinline__ int4 operator()(int k) const { return v[k]; }
};

template <int OP, int KC, class Y>
__device__ __forceinline__ uint32_t cmp_chunks(const int4 (&a)[KC], const Y& y) {
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int4 b = y(k);
    w |= ((uint32_t)cmp1<OP>(a[k].x, b.x) << (4 * k)) |
         ((uint32_t)cmp1<OP>(a[k].y, b.y) << (4 * k + 1)) |
         ((uint32_t)cmp1<OP>(a[k].z, b.z) << (4 * k + 2)) |
         ((uint32_t)cmp1<OP>(a[k].w, b.w) << (4 * k + 3));
  }
  return w;
}

template <int KC, class Y>
__device__ __forceinline__ uint32_t cmp_chunks_dispatch(const int4 (&a)[KC], const Y& y, int op) {
  switch (op) {
    case CMP_EQ: return cmp_chunks<CMP_EQ, KC>(a, y);
    case CMP_NE: return cmp_chunks<CMP_NE, KC>(a, y);
    case CMP_LT: return cmp_chunks<CMP_LT, KC>(a, y);
    case CMP_LE: return cmp_chunks<CMP_LE, KC>(a, y);
    case CMP_GT: return cmp_chunks<CMP_GT, KC>(a, y);
    default: return cmp_chunks<CMP_GE, KC>(a, y);
  }
}

// The program's value over the thread's rows of the sub-tile in ``stage``:
// bit 4k + j for row r0 + k*128 + j (k < KC). The stack as eval_rows's.
template <bool STAGED, int KC>
__device__ __forceinline__ uint32_t eval_packed(const Params& p, const int4* sprog,
                                                const Slice* tab, const unsigned char* stage,
                                                uint32_t* stk, unsigned r0) {
  const int T = blockDim.x;
  uint32_t* my = stk + threadIdx.x;
  uint32_t top = 0, second = 0;
  int sp = 0;
  for (int i = p.n_cols; i < p.n_instr; ++i) {
    const int4 ins = instr<STAGED>(p, sprog, i);
    if (ins.x == OP_CMP_LIT || ins.x == OP_CMP_COL) {
      int4 a[KC];
      decode_col<KC>(stage, tab[ins.y], instr<STAGED>(p, sprog, ins.y), r0, a);
      uint32_t w;
      if (ins.x == OP_CMP_LIT) {
        w = cmp_chunks_dispatch<KC>(a, Lit{ins.w}, ins.z);
      } else {
        int4 b[KC];
        decode_col<KC>(stage, tab[ins.w], instr<STAGED>(p, sprog, ins.w), r0, b);
        w = cmp_chunks_dispatch<KC>(a, Chunks<KC>{b}, ins.z);
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

// K1p. A sub-tile of S = q.sub_rows rows gives warp w the rows
// w*KC*128 + k*128 + lane*4 + j (k < KC, j < 4): KC = S / 1024, or 1 with
// only the first S / 128 warps at work when S < 1024. The CTA's items are
// (block, sub-tile) in order over its blocks blockIdx.x, + gridDim.x, ...;
// item i lives in stage i % K1P_STAGES, whose mbarrier completes its
// (i / K1P_STAGES)-th phase when the item's bytes have landed. While the
// CTA evaluates item i, the copies of items i + 1 .. i + K1P_STAGES - 1
// are in flight.
template <bool STAGED, int KC>
__global__ void __launch_bounds__(COUNT_THREADS, K1P_MIN_CTAS)
predicate_block_counts_packed_kernel(const __grid_constant__ Params p,
                                     const __grid_constant__ PackedPlan q) {
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ uint64_t full[K1P_STAGES];
  // per block parity: thread 0 reads one block's while a warp may already
  // be writing the next one's
  __shared__ int warp_counts[2][COUNT_THREADS / 32];
  const int S = q.sub_rows, sb = q.stage_bytes;
  Slice* tab = reinterpret_cast<Slice*>(dsm + K1P_STAGES * sb);
  int4* after_tab = reinterpret_cast<int4*>(tab + p.n_cols);
  const int4* sprog = nullptr;
  uint32_t* stk;
  if constexpr (STAGED) {
    for (int i = threadIdx.x; i < p.n_instr; i += blockDim.x) after_tab[i] = p.staged[i];
    sprog = after_tab;
    stk = reinterpret_cast<uint32_t*>(after_tab + p.n_instr);
  } else {
    stk = reinterpret_cast<uint32_t*>(after_tab);
  }
  if (threadIdx.x == 0) {
    int off = 0;
    for (int c = 0; c < p.n_cols; ++c) {
      const int lg = __ffs(STAGED ? p.staged[c].z : p.prog[c].z) - 1;
      tab[c] = Slice{reinterpret_cast<const char*>(col_addr(p, c)), off, lg};
      off += (S >> lg) * 4;
    }
    for (int st = 0; st < K1P_STAGES; ++st) mbar_init(&full[st]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nb = (int)(p.n_rows / BLOCK_ROWS);
  const int lg_sub = __ffs(BLOCK_ROWS / S) - 1;  // 2^lg_sub sub-tiles a block
  const int n_items =
      (int)blockIdx.x < nb ? ((nb - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) << lg_sub : 0;
  const int warp = threadIdx.x >> 5;
  const unsigned r0 = (unsigned)warp * (KC * 128) + (threadIdx.x & 31) * 4;
  const bool active = r0 < (unsigned)S;  // warp uniform: S is a multiple of 128
  const uint32_t valid = 0xffffffffu >> (32 - 4 * KC);  // bits 4k + j, k < KC

  // thread 0: the next item's slices into the next stage, in item order
  int next = 0, next_stage = 0;
  auto issue = [&]() {
    const long long row0 =
        (long long)(blockIdx.x + (unsigned)(next >> lg_sub) * gridDim.x) * BLOCK_ROWS +
        (long long)(next & ((1 << lg_sub) - 1)) * S;
    unsigned char* stage = dsm + next_stage * sb;
    mbar_expect_tx(&full[next_stage], sb);
    for (int c = 0; c < p.n_cols; ++c) {
      const Slice t = tab[c];
      bulk_copy(stage + t.off, t.src + ((row0 >> t.lg) << 2), (S >> t.lg) << 2,
                &full[next_stage]);
    }
    ++next;
    next_stage = next_stage + 1 == K1P_STAGES ? 0 : next_stage + 1;
  };
  if (threadIdx.x == 0) {
    while (next < n_items && next < K1P_STAGES - 1) issue();
  }
  uint32_t acc = 0, parity = 0;
  for (int i = 0, st = 0; i < n_items; ++i) {
    // item i + K1P_STAGES - 1 goes into the stage item i - 1 held, which every
    // thread finished before the __syncthreads that ended it
    if (threadIdx.x == 0 && next < n_items) issue();
    if (active) {
      mbar_wait(&full[st], parity);
      acc += __popc(eval_packed<STAGED, KC>(p, sprog, tab, dsm + st * sb, stk, r0) & valid);
    }
    const bool last = ((i + 1) & ((1 << lg_sub) - 1)) == 0;  // the block's last sub-tile
    const int b = i >> lg_sub;
    if (last) {
      const int c = (int)__reduce_add_sync(0xffffffffu, acc);
      if ((threadIdx.x & 31) == 0) warp_counts[b & 1][warp] = c;
      acc = 0;
    }
    __syncthreads();  // stage st is free; the block's warp counts are in
    if (last && threadIdx.x == 0) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < COUNT_THREADS / 32; ++w) total += warp_counts[b & 1][w];
      static_cast<int32_t*>(p.out)[blockIdx.x + (long long)b * gridDim.x] = total;
    }
    if (++st == K1P_STAGES) {
      st = 0;
      parity ^= 1u;
    }
  }
}

static_assert(BLOCK_ROWS == COUNT_THREADS * ROWS_PER_THREAD,
              "one K1c CTA covers one block in one pass");

using KernelFn = void (*)(const Params);
using HybridFn = void (*)(const Params, const HybridParams);
using PackedFn = void (*)(const Params, const PackedPlan);

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
// K1h's, in the same order, after them in big_smem_set's bits
const HybridFn HYBRID_KERNELS[N_PER_ENTRY] = {HS_BY_NC(hybrid_block_counts_kernel, false),
                                              HS_BY_NC(hybrid_block_counts_kernel, true)};
#undef HS_BY_NC
static_assert(MAX_CACHED_COLS == 4, "HS_BY_NC lists 0..4");
// K1p's, after K1h's: program in the parameters or staged, times the
// chunks a thread takes of a sub-tile (KC 1, 2, 4, 8)
#define HS_BY_KC(STAGED)                                                       \
  predicate_block_counts_packed_kernel<STAGED, 1>,                             \
      predicate_block_counts_packed_kernel<STAGED, 2>,                         \
      predicate_block_counts_packed_kernel<STAGED, 4>,                         \
      predicate_block_counts_packed_kernel<STAGED, 8>
const PackedFn PACKED_KERNELS[8] = {HS_BY_KC(false), HS_BY_KC(true)};
#undef HS_BY_KC
static_assert(3 * N_PER_ENTRY + 8 <= 64, "one bit per instantiation in big_smem_set");

int pick(int entry, const Params& p) {
  return entry * N_PER_ENTRY + (p.staged != nullptr) * (MAX_CACHED_COLS + 1) +
         (p.n_cols <= MAX_CACHED_COLS ? p.n_cols : 0);
}

// Per device, a bit for each instantiation already allowed MAX_DYN_SMEM
// of dynamic shared memory: the attribute is set on first need, not on
// every launch.
constexpr int MAX_DEVICES = 64;
std::atomic<uint64_t> big_smem_set[MAX_DEVICES];

template <class F>
int allow_big_smem(F* fn, int bit_index, bool max_carveout = false) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const uint64_t bit = 1ull << bit_index;
  if (dev < MAX_DEVICES && (big_smem_set[dev].load(std::memory_order_relaxed) & bit)) return 0;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYN_SMEM);
  if (e != cudaSuccess) return (int)e;
  if (max_carveout) {  // K1p: the whole of L1 as shared memory, for the CTAs its plan counts
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
  }
  if (dev < MAX_DEVICES) big_smem_set[dev].fetch_or(bit, std::memory_order_relaxed);
  return 0;
}

int launch(int k, const Params& p, long long blocks, int threads, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    // dynamic shared memory above the 48 KB default (deep stacks, long
    // staged programs) must be allowed per kernel first
    const int e = allow_big_smem(KERNELS[k], k);
    if (e != 0) return e;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  KERNELS[k]<<<(unsigned)blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Shared memory of a launch: the staged program, then ``depth`` stack
// slots of one word per thread. -1 when the launch is malformed or does
// not fit. ``n_addrs``: the column addresses the launch carries (n_cols,
// or 2 * n_cols for K1h), in the parameters up to MAX_COLS, else in
// col_table.
long long smem_bytes(const Params& p, int threads, int n_addrs) {
  if (p.n_cols < 1 || (n_addrs > MAX_COLS) != (p.col_table != nullptr) || p.n_instr < 1 ||
      p.depth < 1 || p.depth > STACK_SLOTS || p.out == nullptr)
    return -1;
  if (p.staged == nullptr && p.n_instr > MAX_PARAM_INSTR) return -1;
  const long long bytes = (p.staged ? 16LL * p.n_instr : 0) + 4LL * p.depth * threads;
  return bytes > MAX_DYN_SMEM ? -1 : bytes;
}

// K1p's shared memory under plan ``q``: the ring, a Slice per column, the
// staged program and the stack (ops/kernels.py:k1p_plan). -1 when the
// launch or the plan is malformed or does not fit. The stage's bytes are
// checked against the descriptors when they ride in the parameters.
long long packed_smem_bytes(const Params& p, const PackedPlan& q) {
  const long long rest = smem_bytes(p, COUNT_THREADS, p.n_cols);
  if (rest < 0 || p.n_instr <= p.n_cols) return -1;
  const int S = q.sub_rows;
  if (S < MIN_SUB_ROWS || S > BLOCK_ROWS || (S & (S - 1)) || q.stage_bytes <= 0 ||
      q.stage_bytes % 16)
    return -1;
  if (p.staged == nullptr) {
    long long stage = 0;
    for (int c = 0; c < p.n_cols; ++c) {
      const int4 d = p.prog[c];
      if (d.x != OP_PACK || d.z < 1 || d.z > 32 || (d.z & (d.z - 1))) return -1;
      stage += 4LL * S / d.z;
    }
    if (stage != q.stage_bytes) return -1;
  }
  const long long bytes =
      (long long)K1P_STAGES * q.stage_bytes + (long long)sizeof(Slice) * p.n_cols + rest;
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
  const long long smem = smem_bytes(p, threads, p.n_cols);
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
  const long long smem = smem_bytes(p, COUNT_THREADS, p.n_cols);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = p.n_rows / BLOCK_ROWS;
  return launch(pick(1, p), p, blocks, COUNT_THREADS, smem, (cudaStream_t)stream);
}

// As hs_predicate_block_counts, for K1p: the program's first n_cols
// instructions are the columns' descriptors {OP_PACK, bits, vpw, ref0}; a
// packed column holds n_rows / vpw words, a raw one (vpw 1) n_rows values,
// each plane 16-byte aligned. ``plan``: a host pointer to the launch's
// PackedPlan (ops/kernels.py:k1p_plan).
extern "C" int hs_predicate_block_counts_packed(const void* params, const void* plan,
                                                void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  const PackedPlan& q = *static_cast<const PackedPlan*>(plan);
  if (p.n_rows <= 0) return 0;
  if (p.n_rows % BLOCK_ROWS) return (int)cudaErrorInvalidValue;
  const long long smem = packed_smem_bytes(p, q);
  const long long blocks = p.n_rows / BLOCK_ROWS;
  if (smem < 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int kc = q.sub_rows >= 1024 ? q.sub_rows / 1024 : 1;
  const int k = (p.staged != nullptr) * 4 + (__builtin_ffs(kc) - 1);
  cudaError_t e = (cudaError_t)allow_big_smem(PACKED_KERNELS[k], 3 * N_PER_ENTRY + k, true);
  if (e != cudaSuccess) return (int)e;
  // persistent CTAs: as many as the card holds at once at this shared memory
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, PACKED_KERNELS[k],
                                                         COUNT_THREADS, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long grid = blocks < (long long)sms * per_sm ? blocks : (long long)sms * per_sm;
  PACKED_KERNELS[k]<<<(unsigned)grid, COUNT_THREADS, smem, (cudaStream_t)stream>>>(p, q);
  return (int)cudaGetLastError();
}

// K1h: ``params`` as for K1c, with n_rows the base rows plus the delta
// rows (both multiples of 8192) and 2 * n_cols addresses, the base
// planes' then the delta planes' (in col_table when more than MAX_COLS);
// ``hybrid`` a host pointer to HybridParams (nb_base: the base rows /
// 8192; del: n_base / 32 words, or null). ``out`` holds n_rows / 8192
// counts, the base blocks' then the delta blocks'.
extern "C" int hs_hybrid_block_counts(const void* params, const void* hybrid, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  const HybridParams& h = *static_cast<const HybridParams*>(hybrid);
  if (p.n_rows <= 0) return 0;
  if (p.n_rows % BLOCK_ROWS || h.nb_base < 0 || h.nb_base * BLOCK_ROWS > p.n_rows)
    return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(p, COUNT_THREADS, 2 * p.n_cols);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = p.n_rows / BLOCK_ROWS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int k = pick(0, p);
  if (smem > 48 * 1024) {
    const int e = allow_big_smem(HYBRID_KERNELS[k], 2 * N_PER_ENTRY + k);
    if (e != 0) return e;
  }
  HYBRID_KERNELS[k]<<<(unsigned)blocks, COUNT_THREADS, smem, (cudaStream_t)stream>>>(p, h);
  return (int)cudaGetLastError();
}
