// K1b and K1hb's first design, kept for tools/k1b_probe.py to time beside
// the current one (csrc/predicate_mask.cu): the probe builds it on its own.
// One CTA of 256 threads counts one 8192-row block: the block's rows come
// in sub-tiles of ``sub_rows``; every plane's slice of a sub-tile is copied
// into shared memory by all threads (16-byte __ldg loads), then all N
// programs are interpreted over it, each decoding its compares from shared
// memory; a warp's count of a program goes to a shared-memory counter with
// one atomicAdd. The N programs, their offsets, the planes' descriptors and
// addresses ride one device buffer the caller fills for the launch
// (struct BatchParams points into it). K1hb: base blocks then delta blocks,
// the base's deleted rows cleared with K1h's 1-bit mask gathered by each
// thread.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum : int32_t { OP_CMP_LIT = 0, OP_CMP_COL = 1, OP_AND = 2, OP_OR = 3, OP_NOT = 4,
                 OP_PACK = 5 };
enum : int32_t { CMP_EQ = 0, CMP_NE = 1, CMP_LT = 2, CMP_LE = 3, CMP_GT = 4, CMP_GE = 5 };

constexpr int STACK_SLOTS = 64;
constexpr int BLOCK_ROWS = 8192;
constexpr int COUNT_THREADS = 256;
constexpr int MAX_DYN_SMEM = 232448 - 1024;
constexpr int MIN_SUB_ROWS = 128;

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

// The launch's parameters; everything of variable size lives in the
// device buffer the pointers address. tools/k1b_probe.py packs this
// layout (hs_batch_param_bytes() lets it check).
struct BatchParams {
  const int4* code;               // the N programs, back to back
  const int* prog_off;            // N + 1 instruction offsets into code
  const int4* desc;               // per plane {OP_PACK, bits, vpw, ref0}
  const int32_t* const* cols;     // plane addresses (K1hb: base's, then delta's)
  const uint32_t* del;            // K1hb: deletion mask over the base rows, or null
  int32_t* out;                   // n_progs x blocks counts, program-major
  long long n_rows;               // rows counted (K1hb: base + delta)
  long long nb_base;              // K1hb: base blocks (K1b: all blocks)
  int n_progs;
  int n_cols;                     // planes a side
  int sub_rows;                   // rows of a block a sub-tile holds
  int stage_bytes;                // bytes of a sub-tile's slices
  int depth;                      // stack slots the deepest program needs
  int pad_;
};
static_assert(sizeof(BatchParams) == 88 && offsetof(BatchParams, n_rows) == 48 &&
                  offsetof(BatchParams, n_progs) == 64 && offsetof(BatchParams, depth) == 80,
              "tools/k1b_probe.py mirrors this");

// One plane's slice in the shared-memory stage: its byte offset, log2 of
// its vpw, and its descriptor's bits and ref0.
struct BSlice {
  int off;
  int lg;
  int bits;
  int ref;
};
static_assert(sizeof(BSlice) == 16, "tools/k1b_probe.py counts 16 bytes a plane");

template <int KC>
__device__ __forceinline__ void decode_slice(const unsigned char* stage, const BSlice& s,
                                             unsigned r0, int4 (&v)[KC]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(stage + s.off);
  const int4 d = make_int4(OP_PACK, s.bits, 1 << s.lg, s.ref);
  switch (s.lg) {
    case 0: decode<1, KC>(w, r0, d, v); break;
    case 1: decode<2, KC>(w, r0, d, v); break;
    case 2: decode<4, KC>(w, r0, d, v); break;
    case 3: decode<8, KC>(w, r0, d, v); break;
    case 4: decode<16, KC>(w, r0, d, v); break;
    default: decode<32, KC>(w, r0, d, v); break;
  }
}

// Program [i0, i1) of ``code`` over the thread's rows of the staged
// sub-tile; the stack as eval_rows's.
template <int KC>
__device__ __forceinline__ uint32_t eval_batch(const int4* code, int i0, int i1,
                                               const BSlice* tab, const unsigned char* stage,
                                               uint32_t* stk, unsigned r0) {
  const int T = blockDim.x;
  uint32_t* my = stk + threadIdx.x;
  uint32_t top = 0, second = 0;
  int sp = 0;
  for (int i = i0; i < i1; ++i) {
    const int4 ins = __ldg(code + i);
    if (ins.x == OP_CMP_LIT || ins.x == OP_CMP_COL) {
      int4 a[KC];
      decode_slice<KC>(stage, tab[ins.y], r0, a);
      uint32_t w;
      if (ins.x == OP_CMP_LIT) {
        w = cmp_chunks_dispatch<KC>(a, Lit{ins.w}, ins.z);
      } else {
        int4 b[KC];
        decode_slice<KC>(stage, tab[ins.w], r0, b);
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

__host__ __device__ __forceinline__ int round16(int bytes) { return (bytes + 15) & ~15; }

// Shared memory: the slice table, the per-program counts, the stack, then
// the stage.
__host__ __device__ __forceinline__ int batch_fixed_bytes(int n_cols, int n_progs, int depth) {
  return 16 * n_cols + round16(4 * n_progs) + 4 * depth * COUNT_THREADS;
}

// One CTA per block. A sub-tile of S = p.sub_rows rows gives warp w the
// rows w*KC*128 + k*128 + lane*4 + j (k < KC), as K1p: KC = S / 1024, or 1
// with the first S / 128 warps at work when S < 1024.
template <int KC, bool HYBRID>
__global__ void __launch_bounds__(COUNT_THREADS, 1)
block_counts_batch_first_kernel(const __grid_constant__ BatchParams p) {
  extern __shared__ __align__(16) unsigned char dsm[];
  BSlice* tab = reinterpret_cast<BSlice*>(dsm);
  int* cnt = reinterpret_cast<int*>(dsm + 16 * p.n_cols);
  uint32_t* stk = reinterpret_cast<uint32_t*>(dsm + 16 * p.n_cols + round16(4 * p.n_progs));
  unsigned char* stage = dsm + batch_fixed_bytes(p.n_cols, p.n_progs, p.depth);
  const int S = p.sub_rows;
  const long long blk = blockIdx.x;
  const bool delta = HYBRID && blk >= p.nb_base;
  const long long side_blk = delta ? blk - p.nb_base : blk;
  const int cbase = delta ? p.n_cols : 0;
  for (int q = threadIdx.x; q < p.n_progs; q += blockDim.x) cnt[q] = 0;
  if (threadIdx.x == 0) {
    int off = 0;
    for (int c = 0; c < p.n_cols; ++c) {
      const int4 d = p.desc[c];
      const int lg = __ffs(d.z) - 1;
      tab[c] = BSlice{off, lg, d.y, d.w};
      off += (S >> lg) * 4;
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned r0 = (unsigned)warp * (KC * 128) + lane * 4;
  const bool active = r0 < (unsigned)S;  // warp uniform
  const uint32_t valid = 0xffffffffu >> (32 - 4 * KC);
  const int n_sub = BLOCK_ROWS / S;
  for (int s = 0; s < n_sub; ++s) {
    const long long row0 = side_blk * BLOCK_ROWS + (long long)s * S;
    for (int c = 0; c < p.n_cols; ++c) {
      const BSlice t = tab[c];
      const int4* src = reinterpret_cast<const int4*>(p.cols[cbase + c]) + ((row0 >> t.lg) >> 2);
      int4* dst = reinterpret_cast<int4*>(stage + t.off);
      const int n16 = (S >> t.lg) >> 2;
      for (int i = threadIdx.x; i < n16; i += blockDim.x) dst[i] = __ldg(src + i);
    }
    __syncthreads();
    if (active) {
      uint32_t live = valid;
      if (HYBRID && !delta && p.del != nullptr) {
        // the bits of this thread's rows in K1h's layout: row
        // W*1024 + K*128 + lane*4 + j is bit 4K + j of word W*32 + lane
        uint32_t gone = 0;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const unsigned rb = (unsigned)(s * S) + (unsigned)warp * (KC * 128) + k * 128;
          const uint32_t word = __ldg(p.del + blk * COUNT_THREADS + (rb >> 10) * 32 + lane);
          gone |= ((word >> (4 * ((rb >> 7) & 7))) & 0xFu) << (4 * k);
        }
        live &= ~gone;
      }
      for (int q = 0; q < p.n_progs; ++q) {
        const uint32_t w = eval_batch<KC>(p.code, __ldg(p.prog_off + q),
                                          __ldg(p.prog_off + q + 1), tab, stage, stk, r0) & live;
        const int c = (int)__reduce_add_sync(0xffffffffu, __popc(w));
        if (lane == 0 && c != 0) atomicAdd(&cnt[q], c);
      }
    }
    __syncthreads();  // the stage is free; the counts are in
  }
  const long long nb = p.n_rows / BLOCK_ROWS;
  for (int q = threadIdx.x; q < p.n_progs; q += blockDim.x) p.out[(long long)q * nb + blk] = cnt[q];
}


using BatchFn = void (*)(const BatchParams);
const BatchFn BATCH_KERNELS[8] = {
    block_counts_batch_first_kernel<1, false>, block_counts_batch_first_kernel<2, false>,
    block_counts_batch_first_kernel<4, false>, block_counts_batch_first_kernel<8, false>,
    block_counts_batch_first_kernel<1, true>,  block_counts_batch_first_kernel<2, true>,
    block_counts_batch_first_kernel<4, true>,  block_counts_batch_first_kernel<8, true>};

// K1b and K1hb's shared entry: the launch checked (what the host can see
// of it; the buffer's contents are the caller's), then one CTA a block.
int launch_batch(const BatchParams& p, bool hybrid, cudaStream_t stream) {
  if (p.n_rows <= 0) return 0;
  const int S = p.sub_rows;
  if (p.n_rows % BLOCK_ROWS || p.n_progs < 1 || p.n_cols < 1 || p.depth < 1 ||
      p.depth > STACK_SLOTS || S < MIN_SUB_ROWS || S > BLOCK_ROWS || (S & (S - 1)) ||
      p.stage_bytes <= 0 || p.stage_bytes % 16 || p.code == nullptr ||
      p.prog_off == nullptr || p.desc == nullptr || p.cols == nullptr || p.out == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long blocks = p.n_rows / BLOCK_ROWS;
  if (blocks > 0x7fffffffLL || p.nb_base < 0 || p.nb_base > blocks ||
      (!hybrid && (p.nb_base != blocks || p.del != nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long smem =
      (long long)batch_fixed_bytes(p.n_cols, p.n_progs, p.depth) + p.stage_bytes;
  if (smem > MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  const int kc = S >= 1024 ? S / 1024 : 1;
  const int k = hybrid * 4 + (__builtin_ffs(kc) - 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        BATCH_KERNELS[k], cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYN_SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  BATCH_KERNELS[k]<<<(unsigned)blocks, COUNT_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hs_batch_param_bytes() { return (int)sizeof(BatchParams); }

extern "C" int hs_predicate_block_counts_batch(const void* params, void* stream) {
  return launch_batch(*static_cast<const BatchParams*>(params), false, (cudaStream_t)stream);
}

extern "C" int hs_hybrid_block_counts_batch(const void* params, void* stream) {
  return launch_batch(*static_cast<const BatchParams*>(params), true, (cudaStream_t)stream);
}
