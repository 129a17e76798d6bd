"""What bounds K2 (the sorted-intersect join kernel) on the card, and
what each part of its current design is worth.

Run from the repository root on a machine with a CUDA card:

    python3 -m hyperspace_tpu_torch.tools.k2_probe [--seed 0] [--out PATH]

Both parts run at the Q3 join's shapes of ``chip_smoke.py``: TPC-H SF1
lineitem order keys (6,001,215) in the index layout against the sorted
orders keys (1,500,000), and the same keys in key order. Times are device
times from torch.profiler, each launch after an L2 flush
(``chip_smoke.device_ms``), beside CUDA-event times of the launch.

Part 1 builds six variants of K2's first design (one thread per left
key, two binary searches over its tile's span of right keys in device
memory) from the source below:

- ``base``: the first design as it shipped (64-bit indices, branching);
- ``i32``: int32 indices;
- ``fixed``: int32, branch-free steps, one trip count per tile;
- ``lower``: ``fixed`` with the lower bound only;
- ``l1``: ``fixed`` with every load redirected into the span's first
  1024 keys: the same instructions and the same dependent chain, with L1
  hits in place of round trips to L2;
- ``io``: no search: reads the keys, writes base and 0 (the I/O floor).

Part 2 builds ``csrc/sorted_intersect.cu`` in the designs of
``DESIGNS``, each the shipped source with the changes named: fence
strides 16 and 32; each thread's 4 keys consecutive (``thread_keys``) in
place of 32 apart; the fence copy through registers (``ldg_copy``) in
place of ``cp.async``; ``__launch_bounds__`` asking for 4 or 6 CTAs an
SM; and, to split its time, parts left out: the fence copy (the search
then runs over stale shared memory), the search (every key takes the
slice's first or last line), the reads of r's lines, and combinations of
these (``io_only``: none of the three). It holds each full design
exactly against K2's span semantics (``sorted_intersect_span_reference``)
and times every one, fences built once and timed apart.

Part 3 (``k2p``) times K2p, the K2 entry over FoR-packed right keys, at
the join region's shape (the index-layout keys against the order keys
packed in blocks of 128, vpw 2), in turns (each design once in order,
then once in reverse order):

- ``first_design``: K2p's first design, one CTA a left tile reading each
  key's line from device memory (``tools/k2p_first_design.cu``, kept
  beside the probe);
- ``shipped``: ``csrc/sorted_intersect.cu`` under the group plan for
  1x, 2x and 4x the card's SM count (``plan_k2p_groups``' target);
- ``two_in_flight``: a CTA of 512 threads, two tiles in flight (two
  teams of 256), in place of 1024 threads and four;
- ``keys_2``: 1024 threads, two tiles in flight, two keys a thread (two
  teams of 512) in place of four teams of four keys;
- ``keys_bulk``: each team's next tiles' keys bulk-copied into a double
  buffer in shared memory, in place of loads into registers;
- ``one_barrier``: the whole window on one mbarrier, so no search
  starts before all of it is in, in place of the fences on their own;
- ``count_tree``: a line's counts by a branch-free binary search over its
  8 ascending offsets (a branch for the line holding pads), in place of 8
  compares each;
- ``copies_only``: the window's copies and the keys' loads and stores,
  no search;
- ``search_only``: the search over a window that is never copied;
- ``no_lines``: the copies and the fence search, no line read or decode;
- ``no_run``: no check for runs of equal keys past a line's end.

Every full design is held exactly against K2p's plain version
(``sorted_intersect_packed_reference``) on every padded row. The part
also counts what each design moves: the first design's fence slices
(512 bytes a right tile of each span) and its lines (one 16-byte word
read a key), the windows' bytes (``k2p_tile_bytes`` a right tile).

Prints one JSON object as its last line and writes it to ``--out``, with
the opcode counts of the shipped designs' SASS (``cuobjdump -sass``),
whose text goes beside it (``k2_sass.txt``, ``k2p_sass.txt``). ``--parts`` picks the parts
(``k2,k2p``: K2's two, K2p's; default both).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

VARIANTS = ("base", "i32", "fixed", "lower", "l1", "io")
# the design as shipped, and with the changes named: fence stride, a
# thread's 4 keys consecutive in place of 32 apart, the fence copy
# through registers in place of cp.async, a register cap for 4 or 6 CTAs
# an SM, and parts left out to split the time
DESIGNS = {"shipped": {}, "fence16": {"fence": 16}, "fence32": {"fence": 32},
           "thread_keys": {"thread_keys": True}, "ldg_copy": {"ldg_copy": True},
           "min_ctas4": {"min_ctas": 4}, "min_ctas6": {"min_ctas": 6},
           "no_copy": {"drop": ("copy",)}, "no_search": {"drop": ("search",)},
           "no_lines": {"drop": ("lines",)}, "no_copy_lines": {"drop": ("copy", "lines")},
           "no_search_lines": {"drop": ("search", "lines")},
           "io_only": {"drop": ("copy", "lines", "search")}}
# the source texts each change replaces (each must be there), and their
# replacements ({} = the change's value)
_EDITS = {
    "fence": [(r"constexpr int FENCE = \d+;", "constexpr int FENCE = {};")],
    "thread_keys": [(r"return \(threadIdx\.x >> 5\) \* \(32 \* KEYS\) \+ j \* 32 \+ \(threadIdx\.x & 31\);",
                     "return threadIdx.x * KEYS + j;")],
    "ldg_copy": [(r'asm volatile\("cp\.async\.cg\.shared\.global \[%0\], \[%1\], 16;" ::"r"\(dst \+ 16 \* i\), "l"\(src \+ i\)\);',
                  "slice4[i] = __ldg(src + i);")],
    "min_ctas": [(r"__launch_bounds__\(THREADS\) sorted_intersect_kernel",
                  "__launch_bounds__(THREADS, {}) sorted_intersect_kernel")],
    "copy": [(r"i < n4; i \+= THREADS", "i < 0; i += THREADS")],
    "search": [(r"const int top = 1 << \(31 - __clz\(nf\)\);", "const int top = 1;")],
    "lines": [(r"const int4 v = __ldg\(reinterpret_cast<const int4\*>\(p\) \+ q\);",
               "const int4 v = make_int4(x, x, x, (int)(size_t)p);")],
}


# K2p's designs, each the shipped source with the texts named replaced
# (each must be there exactly once)
_KEYS_BULK_LOAD = """  // the team's first two tiles' keys into its two slots (bulk copies)
  const int end = __ldg(group_at + blockIdx.x + 1);
  const int team = (int)(threadIdx.x / K2P_TEAM);
  int k = __ldg(group_at + blockIdx.x) + team;
  const bool issuer = threadIdx.x % K2P_TEAM == 0;
  uint64_t* kb = kbar + 2 * team;
  int* kbuf = reinterpret_cast<int*>(win + 128) + 2 * team * TILE;
  if (issuer) {
    for (int i = 0; i < 2; ++i) {
      const int kk = k + i * K2P_IN_FLIGHT;
      if (kk < end) {
        mbar_expect_tx(kb + i, TILE * 4);
        bulk_copy(kbuf + i * TILE, l + (long long)__ldg(order + kk) * TILE, TILE * 4, kb + i);
      }
    }
  }
  if (wn > 0) mbar_wait(bar, 0);
  bool words_in = false;
  const auto wait_words = [&] {
    if (!words_in) {
      mbar_wait(bar + 1, 0);
      words_in = true;
    }
  };
  const int n_real = n_r - w0 * TILE;
  for (int i = 0; k < end; k += K2P_IN_FLIGHT, ++i) {
    const int t = __ldg(order + k);
    const int sp = __ldg(span + t), b = __ldg(base + t), s = __ldg(s_tile + t);
    mbar_wait(kb + (i & 1), (i >> 1) & 1);
    int x[K2P_KEYS];
#pragma unroll
    for (int j = 0; j < K2P_KEYS; ++j) x[j] = kbuf[(i & 1) * TILE + team_key0() + 32 * j];
    // the team has read the slot: it takes the tile after next
    asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(K2P_TEAM) : "memory");
    const int kn = k + 2 * K2P_IN_FLIGHT;
    if (issuer && kn < end) {
      mbar_expect_tx(kb + (i & 1), TILE * 4);
      bulk_copy(kbuf + (i & 1) * TILE, l + (long long)__ldg(order + kn) * TILE, TILE * 4,
                kb + (i & 1));
    }
    const long long at = (long long)t * TILE + team_key0();  // key j at at + 32 * j
"""
K2P_DESIGNS = ("first_design", "shipped", "two_in_flight", "keys_2", "keys_bulk",
               "one_barrier", "count_tree", "copies_only", "search_only", "no_lines",
               "no_run")
K2P_TARGETS = (1, 2, 4)  # groups an SM, for the shipped design
_K2P_EDITS = {
    "shipped": [],
    "two_in_flight": [("constexpr int K2P_THREADS = 1024;", "constexpr int K2P_THREADS = 512;"),
                      ("constexpr int K2P_IN_FLIGHT = 4;", "constexpr int K2P_IN_FLIGHT = 2;")],
    "keys_2": [("constexpr int K2P_IN_FLIGHT = 4;", "constexpr int K2P_IN_FLIGHT = 2;")],
    "keys_bulk": [
        ("constexpr int K2P_SMEM_FIXED = 16;",
         "constexpr int K2P_SMEM_FIXED = 128 + 2 * K2P_IN_FLIGHT * TILE * 4;"),
        ("  if (threadIdx.x == 0 && wn > 0) {\n    mbar_init(bar);\n",
         "  uint64_t* kbar = bar + 2;  // [team * 2 + slot], buffers at win + 128\n"
         "  if (threadIdx.x == 0) {\n    mbar_init(bar);\n"
         "    for (int i = 0; i < 2 * K2P_IN_FLIGHT; ++i) mbar_init(kbar + i);\n"),
        (None, _KEYS_BULK_LOAD),  # the tile loads up to the loop body, see _k2p_source
        ("    cur = nxt;\n  }\n", "  }\n"),
    ],
    "copies_only": [
        ("      span_counts(fs + (s - w0) * (TILE / FENCE), sp * (TILE / FENCE), rl, x, lo, hi,\n"
         "                  wait_words);",
         "      (void)rl;\n      wait_words();\n"
         "      for (int j = 0; j < K2P_KEYS; ++j) lo[j] = hi[j] = x[j] < fs[j] ? 1 : 0;"),
    ],
    "search_only": [
        ("    mbar_expect_tx(bar, fb);\n"
         "    bulk_copy(fs, fences + (long long)w0 * (TILE / FENCE), fb, bar);\n"
         "    mbar_expect_tx(bar + 1, wb + rb);\n"
         "    bulk_copy((void*)ws, words + (long long)w0 * (TILE / VPW), wb, bar + 1);\n"
         "    bulk_copy((void*)rs, refs + (long long)w0 * (TILE / FOR_BLOCK), rb, bar + 1);\n",
         "    (void)fb; (void)wb; (void)rb;\n"),
        ("  if (wn > 0) mbar_wait(bar, 0);\n", ""),
        ("      mbar_wait(bar + 1, 0);\n", ""),
        ("  if (threadIdx.x == 0 && wn > 0) mbar_wait(bar + 1, 0);\n", ""),
    ],
    "one_barrier": [
        ("    mbar_expect_tx(bar, fb);\n", "    mbar_expect_tx(bar, fb + wb + rb);\n"),
        ("    mbar_expect_tx(bar + 1, wb + rb);\n"
         "    bulk_copy((void*)ws, words + (long long)w0 * (TILE / VPW), wb, bar + 1);\n"
         "    bulk_copy((void*)rs, refs + (long long)w0 * (TILE / FOR_BLOCK), rb, bar + 1);\n",
         "    bulk_copy((void*)ws, words + (long long)w0 * (TILE / VPW), wb, bar);\n"
         "    bulk_copy((void*)rs, refs + (long long)w0 * (TILE / FOR_BLOCK), rb, bar);\n"),
        ("      mbar_wait(bar + 1, 0);\n", ""),
        ("  if (threadIdx.x == 0 && wn > 0) mbar_wait(bar + 1, 0);\n", ""),
    ],
    "no_lines": [("    rl.counts(line[j], x[j], lo[j], hi[j]);\n",
                  "    lo[j] = hi[j] = x[j] & 7;\n")],
    "no_run": [("    int c2 = line[j] + 2;\n", "    int c2 = line[j] + 2;\n    if (x[j] != -7) continue;\n")],
    "count_tree": [
        ("template <int VPW>\nstruct PackedLines {",
         "// #(f[j] < d) of 8 ascending offsets: a branch-free binary search\n"
         "__device__ __forceinline__ int sorted_below(const int (&f)[8], int d) {\n"
         "  const bool b4 = f[3] < d;\n"
         "  const bool b2 = (b4 ? f[5] : f[1]) < d;\n"
         "  const bool b1 = (b4 ? (b2 ? f[6] : f[4]) : (b2 ? f[2] : f[0])) < d;\n"
         "  return 4 * b4 + 2 * b2 + b1 + (b4 && b2 && b1 && f[7] < d);\n"
         "}\n\ntemplate <int VPW>\nstruct PackedLines {"),
        ("    lt = le = 0;\n"
         "    count4(make_int4(f[0], f[1], f[2], f[3]), d, lt, le);\n"
         "    count4(make_int4(f[4], f[5], f[6], f[7]), d, lt, le);\n"
         "    lt -= pads * (d > 0);\n"
         "    le += pads * ((x == INT32_MAX) - (d >= 0));\n",
         "    if (pads == 0) {\n"
         "      lt = sorted_below(f, d);\n"
         "      le = sorted_below(f, d + 1);\n"
         "    } else {\n"
         "      lt = le = 0;\n"
         "      count4(make_int4(f[0], f[1], f[2], f[3]), d, lt, le);\n"
         "      count4(make_int4(f[4], f[5], f[6], f[7]), d, lt, le);\n"
         "      lt -= pads * (d > 0);\n"
         "      le += pads * ((x == INT32_MAX) - (d >= 0));\n"
         "    }\n"),
    ],
}


def _k2p_source(src: str, design: str) -> str:
    """The K2p source of a design; raises where the shipped source no
    longer holds a text to replace."""
    for old, new in _K2P_EDITS[design]:
        if old is None:  # the span from the first tile's load to the loop body
            a = src.find("  // the team's first tile loads while the window comes in\n")
            end = "    const long long at = (long long)cur.t * TILE + team_key0();  // key j at at + 32 * j\n"
            b = src.find(end, a)
            if a < 0 or b < 0:
                raise SystemExit("k2_probe: csrc/sorted_intersect.cu has no key loads to replace")
            src = src[:a] + new + src[b + len(end):]
            continue
        if src.count(old) != 1:
            raise SystemExit(f"k2_probe: csrc/sorted_intersect.cu has {src.count(old)} of "
                             f"{old!r}")
        src = src.replace(old, new)
    return src


def _design_source(k2: str, spec: dict) -> str:
    """The K2 source with a design's changes; raises where the source
    no longer holds a text to change."""
    for key, value in spec.items():
        for part in value if key == "drop" else (key,):
            for pattern, repl in _EDITS[part]:
                if not re.search(pattern, k2):
                    raise SystemExit(f"k2_probe: csrc/sorted_intersect.cu has no {pattern!r}")
                k2 = re.sub(pattern, lambda m, r=repl.format(value): m.expand(r), k2)
    return k2


_PROBE_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
namespace {
constexpr int kTile = 1024;

// #{r[start + k] (<, or <= when LE) x : k < n}, n >= 1: branch-free,
// ceil(log2(n + 1)) (+1) steps for every key of a tile. MASK redirects
// each load into the first 1024 keys (timing only: wrong answers).
template <bool LE, bool MASK>
__device__ __forceinline__ int count_fixed(const int32_t* __restrict__ r, int start, int n, int x) {
  const int top = 1 << (31 - __clz(n));
  const int first = n - top;
  auto at = [&](int k) { return __ldg(r + start + (MASK ? (k & (kTile - 1)) : k)); };
  auto below = [&](int v) { return LE ? v <= x : v < x; };
  int c = (first > 0 && below(at(first - 1))) ? first : 0;
  for (int s = top >> 1; s > 0; s >>= 1) c = below(at(c + s - 1)) ? c + s : c;
  return c + below(at(c));
}

template <int V>
__global__ void probe_kernel(const int32_t* __restrict__ l, const int32_t* __restrict__ r,
                             const int32_t* __restrict__ s_tile, const int32_t* __restrict__ span,
                             const int32_t* __restrict__ base, long long n_l,
                             int32_t* __restrict__ lt, int32_t* __restrict__ eq) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_l) return;
  const long long t = i / kTile;
  const int sp = __ldg(span + t);
  const int b = __ldg(base + t);
  const int key = __ldg(l + i);
  if (sp <= 0 || V == 5) {
    lt[i] = b + (V == 5 ? (key & 0) : 0);
    eq[i] = 0;
    return;
  }
  if (V == 0) {  // the first design, as it shipped
    const long long start = (long long)__ldg(s_tile + t) * kTile;
    const long long end = start + (long long)sp * kTile;
    long long lo = start, hi = end;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (__ldg(r + mid) < key) lo = mid + 1; else hi = mid;
    }
    const long long lower = lo;
    hi = end;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (__ldg(r + mid) <= key) lo = mid + 1; else hi = mid;
    }
    lt[i] = b + (int32_t)(lower - start);
    eq[i] = (int32_t)(lo - lower);
    return;
  }
  const int start = __ldg(s_tile + t) * kTile;
  const int n = sp * kTile;
  if (V == 1) {
    int lo = start, hi = start + n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(r + mid) < key) lo = mid + 1; else hi = mid;
    }
    const int lower = lo;
    hi = start + n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(r + mid) <= key) lo = mid + 1; else hi = mid;
    }
    lt[i] = b + lower - start;
    eq[i] = lo - lower;
    return;
  }
  const int lower = count_fixed<false, V == 4>(r, start, n, key);
  const int upper = V == 3 ? lower : count_fixed<true, V == 4>(r, start, n, key);
  lt[i] = b + lower;
  eq[i] = upper - lower;
}

template <int V>
int launch(const void* l, const void* r, const void* s, const void* sp, const void* b,
           long long n_l, void* lt, void* eq, void* stream) {
  probe_kernel<V><<<(unsigned)((n_l + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)l, (const int32_t*)r, (const int32_t*)s, (const int32_t*)sp,
      (const int32_t*)b, n_l, (int32_t*)lt, (int32_t*)eq);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int hs_k2_probe(int v, const void* l, const void* r, const void* s, const void* sp,
                           const void* b, long long n_l, void* lt, void* eq, void* stream) {
  switch (v) {
    case 0: return launch<0>(l, r, s, sp, b, n_l, lt, eq, stream);
    case 1: return launch<1>(l, r, s, sp, b, n_l, lt, eq, stream);
    case 2: return launch<2>(l, r, s, sp, b, n_l, lt, eq, stream);
    case 3: return launch<3>(l, r, s, sp, b, n_l, lt, eq, stream);
    case 4: return launch<4>(l, r, s, sp, b, n_l, lt, eq, stream);
    default: return launch<5>(l, r, s, sp, b, n_l, lt, eq, stream);
  }
}
"""


def _build(build_dir: Path, parts) -> dict:
    """Compile the probe source and the current K2 source in each of
    ``DESIGNS`` (part ``k2``), K2p's first design and the K2p designs of
    ``K2P_DESIGNS`` (part ``k2p``, named ``k2p_<design>``), all ``nvcc``
    processes started together; load each library. Returns {name:
    (library, ptxas report)}."""
    from hyperspace_tpu_torch.ops import kernels as tk

    build_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    k2 = (tk._CSRC / tk._SOURCES[tk.K2]).read_text()
    if "k2" in parts:
        sources["probe"] = _PROBE_SRC
        for name, spec in DESIGNS.items():
            sources[name] = _design_source(k2, spec)
    if "k2p" in parts:
        sources["k2p_first_design"] = (Path(__file__).with_name("k2p_first_design.cu")
                                       .read_text())
        for design in K2P_DESIGNS[1:]:
            sources[f"k2p_{design}"] = _k2p_source(k2, design)
    procs = {}
    for name, src in sources.items():
        cu = build_dir / f"{name}.cu"
        cu.write_text(src)
        cmd = [tk._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xptxas", "-v", "-I", str(tk._CSRC), "-shared", "-Xcompiler", "-fPIC",
               "-o", str(build_dir / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out = {}
    for name, p in procs.items():
        report = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            raise SystemExit(f"k2_probe: nvcc failed for {name}:\n{report}")
        lib = ctypes.CDLL(str(build_dir / f"lib{name}.so"))
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        if name == "probe":
            lib.hs_k2_probe.argtypes = [ci, vp, vp, vp, vp, vp, ll, vp, vp, vp]
            lib.hs_k2_probe.restype = ci
        elif name == "k2p_first_design":
            lib.hs_sorted_intersect_packed.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, ll, ci, ci, ci, ci, ll, vp, vp, vp]
            lib.hs_sorted_intersect_packed.restype = ci
        elif name.startswith("k2p_"):
            lib.hs_sorted_intersect_packed.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ll, ci, ci, ci, ll,
                vp, vp, vp]
            lib.hs_sorted_intersect_packed.restype = ci
        else:
            lib.hs_sorted_intersect_fences.argtypes = [vp, ll, vp, vp]
            lib.hs_sorted_intersect_fences.restype = ci
            lib.hs_sorted_intersect.argtypes = [vp, vp, vp, vp, vp, vp, ll, ci, vp, vp, vp]
            lib.hs_sorted_intersect.restype = ci
        out[name] = (lib, report)
    return out


def _sass_opcodes(lib: Path, out: Path) -> dict:
    """``cuobjdump -sass`` of ``lib`` written to ``out``; per kernel, the
    count of each opcode in its SASS."""
    from hyperspace_tpu_torch.ops import kernels as tk

    text = subprocess.run([str(Path(tk._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out.write_text(text)
    ops, kernel = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : \S*?([a-z_]+_kernel)(?:ILi(\d+)E)?", ln)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            kernel = ops.setdefault(name, {})
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if m and kernel is not None:
            op = m.group(1).split(".")[0]
            kernel[op] = kernel.get(op, 0) + 1
    return ops


def traffic_bytes(plan) -> dict:
    """What the shipped design moves for a plan, in bytes: r's 32-byte
    sectors (one a key of each tile with a span), the fence slices (each
    tile's span, 512 bytes a right tile) and the compulsory traffic to and
    from HBM (keys in, two counts out, r and the plan's three arrays)."""
    from hyperspace_tpu_torch.ops import kernels as tk

    span, n_l, n_r = plan[1], len(plan[3]), len(plan[4])
    per_tile = tk.SMJ_TILE // tk.K2_FENCE * 4
    return {"lines": int((span > 0).sum()) * tk.SMJ_TILE * tk.K2_FENCE * 4,
            "slices": int(span.sum()) * per_tile,
            "hbm": 12 * n_l + 4 * n_r + 12 * len(span)}


def _shapes(seed: int, dev) -> dict:
    """{case: (plan, device operands)} at the Q3 join's shapes."""
    import torch

    import chip_smoke as cs
    from hyperspace_tpu_torch.ops import kernels as tk

    lineitem, orders = cs.make_tables(seed, cs.SF1_ORDERS, cs.SF1_LINEITEM)
    l_codes, r_sorted, _ = cs.k2_join_keys(lineitem, orders, dev)
    out = {}
    for name, l in (("index_layout", l_codes),
                    ("key_sorted", np.sort(lineitem["l_orderkey"], kind="stable"))):
        plan = tk._plan_sorted_intersect(l, r_sorted)
        out[name] = (plan, [torch.from_numpy(a).to(dev) for a in plan[:5]])
    return out


def k2p_traffic_bytes(plan, groups, n_l: int) -> dict:
    """What K2p's designs move at a plan, in bytes: the first design's
    fence slices (512 bytes a right tile of each span) and lines (one
    16-byte read of words a key of each tile with a span, vpw 2), the
    shipped design's windows (``k2p_tile_bytes`` a right tile of each),
    and the compulsory traffic (the function's bytes, each input once)."""
    from hyperspace_tpu_torch.ops import kernels as tk

    span = plan[1]
    win = np.asarray(groups.win_len.cpu() if hasattr(groups.win_len, "cpu") else groups.win_len)
    return {"first_design_slices": int(span.sum()) * tk.SMJ_TILE // tk.K2_FENCE * 4,
            "first_design_lines": int((span > 0).sum()) * tk.SMJ_TILE * 16,
            "windows": int(win.sum()) * tk.k2p_tile_bytes(groups.vpw),
            "groups": groups.n_groups, "max_window": groups.max_window,
            "mean_tiles_a_group": float(n_l / tk.SMJ_TILE / max(1, groups.n_groups))}


def _k2p_part(libs: dict, seed: int, dev) -> dict:
    """K2p's designs at the join region's shape, in turns; each full
    design held exactly against the plain version."""
    import torch

    import chip_smoke as cs
    from hyperspace_tpu_torch.ops import kernels as tk

    lineitem, orders = cs.make_tables(seed, cs.SF1_ORDERS, cs.SF1_LINEITEM)
    l_codes, r_sorted, _ = cs.k2_join_keys(lineitem, orders, dev)
    t, words, refs, fences, spec, lo_all, _r_p, plan = cs.k2p_operands(l_codes, r_sorted, dev)
    s_tile, span, base, l = t
    n_l, n_r_pad = int(l.shape[0]), int(fences.shape[0]) * tk.K2_FENCE
    want = tk.sorted_intersect_packed_reference(*t, words, refs, spec, lo_all, n_r_pad)
    b_ms, b_by = cs.bound(4 * n_l + 4 * int(words.shape[0]) + 4 * int(refs.shape[0])
                          + 4 * int(fences.shape[0]) + 8 * n_l, 0.0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups = {m: tk.plan_k2p_groups(plan[0], plan[1], spec.vpw, m * sms).to(dev)
              for m in K2P_TARGETS}
    lt = torch.empty(n_l, dtype=torch.int32, device=dev)
    eq = torch.empty_like(lt)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    max_span = int(plan[1].max())

    def first_design():
        rc = libs["k2p_first_design"][0].hs_sorted_intersect_packed(
            l.data_ptr(), words.data_ptr(), refs.data_ptr(), fences.data_ptr(),
            s_tile.data_ptr(), span.data_ptr(), base.data_ptr(), n_l, max_span, spec.vpw,
            spec.bits, int(lo_all), spec.n, lt.data_ptr(), eq.data_ptr(), stream())
        if rc:
            raise SystemExit(f"k2_probe: the first design's launch failed ({rc})")

    def grouped(design, g):
        lib = libs[f"k2p_{design}"][0]

        def call():
            rc = lib.hs_sorted_intersect_packed(
                l.data_ptr(), words.data_ptr(), refs.data_ptr(), fences.data_ptr(),
                s_tile.data_ptr(), span.data_ptr(), base.data_ptr(), g.order.data_ptr(),
                g.offsets.data_ptr(), g.win_lo.data_ptr(), g.win_len.data_ptr(), g.n_groups,
                g.max_window, n_r_pad, spec.vpw, spec.bits, int(lo_all), spec.n,
                lt.data_ptr(), eq.data_ptr(), stream())
            if rc:
                raise SystemExit(f"k2_probe: {design}'s launch failed ({rc})")
        return call

    calls = {"first_design": first_design}
    for m in K2P_TARGETS:
        calls[f"shipped_x{m}"] = grouped("shipped", groups[m])
    for design in K2P_DESIGNS[2:]:
        calls[design] = grouped(design, groups[K2P_TARGETS[0]])
    out = {"bound_ms": b_ms, "bound_by": b_by, "n_l": n_l, "n_r": len(r_sorted),
           "bits": spec.bits, "vpw": spec.vpw, "sms": sms, "wide_tiles": int(plan[-1].sum()),
           "mean_span": float(plan[1][~plan[-1]].mean()),
           "traffic_bytes": {m: k2p_traffic_bytes(plan, groups[m], n_l) for m in K2P_TARGETS},
           "designs": {}}
    cs.log(f"K2p probe: n_l={n_l} n_r={len(r_sorted)} bits={spec.bits} vpw={spec.vpw} "
           f"bound_ms={b_ms:.4f} ({b_by}) traffic={out['traffic_bytes']}")
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        exact = bool(torch.equal(lt, want[0]) and torch.equal(eq, want[1]))
        full = name not in ("copies_only", "search_only", "no_lines", "no_run")
        if full and not exact:
            raise SystemExit(f"k2_probe: K2p {name} disagrees with the plain version")
        out["designs"][name] = {"exact": exact, "device_ms": [], "ms": []}
    # in turns: each design once in order, then once in reverse order
    order = list(calls) + list(reversed(calls))
    for name in order:
        d = out["designs"][name]
        d["device_ms"].append(cs.device_ms(calls[name], "sorted_intersect_packed_kernel"))
        d["ms"].append(cs.time_ms(calls[name]))
    for name, d in out["designs"].items():
        cs.log(f"K2p {name}: device_ms={[cs._fmt(x) for x in d['device_ms']]} "
               f"ms={[round(x, 4) for x in d['ms']]} exact={d['exact']} bound_ms={b_ms:.4f}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="hyperspace_tpu_torch/_build/k2_probe.json")
    ap.add_argument("--parts", default="k2,k2p", help="comma list of k2 and k2p")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    if not parts or parts - {"k2", "k2p"}:
        ap.error(f"--parts: {args.parts!r} is not a comma list of k2 and k2p")

    import torch

    if not torch.cuda.is_available():
        print("k2_probe: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    from hyperspace_tpu_torch.ops import kernels as tk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.log(smi)
    dev = torch.device("cuda")
    libs = _build(tk._BUILD_DIR / "probe", parts)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    rec = {"device": smi, "ptxas": {}, "first_design": {}, "designs": {}}
    for name, (_lib, report) in libs.items():
        rec["ptxas"][name] = cs.ptxas_summary(report)
        cs.log(f"ptxas {name}: {rec['ptxas'][name]}")
    if "k2" in parts:
        rec["sass_opcodes"] = _sass_opcodes(tk._BUILD_DIR / "probe" / "libshipped.so",
                                            Path(args.out).with_name("k2_sass.txt"))
        cs.log(f"sass shipped: {rec['sass_opcodes']}")
    shapes = _shapes(args.seed, dev) if "k2" in parts else {}
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    if "k2p" in parts:
        rec["k2p_sass_opcodes"] = _sass_opcodes(tk._BUILD_DIR / "probe" / "libk2p_shipped.so",
                                                Path(args.out).with_name("k2p_sass.txt"))
        rec["k2p"] = _k2p_part(libs, args.seed, dev)

    for case, (plan, (s_tile, span, base, l, r)) in shapes.items():
        wide = plan[-1]
        keep = torch.from_numpy(np.repeat(~wide, tk.SMJ_TILE)).to(dev)
        want = tk.sorted_intersect_span_reference(s_tile, span, base, l, r)
        n_l = int(l.shape[0])
        b_ms, _ = cs.k2_bound(plan[1], n_l, int(r.shape[0]))
        lt = torch.empty(n_l, dtype=torch.int32, device=dev)
        eq = torch.empty_like(lt)
        per = rec["first_design"][case] = {"bound_ms": b_ms, "wide_tiles": int(wide.sum()),
                                           "mean_span": float(plan[1][~wide].mean()),
                                           "traffic_bytes": traffic_bytes(plan)}
        for v, vname in enumerate(VARIANTS):
            lib = libs["probe"][0]

            def call(v=v, lib=lib):
                rc = lib.hs_k2_probe(v, l.data_ptr(), r.data_ptr(), s_tile.data_ptr(),
                                     span.data_ptr(), base.data_ptr(), n_l, lt.data_ptr(),
                                     eq.data_ptr(), stream())
                if rc:
                    raise SystemExit(f"k2_probe: launch of {vname} failed ({rc})")

            call()
            torch.cuda.synchronize()
            exact = bool(torch.equal(lt[keep], want[0][keep]) and torch.equal(eq[keep], want[1][keep]))
            dev_ms = cs.device_ms(call, f"probe_kernel<{v}>")
            per[vname] = {"device_ms": dev_ms, "ms": cs.time_ms(call), "exact": exact}
            cs.log(f"first design {case} {vname}: device_ms={cs._fmt(dev_ms)} "
                   f"ms={per[vname]['ms']:.4f} exact={exact} bound_ms={b_ms:.4f}")
            if vname in ("base", "i32", "fixed") and not exact:
                raise SystemExit(f"k2_probe: {vname} disagrees with the span semantics")

        max_span = int(plan[1].max())
        for design, spec in DESIGNS.items():
            lib = libs[design][0]
            f = spec.get("fence", tk.K2_FENCE)
            fences = torch.empty(int(r.shape[0]) // f, dtype=torch.int32, device=dev)

            def build_fences(lib=lib, fences=fences):
                if lib.hs_sorted_intersect_fences(r.data_ptr(), int(r.shape[0]),
                                                  fences.data_ptr(), stream()):
                    raise SystemExit("k2_probe: fence launch failed")

            def call(lib=lib, fences=fences):
                if lib.hs_sorted_intersect(l.data_ptr(), r.data_ptr(), fences.data_ptr(),
                                           s_tile.data_ptr(), span.data_ptr(), base.data_ptr(),
                                           n_l, max_span, lt.data_ptr(), eq.data_ptr(),
                                           stream()):
                    raise SystemExit("k2_probe: K2 launch failed")

            build_fences()
            call()
            torch.cuda.synchronize()
            exact = bool(torch.equal(lt, want[0]) and torch.equal(eq, want[1]))
            if not torch.equal(fences, r[::f]) or ("drop" not in spec and not exact):
                raise SystemExit(f"k2_probe: {design} disagrees with the span semantics")
            dev_ms = cs.device_ms(call, "sorted_intersect_kernel")
            fence_ms = cs.device_ms(build_fences, "fence_build_kernel")
            rec["designs"].setdefault(case, {})[design] = {
                "device_ms": dev_ms, "fence_device_ms": fence_ms, "ms": cs.time_ms(call),
                "exact": exact}
            cs.log(f"{design} {case}: device_ms={cs._fmt(dev_ms)} "
                   f"fence_device_ms={cs._fmt(fence_ms)} "
                   f"ms={rec['designs'][case][design]['ms']:.4f} exact={exact} "
                   f"bound_ms={b_ms:.4f}")
    line = json.dumps(rec)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
