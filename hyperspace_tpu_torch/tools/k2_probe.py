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

Prints one JSON object as its last line and writes it to ``--out``, with
the opcode counts of the shipped design's SASS (``cuobjdump -sass``),
whose text goes beside it (``k2_sass.txt``).
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


def _build(build_dir: Path) -> dict:
    """Compile the probe source and the current K2 source in each of
    ``DESIGNS``, all ``nvcc`` processes started together; load each
    library. Returns {name: (library, ptxas report)}."""
    from hyperspace_tpu_torch.ops import kernels as tk

    build_dir.mkdir(parents=True, exist_ok=True)
    sources = {"probe": _PROBE_SRC}
    k2 = (tk._CSRC / tk._SOURCES[tk.K2]).read_text()
    for name, spec in DESIGNS.items():
        sources[name] = _design_source(k2, spec)
    procs = {}
    for name, src in sources.items():
        cu = build_dir / f"{name}.cu"
        cu.write_text(src)
        cmd = [tk._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
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
        m = re.search(r"Function : \S*?([a-z_]+_kernel)", ln)
        if m:
            kernel = ops.setdefault(m.group(1), {})
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="hyperspace_tpu_torch/_build/k2_probe.json")
    args = ap.parse_args()

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
    libs = _build(tk._BUILD_DIR / "probe")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    rec = {"device": smi, "ptxas": {}, "first_design": {}, "designs": {}}
    for name, (_lib, report) in libs.items():
        rec["ptxas"][name] = cs.ptxas_summary(report)
        cs.log(f"ptxas {name}: {rec['ptxas'][name]}")
    rec["sass_opcodes"] = _sass_opcodes(tk._BUILD_DIR / "probe" / "libshipped.so",
                                        Path(args.out).with_name("k2_sass.txt"))
    cs.log(f"sass shipped: {rec['sass_opcodes']}")
    shapes = _shapes(args.seed, dev)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731

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
