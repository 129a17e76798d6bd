"""K1b and K1hb (N predicates over one table's planes in one launch): the
redesign against the first design, and what each part of the redesign
costs, on the card.

Run from the repository root on a machine with a CUDA card:

    python3 -m hyperspace_tpu_torch.tools.k1b_probe [--seed 0] [--out PATH]

The cases are ``chip_smoke.py``'s timed ones (``chip_smoke.K1B_TIMED``,
operands from ``chip_smoke.K1bInputs``): B1 (64 point lookups over SF1
lineitem's order keys), B2 (16 ranges over order key and ship date), L2
(16 ranges over li_st's three planes at SF3, two of them packed), L3 (the
same over one 2^20-row window) and the hybrid burst (K1hb: 16 ranges over
li_hy's base and delta, one source file's rows deleted), each at the
index layout (bucket, then key: what the served planes hold), in key
order where the case has one, and shuffled (no chunk resolves). At each:

- the first design (``tools/k1b_first_design.cu``: one CTA a block, the
  planes staged by all threads, every program interpreted over every
  row, the programs in a device buffer copied for each launch) and the
  shipped kernel in turns (first, shipped, shipped, first), device times
  from torch.profiler after an L2 flush (``chip_smoke.device_ms``), and
  each one's wrapper (lowering cache, packing, launch) by CUDA events
  (``chip_smoke.time_ms``); the bound (``chip_smoke.k1b_bound``: bytes
  read once, or the operations these inputs need) and each one's share
  of it. Both are held exactly against the plain version.

The shipped kernels' SASS goes beside the JSON (``k1b_sass.txt``), its
instructions and branches per instantiation into it. At the index layout
also (shipped source edited, ``DESIGNS``):
``no_range_test`` counts every program row by row (exact: what the range
test saves), ``no_judge`` judges no program (wrong counts: the ring, the
decode and the intervals alone), ``copy_only`` only waits for the copies
(wrong counts), ``no_copy`` evaluates stale shared memory (wrong counts:
the compute alone), ``one_round`` judges only the first 32 programs,
``no_rows`` counts no program row by row, ``ctas4`` caps registers for
four CTAs an SM where a launch has at most one plane, ``empty`` gives every CTA no
item (the launch and the CTA's set-up alone), ``timed`` counts each
consumer warp's cycles by phase (clock64); and the shipped kernel
under other plans (rings of 2, 3 and 4 stages; sub-tiles of 4096, 2048
and 1024 rows). ``--cases`` and ``--designs`` narrow a run.

Prints one JSON object as its last line and writes it to ``--out``
(default ``hyperspace_tpu_torch/_build/k1b_probe.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np

# the source texts each design replaces (each must be there once), and
# their replacements
_EDITS = {
    "no_range_test": [
        ("  return (int)(may & 1u) | ((int)(must & 1u) << 1);", "  return T_MAYBE;"),
        ("      uint32_t w = must ? 0xffffffffu : 0u;\n      if (may && !must) {",
         "      uint32_t w = 0u;\n      if (may || !may) {"),
        ("  return all ? T_ALL : T_MAYBE;", "  return T_MAYBE;"),
        ("    if ((hi < b.y || first > bhi) && (last < b.y || lo > bhi)) return T_NONE;",
         "    (void)bhi;\n    (void)first;\n    (void)last;"),
        ("    if ((unsigned)lo - (unsigned)b.y <= span && (unsigned)hi - (unsigned)b.y <= span) continue;",
         "    (void)lo;\n    (void)hi;"),
    ],
    "no_judge": [("    for (int q0 = 0; q0 < np; q0 += 32) {",
                  "    for (int q0 = 0; q0 < 0; q0 += 32) {")],
    "copy_only": [("    mbar_wait(&full[st], parity);\n    const unsigned char* stage = dsm + st * sb;",
                   "    mbar_wait(&full[st], parity);\n"
                   "    if (np > 0) {\n"
                   "      __syncwarp();\n"
                   "      if (lane == 0) mbar_arrive(&empty[st]);\n"
                   "      if (++st == nst) {\n"
                   "        st = 0;\n"
                   "        parity ^= 1u;\n"
                   "      }\n"
                   "      continue;\n"
                   "    }\n"
                   "    const unsigned char* stage = dsm + st * sb;")],
    "no_copy": [
        ("        mbar_expect_tx(&full[st], sb);", "        mbar_expect_tx(&full[st], 0);"),
        ("          bulk_copy(stage + t.off, reinterpret_cast<const char*>(a[c]) + ((row0 >> t.lg) << 2),\n"
         "                    (S >> t.lg) << 2, &full[st]);",
         "          (void)t;\n          (void)a;\n          (void)row0;\n          (void)stage;"),
    ],
    "one_round": [("    for (int q0 = 0; q0 < np; q0 += 32) {",
                   "    for (int q0 = 0; q0 < min(np, 32); q0 += 32) {")],
    "no_rows": [("      while (maybe) {", "      while (maybe && np < 0) {")],
    "empty": [("  const int n_items = (long long)blockIdx.x < nb",
               "  const int n_items = nb < 0 && (long long)blockIdx.x < nb")],
    "ctas4": [("constexpr int k1b_min_ctas(int nc) { return nc == 1 ? 3 : 2; }",
               "constexpr int k1b_min_ctas(int nc) { return nc == 1 ? 4 : 2; }")],
    # clock64() per consumer warp: waits on full, decode and intervals, the
    # row-by-row counts (and how many), the rest of the judging, the whole
    "timed": [
        ("// K1b / K1hb. Persistent CTAs as K1p's",
         "__device__ unsigned long long hs_prof_buf[4096 * 9 * 6];\n\n"
         "// K1b / K1hb. Persistent CTAs as K1p's"),
        ("  uint32_t parity = 0;\n  for (int i = 0, st = 0; i < n_items; ++i) {",
         "  uint32_t parity = 0;\n"
         "  long long pw = 0, pd = 0, pr = 0, pt = 0, ne = 0, t1 = 0, t2 = 0;\n"
         "  const long long tk0 = clock64();\n"
         "  for (int i = 0, st = 0; i < n_items; ++i) {"),
        ("    mbar_wait(&full[st], parity);\n    const unsigned char* stage",
         "    { const long long t0 = clock64(); mbar_wait(&full[st], parity); t1 = clock64();"
         " pw += t1 - t0; }\n    const unsigned char* stage"),
        ("    const int buf = j % nst;", "    t2 = clock64(); pd += t2 - t1;\n    const int buf = j % nst;"),
        ("      uint32_t maybe = __ballot_sync(0xffffffffu, t == T_MAYBE);",
         "      uint32_t maybe = __ballot_sync(0xffffffffu, t == T_MAYBE);\n"
         "      const long long t3 = clock64();\n      ne += __popc(maybe);"),
        ("          if (lane == bq[u]) wc[q0 + bq[u]] += c;\n        }\n      }\n    }",
         "          if (lane == bq[u]) wc[q0 + bq[u]] += c;\n        }\n      }\n"
         "      pr += clock64() - t3;\n    }"),
        ("    if (lane == 0) mbar_arrive(&empty[st]);  // the warp is done with stage st",
         "    pt += clock64() - t2;\n    if (lane == 0) mbar_arrive(&empty[st]);"),
        ("      parity ^= 1u;\n    }\n  }\n}\n\nusing BatchFn",
         "      parity ^= 1u;\n    }\n  }\n"
         "  if (lane == 0 && blockIdx.x < 4096) {\n"
         "    unsigned long long* o = hs_prof_buf + ((long long)blockIdx.x * 9 + warp) * 6;\n"
         "    o[0] = pw; o[1] = pd; o[2] = pr; o[3] = pt; o[4] = ne; o[5] = clock64() - tk0;\n"
         "  }\n}\n\nusing BatchFn"),
        ("extern \"C\" int hs_batch_param_bytes()",
         "extern \"C\" int hs_prof_read(void* dst, int bytes) {\n"
         "  return (int)cudaMemcpyFromSymbol(dst, hs_prof_buf, bytes);\n}\n\n"
         "extern \"C\" int hs_batch_param_bytes()"),
    ],
}
DESIGNS = tuple(_EDITS)
EXACT = ("no_range_test",)
PLANS = {"stages2": {"stages": 2}, "stages3": {"stages": 3}, "stages4": {"stages": 4},
         "sub4096": {"sub_rows": 4096}, "sub2048": {"sub_rows": 2048},
         "sub1024": {"sub_rows": 1024}}
FIRST_SUB_ROWS = (8192, 4096, 2048, 1024, 512, 256, 128)  # the first design's sub-tiles


def _build(tk, build_dir: Path, designs) -> dict:
    """The first design's library and one per design of ``designs`` (one
    nvcc each, all started together): name -> (ctypes library, ptxas
    report)."""
    src = (tk._CSRC / tk._SOURCES[tk.K1]).read_text()
    build_dir.mkdir(parents=True, exist_ok=True)
    sources = {"first_design": Path(__file__).with_name("k1b_first_design.cu").read_text()}
    for name in designs:
        edits = _EDITS[name]
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"k1b_probe: csrc/predicate_mask.cu has {text.count(old)} of "
                                 f"{old!r}")
            text = text.replace(old, new)
        sources[name] = text
    procs = {}
    for name, text in sources.items():
        cu = build_dir / f"k1b_{name}.cu"
        cu.write_text(text)
        cmd = [tk._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xptxas", "-v", "-I", str(tk._CSRC), "-shared", "-Xcompiler", "-fPIC",
               "-o", str(build_dir / f"libk1b_{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out = {}
    for name, p in procs.items():
        report = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            raise SystemExit(f"k1b_probe: nvcc failed for {name}:\n{report}")
        lib = ctypes.CDLL(str(build_dir / f"libk1b_{name}.so"))
        for entry in (lib.hs_predicate_block_counts_batch, lib.hs_hybrid_block_counts_batch):
            entry.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
            entry.restype = ctypes.c_int
        out[name] = (lib, report)
    return out


def _sass_summary(tk, lib: Path, out: Path) -> dict:
    """``cuobjdump -sass`` of ``lib`` written to ``out``; per instantiation
    of the batch kernel, its instructions and the count of each branch
    and barrier opcode (an indirect branch, BRX, is a switch the compiler
    kept)."""
    import re

    text = subprocess.run([str(Path(tk._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out.write_text(text)
    per, kernel = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : \S*?(block_counts_batch\w*?_kernel)(?:ILi(\d+)ELi(\d+)E)?", ln)
        if m:
            name = m.group(1) + (f"<{m.group(2)},{m.group(3)}>" if m.group(2) else "")
            kernel = per.setdefault(name, {"instructions": 0})
            continue
        if "Function :" in ln:
            kernel = None
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if m and kernel is not None:
            op = m.group(1).split(".")[0]
            kernel["instructions"] += 1
            if op in ("BRX", "BRA", "BSSY", "BSYNC", "BAR", "WARPSYNC", "SYNCS", "LDL", "STL"):
                kernel[op] = kernel.get(op, 0) + 1
    return per


def _operands(tk, inp: dict):
    """(programs, addresses, descriptors, nb_base, deletion mask's address)
    of a case's launch, as the wrappers make them."""
    progs = tk.batch_programs(inp["preds"], inp["names"])
    if inp["kind"] == "k1hb":
        addrs = [t.data_ptr() for t in inp["base"]] + [t.data_ptr() for t in inp["delta"]]
        return (progs, addrs, tk.packed_header([None] * len(inp["names"])),
                inp["n_base"] // tk.BLOCK_ROWS, inp["words"].data_ptr())
    return (progs, [t.data_ptr() for t in inp["cols"]], tk.packed_header(inp["specs"]),
            inp["n_rows"] // tk.BLOCK_ROWS, 0)


def _first_design_call(tk, lib, inp: dict, out):
    """A launch of the first design over ``inp`` into ``out``, packed as its
    wrapper packed it: the programs, offsets, descriptors and addresses in
    one device buffer copied for the launch."""
    import torch

    progs, addrs, descs, nb_base, del_addr = _operands(tk, inp)
    N, n_cols = len(progs), len(descs)
    depth = max(p.depth for p in progs)
    fixed = 16 * n_cols + (-(-4 * N // 16) * 16) + 4 * depth * tk.K1C_THREADS
    rows = next(r for r in FIRST_SUB_ROWS
                if sum(4 * r // v for v in descs[:, 2].tolist()) + fixed <= tk.K1_MAX_SMEM)
    stage = sum(4 * rows // v for v in descs[:, 2].tolist())
    dev = out.device
    hybrid = inp["kind"] == "k1hb"

    def call():
        code = np.concatenate([p.prog for p in progs])
        offs = np.zeros(N + 1, dtype=np.int32)
        offs[1:] = np.cumsum([len(p.prog) for p in progs])
        parts = [np.ascontiguousarray(a, dtype=dt).reshape(-1).view(np.uint8)
                 for a, dt in ((addrs, np.int64), (descs, np.int32), (code, np.int32),
                               (offs, np.int32))]
        starts, total = [], 0
        for a in parts:
            starts.append(total)
            total += -(-a.size // 16) * 16
        host = np.zeros(total, dtype=np.uint8)
        for a, st in zip(parts, starts):
            host[st: st + a.size] = a
        buf = torch.from_numpy(host).to(dev)
        base = buf.data_ptr()
        params = struct.pack("<6q2q6i", base + starts[2], base + starts[3], base + starts[1],
                             base + starts[0], del_addr, out.data_ptr(), inp["n_rows"], nb_base,
                             N, n_cols, rows, stage, depth, 0)
        entry = lib.hs_hybrid_block_counts_batch if hybrid else lib.hs_predicate_block_counts_batch
        if entry(params, torch.cuda.current_stream(dev).cuda_stream):
            raise SystemExit("k1b_probe: the first design's launch failed")
        return out

    return call


def _design_call(tk, lib, inp: dict, out):
    """A launch of a design built from the shipped source, packed by the
    shipped wrapper's ``batch_launch_params``."""
    import torch

    progs, addrs, descs, nb_base, del_addr = _operands(tk, inp)
    hybrid = inp["kind"] == "k1hb"

    def call():
        params, buf, _plan = tk.batch_launch_params(progs, addrs, descs, inp["n_rows"], nb_base,
                                                    del_addr, out, out.device)
        entry = lib.hs_hybrid_block_counts_batch if hybrid else lib.hs_predicate_block_counts_batch
        if entry(params, torch.cuda.current_stream(out.device).cuda_stream):
            raise SystemExit("k1b_probe: a design's launch failed")
        del buf
        return out

    return call


def _timed(tk, lib, inp: dict, want, grid: int) -> dict:
    """One launch of the ``timed`` design: per consumer warp, the cycles
    waiting on the stage, decoding, counting row by row (and how many
    programs it counted so), judging otherwise, and in all; the means over
    the warps that had items, and the largest whole."""
    import torch

    n = 4096 * 9 * 6
    buf = (ctypes.c_ulonglong * n)()
    lib.hs_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.hs_prof_read.restype = ctypes.c_int
    call = _design_call(tk, lib, inp, torch.empty_like(want))
    out = call()
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise SystemExit("k1b_probe: the timed design disagrees")
    if lib.hs_prof_read(ctypes.addressof(buf), 8 * n):
        raise SystemExit("k1b_probe: reading the timed design's counters failed")
    a = np.frombuffer(buf, dtype=np.uint64).reshape(4096, 9, 6)[:grid, :8].reshape(-1, 6)
    a = a[a[:, 5] > 0].astype(np.float64)
    names = ("wait", "decode", "rows", "judge_and_rows", "rows_counted", "whole")
    rec = {k: float(a[:, i].mean()) for i, k in enumerate(names)}
    rec["whole_max"] = float(a[:, 5].max())
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="hyperspace_tpu_torch/_build/k1b_probe.json")
    ap.add_argument("--cases", default="", help="comma list of case@layout (default: all)")
    ap.add_argument("--designs", default=",".join(DESIGNS),
                    help=f"comma list of {', '.join(DESIGNS)}")
    args = ap.parse_args()
    designs = [d for d in args.designs.split(",") if d]
    if set(designs) - set(DESIGNS):
        ap.error(f"--designs: {args.designs!r} names a design not in {DESIGNS}")
    only = {c for c in args.cases.split(",") if c}

    import torch

    if not torch.cuda.is_available():
        print("k1b_probe: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    from hyperspace_tpu_torch.ops import kernels as tk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.log(smi)
    dev = torch.device("cuda")
    tk.build_kernels((tk.K1,))
    libs = _build(tk, tk._BUILD_DIR / "probe", designs)
    rec = {"device": smi, "ptxas": {}, "cases": {}}
    for name, (_lib, report) in [("shipped", (None, tk.build_report(tk.K1)))] + list(libs.items()):
        rec["ptxas"][name] = {k: v for k, v in cs.ptxas_summary(report).items()
                              if "batch" in k}
        cs.log(f"ptxas {name}: {rec['ptxas'][name]}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    rec["sass"] = _sass_summary(tk, tk._lib_path(tk.K1)[1],
                                Path(args.out).with_name("k1b_sass.txt"))
    cs.log(f"sass shipped: {rec['sass']}")
    L, _O = cs.make_tables(args.seed, cs.SF1_ORDERS, cs.SF1_LINEITEM)
    inputs = cs.K1bInputs(L, dev)
    for case, layouts in cs.K1B_TIMED.items():
        for layout in layouts:
            if only and f"{case}@{layout}" not in only:
                continue
            inp = inputs.case(case, layout)
            want = cs.k1b_plain(inp)
            shape = []
            cs.k1b_run(inp, shape=shape)
            grid, per_sm, inst, plan = shape
            b_ms, b_by, ops = cs.k1b_bound(inp, plan.sub_rows)
            out = torch.empty_like(want)
            first = _first_design_call(tk, libs["first_design"][0], inp, out)
            first()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit(f"k1b_probe: the first design disagrees at {case} {layout}")
            shipped = lambda inp=inp: cs.k1b_wrapper(inp)  # noqa: E731
            if not torch.equal(shipped(), want):
                raise SystemExit(f"k1b_probe: the shipped kernel disagrees at {case} {layout}")
            turns = [cs.device_ms(first, "block_counts_batch_first_kernel"),
                     cs.device_ms(shipped, "block_counts_batch_kernel"),
                     cs.device_ms(shipped, "block_counts_batch_kernel"),
                     cs.device_ms(first, "block_counts_batch_first_kernel")]
            r = rec["cases"][f"{case}@{layout}"] = {
                "n": len(inp["preds"]), "rows": inp["n_rows"], "bound_ms": b_ms,
                "bound_by": b_by, "needed_ops": ops, "sub_rows": plan.sub_rows,
                "stages": plan.stages, "grid": grid, "ctas_per_sm": per_sm,
                "first_design_device_ms": [turns[0], turns[3]],
                "device_ms": [turns[1], turns[2]],
                "first_design_ms": cs.time_ms(first), "ms": cs.time_ms(shipped)}
            dev_ms = min(x for x in r["device_ms"] if x is not None)
            first_ms = min(x for x in r["first_design_device_ms"] if x is not None)
            r["share_of_bound"] = b_ms / dev_ms
            r["first_design_share_of_bound"] = b_ms / first_ms
            cs.log(f"{case}@{layout}: first design device_ms={r['first_design_device_ms']} "
                   f"ms={r['first_design_ms']:.4f} | shipped device_ms={r['device_ms']} "
                   f"ms={r['ms']:.4f} | bound_ms={b_ms:.4f} ({b_by}) share "
                   f"{r['share_of_bound']:.3f} (first {r['first_design_share_of_bound']:.3f}) | "
                   f"sub_rows={plan.sub_rows} stages={plan.stages} grid={grid} "
                   f"ctas_per_sm={per_sm}")
            if layout == "index" or (case in ("B1", "L2") and layout == "shuffled"):
                r["designs"], r["plans"] = {}, {}
                for name in designs:
                    if name == "timed":
                        r["timed"] = _timed(tk, libs[name][0], inp, want, grid)
                        cs.log(f"{case}@{layout} timed (cycles a consumer warp, mean over "
                               f"warps): {r['timed']}")
                        continue
                    call = _design_call(tk, libs[name][0], inp, torch.empty_like(want))
                    exact = bool(torch.equal(call(), want))
                    if name in EXACT and not exact:
                        raise SystemExit(f"k1b_probe: {name} disagrees at {case} {layout}")
                    r["designs"][name] = {"device_ms": cs.device_ms(call,
                                                                    "block_counts_batch_kernel"),
                                          "exact": exact}
                    cs.log(f"{case}@{layout} {name}: device_ms="
                           f"{cs._fmt(r['designs'][name]['device_ms'])} exact={exact}")
                for name, over in PLANS.items():
                    run = lambda inp=inp, over=over: cs.k1b_run(inp, **over)  # noqa: E731
                    if not torch.equal(run(), want):
                        raise SystemExit(f"k1b_probe: plan {name} disagrees at {case} {layout}")
                    r["plans"][name] = cs.device_ms(run, "block_counts_batch_kernel")
                    cs.log(f"{case}@{layout} plan {name}: device_ms={cs._fmt(r['plans'][name])}")
            del inp, want, out
            torch.cuda.empty_cache()
    line = json.dumps(rec)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
