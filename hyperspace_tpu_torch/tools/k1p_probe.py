"""What bounds K1p (block counts over bit-packed planes) on the card, and
what each choice of its plan is worth.

Run from the repository root on a machine with a CUDA card:

    python3 -m hyperspace_tpu_torch.tools.k1p_probe [--seed 0] [--out PATH]

Two shapes, the planes made as ``chip_smoke.py`` makes li_st's
(l_orderkey raw, l_quantity 6 bits at 4 values a word, l_shipdate 12 bits
at 2) under its range filter: li_st's 18,006,016 padded rows (TPC-H SF3)
and one streaming window of 2^20 rows (128 blocks). At each:

- the shipped kernel at every sub-tile in ``SUB_ROWS`` (rows a ring
  stage holds, ``k1p_plan``), each held exactly against the plain
  version;
- K1c over the same rows raw;
- designs built from ``csrc/predicate_mask.cu`` with the changes named in
  ``DESIGNS``, each at the sub-tile beside its name: ``three_stages`` and
  ``four_stages`` give the ring 3 or 4 stages, ``raw_global`` keeps raw
  planes out of the ring and reads them straight from device memory
  (16-byte loads, as K1c does; the ring then holds the packed slices
  only), ``tree_or`` builds each compare's word from per-chunk nibbles
  joined as a tree (no chain through one register), all held exactly
  too; ``no_eval`` copies and waits but evaluates nothing, ``no_copy``
  evaluates stale shared memory and copies nothing (wrong counts: they
  split the time).

Times are device times from torch.profiler, each launch after an L2 flush
(``chip_smoke.device_ms``), beside CUDA-event times of the call
(``chip_smoke.time_ms``), with the bound (bytes read once over 3.35 TB/s).
Prints one JSON object as its last line and writes it to ``--out``
(default ``hyperspace_tpu_torch/_build/k1p_probe.json``).
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

SUB_ROWS = (8192, 4096, 2048, 1024)
SHAPES = {"li_st": 18_003_645, "window": 1 << 20}
# design -> the sub-tile it runs at (four stages of 8192 rows do not fit)
DESIGNS = {"three_stages": 8192, "four_stages": 4096, "raw_global": 8192, "tree_or": 8192,
           "no_eval": 8192, "no_copy": 8192}
_STAGES = "constexpr int K1P_STAGES = 2;"
# the source texts each design replaces (each must be there once), and
# their replacements
_EDITS = {
    "three_stages": [(_STAGES, _STAGES.replace("2", "3"))],
    "four_stages": [(_STAGES, _STAGES.replace("2", "4"))],
    "raw_global": [
        ("const int4 d, unsigned r0, int4 (&v)[KC]) {\n"
         "  const uint32_t* w = reinterpret_cast<const uint32_t*>(stage + s.off);",
         "const int4 d, unsigned r0, int4 (&v)[KC], long long g0) {\n"
         "  const uint32_t* w = s.lg == 0 ? reinterpret_cast<const uint32_t*>(s.src) + g0\n"
         "                                : reinterpret_cast<const uint32_t*>(stage + s.off);"),
        ("    for (int k = 0; k < KC; ++k) v[k] = reinterpret_cast<const int4*>(w)[(r0 >> 2) + k * 32];",
         "    for (int k = 0; k < KC; ++k) v[k] = __ldg(reinterpret_cast<const int4*>(w) + (r0 >> 2) + k * 32);"),
        ("uint32_t* stk, unsigned r0) {", "uint32_t* stk, unsigned r0, long long g0) {"),
        ("instr<STAGED>(p, sprog, ins.y), r0, a);", "instr<STAGED>(p, sprog, ins.y), r0, a, g0);"),
        ("instr<STAGED>(p, sprog, ins.w), r0, b);", "instr<STAGED>(p, sprog, ins.w), r0, b, g0);"),
        ("      off += (S >> lg) * 4;", "      if (lg) off += (S >> lg) * 4;"),
        ("      const Slice t = tab[c];\n", "      const Slice t = tab[c];\n      if (t.lg == 0) continue;\n"),
        ("      stage += 4LL * S / d.z;", "      if (d.z > 1) stage += 4LL * S / d.z;"),
        ("eval_packed<STAGED, KC>(p, sprog, tab, dsm + st * sb, stk, r0)",
         "eval_packed<STAGED, KC>(p, sprog, tab, dsm + st * sb, stk, r0, "
         "(long long)(blockIdx.x + (unsigned)(i >> lg_sub) * gridDim.x) * BLOCK_ROWS + "
         "(long long)(i & ((1 << lg_sub) - 1)) * S)"),
    ],
    "tree_or": [(
        "  uint32_t w = 0;\n"
        "#pragma unroll\n"
        "  for (int k = 0; k < KC; ++k) {\n"
        "    const int4 b = y(k);\n"
        "    w |= ((uint32_t)cmp1<OP>(a[k].x, b.x) << (4 * k)) |\n"
        "         ((uint32_t)cmp1<OP>(a[k].y, b.y) << (4 * k + 1)) |\n"
        "         ((uint32_t)cmp1<OP>(a[k].z, b.z) << (4 * k + 2)) |\n"
        "         ((uint32_t)cmp1<OP>(a[k].w, b.w) << (4 * k + 3));\n"
        "  }\n"
        "  return w;",
        "  uint32_t n[KC];\n"
        "#pragma unroll\n"
        "  for (int k = 0; k < KC; ++k) {\n"
        "    const int4 b = y(k);\n"
        "    n[k] = (uint32_t)cmp1<OP>(a[k].x, b.x) | ((uint32_t)cmp1<OP>(a[k].y, b.y) << 1) |\n"
        "           ((uint32_t)cmp1<OP>(a[k].z, b.z) << 2) | ((uint32_t)cmp1<OP>(a[k].w, b.w) << 3);\n"
        "  }\n"
        "#pragma unroll\n"
        "  for (int s = 1; s < KC; s *= 2) {\n"
        "#pragma unroll\n"
        "    for (int k = 0; k + s < KC; k += 2 * s) n[k] |= n[k + s] << (4 * s);\n"
        "  }\n"
        "  return n[0];")],
    "no_eval": [("acc += __popc(eval_packed<STAGED, KC>(p, sprog, tab, dsm + st * sb, stk, r0) & valid);",
                 "acc += 0u;")],
    "no_copy": [("mbar_expect_tx(&full[next_stage], sb);", "mbar_expect_tx(&full[next_stage], 0);"),
                ("      bulk_copy(stage + t.off, t.src + ((row0 >> t.lg) << 2), (S >> t.lg) << 2,\n"
                 "                &full[next_stage]);", "      (void)t;")],
}


def _build(tk, build_dir: Path) -> dict:
    """Each design's library (one nvcc each, all started together):
    name -> (ctypes library, ptxas report)."""
    src = (tk._CSRC / tk._SOURCES[tk.K1]).read_text()
    build_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in DESIGNS:
        text = src
        for old, new in _EDITS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"k1p_probe: csrc/predicate_mask.cu has {text.count(old)} of "
                                 f"{old!r}")
            text = text.replace(old, new)
        cu = build_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [tk._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xptxas", "-v", "-I", str(tk._CSRC), "-shared", "-Xcompiler", "-fPIC", "-o",
             str(build_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k1p_probe: nvcc {name}:\n{out.decode(errors='replace')}")
        lib = ctypes.CDLL(str(build_dir / f"lib{name}.so"))
        lib.hs_predicate_block_counts_packed.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                                         ctypes.c_void_p]
        lib.hs_predicate_block_counts_packed.restype = ctypes.c_int
        libs[name] = (lib, out.decode(errors="replace"))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="where the JSON goes")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k1p_probe: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    from hyperspace_tpu_torch.ops import bitpack
    from hyperspace_tpu_torch.ops import kernels as tk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.log(smi)
    dev = torch.device("cuda")
    tk.build_kernels((tk.K1,))
    libs = _build(tk, tk._BUILD_DIR / "k1p_probe")
    ptxas = {"shipped": cs.ptxas_summary(tk.build_report(tk.K1))}
    ptxas.update({name: cs.ptxas_summary(report) for name, (_lib, report) in libs.items()})
    rec = {"device": smi, "shapes": {},
           "ptxas": {d: {k: v for k, v in p.items() if "packed" in k} for d, p in ptxas.items()}}
    cs.log(f"ptxas K1p: {rec['ptxas']}")
    rng = np.random.default_rng(args.seed)
    top = 18_000_000
    pred = tk.narrow_expr_to_i32(cs.li_st_pred(top))
    names = tuple(sorted(pred.columns()))
    B = tk.BLOCK_ROWS
    for shape, n in SHAPES.items():
        n_pad = -(-n // B) * B
        planes = cs.li_st_planes(rng, n, top)
        cols, specs, raw = [], [], []
        for nm in names:
            v, sp = planes[nm]
            t = torch.zeros(n_pad, dtype=torch.int32, device=dev)
            t[:n] = torch.from_numpy(v.astype(np.int32)).to(dev)
            raw.append(t)
            if sp is None:
                cols.append(t)
            else:
                sp = bitpack.PackSpec(sp.bits, sp.vpw, n_pad, sp.ref0)
                padded = np.full(n_pad, sp.ref0, dtype=np.int64)
                padded[:n] = v
                cols.append(torch.from_numpy(bitpack.pack_plain(padded, sp)).to(dev))
            specs.append(sp)
        program = tk.packed_program(pred, names, specs)
        vpws = [int(d[2]) for d in tk.packed_header(specs)]
        want = tk.predicate_block_counts_packed_reference(pred, names, cols, specs, n_pad)
        n_bytes = 4 * sum(int(c.numel()) for c in cols) + 4 * (n_pad // B)
        raw_bytes = 4 * len(raw) * n_pad + 4 * (n_pad // B)
        out = rec["shapes"][shape] = {
            "rows": n_pad, "sub_rows": program.plan.sub_rows,
            "bound_ms": cs.bound(n_bytes, 0.0)[0], "raw_bound_ms": cs.bound(raw_bytes, 0.0)[0],
            "plans": {}, "designs": {}}

        def timed(label, run, kernel, exact):
            r = {"device_ms": cs.device_ms(run, kernel), "ms": cs.time_ms(run), "exact": exact}
            cs.log(f"{shape} {label}: device_ms={cs._fmt(r['device_ms'])} ms={r['ms']:.4f} "
                   f"bound_ms={out['bound_ms']:.4f} exact={exact}")
            return r

        for rows in SUB_ROWS:
            def run(rows=rows):
                return tk.program_block_counts_packed_tensor(program, cols, specs, n_pad, rows)

            cs._held(f"K1p {shape} sub_rows={rows}", run(), want)
            r = timed(f"K1p sub_rows={rows}", run, "predicate_block_counts_packed_kernel", True)
            out["plans"][str(rows)] = {
                **r, "smem": tk.k1p_plan(vpws, len(program.code), program.depth, rows).smem}

        counts = torch.empty(n_pad // B, dtype=torch.int32, device=dev)
        for design, rows in DESIGNS.items():
            lib = libs[design][0]
            stage = sum(0 if v == 1 and design == "raw_global" else 4 * rows // v for v in vpws)
            blob = program.params([c.data_ptr() for c in cols], n_pad, counts.data_ptr())
            extra = struct.pack("<2i", rows, stage)

            def run(lib=lib, blob=blob, extra=extra):
                rc = lib.hs_predicate_block_counts_packed(
                    blob, extra, torch.cuda.current_stream(dev).cuda_stream)
                if rc:
                    raise SystemExit(f"k1p_probe: launch failed ({rc})")
                return counts

            run()
            exact = bool(torch.equal(counts, want))
            if not design.startswith("no_") and not exact:
                raise SystemExit(f"k1p_probe: {design} disagrees with the plain version")
            out["designs"][design] = {
                **timed(f"{design} sub_rows={rows}", run,
                        "predicate_block_counts_packed_kernel", exact), "sub_rows": rows}

        def k1c():
            return tk.predicate_block_counts_tensor(pred, names, raw)

        cs._held(f"K1c {shape}", k1c(), tk.predicate_block_counts_reference(pred, names, raw))
        out["k1c_raw"] = timed("K1c raw", k1c, "predicate_block_counts_kernel", True)
        del cols, raw
        torch.cuda.empty_cache()
    line = json.dumps(rec)
    path = Path(args.out or tk._BUILD_DIR / "k1p_probe.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
