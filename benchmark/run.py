#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``hyperspace_tpu_torch``).

Run one cell of ``BENCHMARK.json`` from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's tables from the seed, writes them as avro, builds
the covering indexes its mix reads with the port, makes them resident on
the card and warms every query shape through the port's query server.
The window then runs the mix's clients in a closed loop for ``--seconds``.
Once it closes, every answer is held to the plain reference
(``benchmark/reference/``). Standard error ends with each number compared
beside its limit; standard output ends with one JSON line: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a ``torch.profiler`` trace of the window and the
program's counters and timers.

It needs as many CUDA cards as the cell names and exits 2 without them.
``--rehearse-on-cpu SCALE`` runs the same steps on the CPU at SCALE times
the configuration's rows, for the harness's own tests; its numbers
describe no device.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
sys.path[:0] = [str(BENCH_DIR), str(REPO)]

from hsbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hyperspace_tpu")
# answers with more groups than this are kept whole only where the seed's
# draw picks them (WHOLE_SHARE); of the others the groups and the total
# count are compared
WHOLE_ROWS = 100_000
WHOLE_SHARE = 0.05


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_header() -> dict:
    import torch

    out = {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        out["nvidia_smi"] = q.stdout.strip().splitlines()[0] if q.stdout.strip() else q.stderr
    except (OSError, subprocess.SubprocessError) as e:
        out["nvidia_smi"] = repr(e)
    return out


def telemetry_report() -> dict:
    from hyperspace_tpu_torch.telemetry.metrics import metrics

    return metrics.report()


def telemetry_delta(before: dict, after: dict) -> dict:
    """What the window added: counters, timers as (seconds, count) and
    histograms as (sum, count)."""
    cb, ca = before["counters"], after["counters"]
    counters = {k: v - cb.get(k, 0) for k, v in ca.items() if v != cb.get(k, 0)}
    timers = {}
    for k, s in after["timers_s"].items():
        n = after["timer_counts"][k] - before["timer_counts"].get(k, 0)
        if n:
            timers[k] = (s - before["timers_s"].get(k, 0.0), n)
    hists = {}
    for k, h in after["histograms"].items():
        hb = before["histograms"].get(k, {"sum": 0.0, "count": 0})
        if h["count"] - hb["count"]:
            hists[k] = (h["sum"] - hb["sum"], h["count"] - hb["count"])
    return {"counters": counters, "timers": timers, "histograms": hists}


def shape_latencies(mix, win) -> dict:
    """Per shape: queries answered and their median latency in ms."""
    import statistics

    out = {}
    for i, shape in enumerate(mix.shapes):
        lat = [(r[4] - r[3]) * 1e3 for r in win.records if r[0][0] == i]
        out[shape.name] = [len(lat), round(statistics.median(lat), 3) if lat else None]
    return out


def timeline(win) -> list:
    """Queries answered in each whole second of the window."""
    counts = [0] * int(win.seconds)
    for r in win.records:
        i = int(r[4] - win.start)
        if 0 <= i < len(counts):
            counts[i] += 1
    return counts


def warm_shapes(server, mix, frames) -> dict:
    """Each shape once through the server: it has to run on the device
    aggregate (``compile.agg.device``) with no decline; then every
    parameter set planned into the server's plan cache."""
    from hyperspace_tpu_torch.telemetry.metrics import metrics

    routes = {}
    for s, shape in enumerate(mix.shapes):
        before = metrics.snapshot()
        server.submit(frames[s][0]).result(timeout=600)
        after = metrics.snapshot()
        moved = {k: after[k] - before.get(k, 0) for k in after
                 if k.startswith("compile.agg.") and after[k] != before.get(k, 0)}
        routes[shape.name] = moved
        if moved.get("compile.agg.device") != 1 or any("declined" in k for k in moved):
            raise RuntimeError(f"warm-up: {shape.name} did not run on the device aggregate: "
                               f"{moved}")
    for row in frames:
        for df in row:
            server.plan_cache.optimized_plan_with_token(df)
    return routes


def run_cell(args, bench: dict, cell: dict, workdir: Path) -> dict:
    import torch

    from hsbench import check, devtrace, host, loop, system, traffic
    from hsbench.tpch import int_bounds, make_tables

    rehearse = args.rehearse_on_cpu is not None
    device = "cpu" if rehearse else "cuda"
    cfg = spec.config(bench, cell["config"])
    mix_spec = spec.traffic(cell["traffic"])
    kernel_build = system.build_kernels_async(on_card=not rehearse)
    header = {} if rehearse else card_header()
    log(f"cell {cell['name']}: config {cfg['name']}, traffic {cell['traffic']}, seed {args.seed}, "
        f"window {args.seconds} s, trace {args.trace}, {header}")

    rows = spec.rows(cfg, args.rehearse_on_cpu or 1.0)
    t0 = time.perf_counter()
    tables = make_tables(args.seed, rows)
    stats = int_bounds(tables)
    mix = traffic.Mix(mix_spec, args.seed, stats)
    log(f"data: {rows} made in {time.perf_counter() - t0:.3f} s")

    overrides = {"hyperspace.torch.hbm.mode": "force"} if rehearse else {}
    sut = system.System(cfg, mix, tables, workdir, device, overrides)
    kernel_build.join()
    if kernel_build.errors:
        raise kernel_build.errors[0]
    sut.build()
    log(f"set-up: sources {sut.source_bytes} bytes in {sut.timings['write_s']:.3f} s, "
        f"builds {sut.timings['build_s']:.3f} s, prefetch {sut.timings['prefetch_s']:.3f} s, "
        f"residency {sut.residency}")
    want_tier = cfg["expect"]["tier"]
    if sut.tiers() != [want_tier] * len(sut.indexes):
        raise RuntimeError(f"residency tiers {sut.tiers()}, the configuration states {want_tier}")
    frames = [[sut.query(shape, p) for p in shape.psets] for shape in mix.shapes]
    server = sut.server()
    routes = warm_shapes(server, mix, frames)
    t0 = time.perf_counter()
    n_warm = loop.warm(server, mix, frames)
    log(f"warm-up: every shape on the device aggregate {routes}; {n_warm} queries from "
        f"{mix.clients} clients in {time.perf_counter() - t0:.3f} s")
    trace = sampler = None
    if args.trace:
        if not rehearse:
            devtrace.warm()
            trace = devtrace.Trace()
        sampler = host.StackSampler("hyperspace-serve", "hyperspace_tpu_torch/")
    if not rehearse:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    log(f"setup_s {setup_s:.3f}")

    log(f"host: peak resident memory {host.peak_rss_bytes()} bytes after set-up")
    before = telemetry_report()
    cpu0, load0, threads0 = time.process_time(), os.getloadavg(), host.thread_cpu()
    threads1 = {}

    def at_open():
        if trace:
            trace.start()
        if sampler:
            sampler.start()

    def at_close():  # the clients' threads still live: read them before they end
        threads1.update(host.thread_cpu())
        if sampler:
            sampler.stop()
        if trace:
            trace.stop()

    win = loop.run(server, mix, frames, float(args.seconds), WHOLE_ROWS, WHOLE_SHARE,
                   at_open=at_open, at_close=at_close)
    after = telemetry_report()
    reduced = trace.reduce() if trace else None
    peak = torch.cuda.max_memory_allocated() if not rehearse else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {found}")
    done = win.completed_in_window()
    delta = telemetry_delta(before, after)
    log(f"window: {win.attempted} submitted, {len(done)} answered in the window, "
        f"{len(win.failures)} failed; by shape {shape_latencies(mix, win)}")
    log(f"telemetry: {json.dumps(delta)}")
    log(f"host: process CPU {time.process_time() - cpu0:.3f} s over the window, load average "
        f"{load0} before, {os.getloadavg()} after; answers a second {timeline(win)}")
    log(f"host: CPU seconds in the window by thread [threads, seconds]: "
        f"{json.dumps(host.cpu_by_group(threads0, threads1))}")
    if sampler:
        log(f"host: where the server's threads stood, every {sampler.period * 1e3:g} ms: "
            f"{json.dumps(sampler.top())}")
    if reduced:
        log(f"trace: {json.dumps(reduced)}")
        if reduced["records_missing"]:
            log("trace: device records missing (fewer kernels than launches): "
                "device_idle is not reported")

    # the program's state goes before the reference runs
    timings = dict(sut.timings)
    sut.close()
    del server, frames, sut
    gc.collect()
    if not rehearse:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    from reference.groupby import Table, group_by

    used = sorted({c for shape in mix.shapes for c in shape.columns()})
    ref_table = Table({c: tables[mix.shapes[0].table][c] for c in used}, device)
    memo = {}

    def reference(qid):
        if qid not in memo:
            shape = mix.shapes[qid[0]]
            memo[qid] = (group_by(ref_table, shape.psets[qid[1]], shape.group_by,
                                  shape.aggs), shape.group_by)
        return memo[qid]

    verdict = check.judge(win.records, len(win.failures), reference, cfg["check_limits"])
    ref_s = time.perf_counter() - t0
    log(f"reference: {len(memo)} queries in {ref_s:.3f} s; answers {verdict['answers']}, "
        f"{verdict['whole']} compared whole; host: peak resident memory "
        f"{host.peak_rss_bytes()} bytes")

    ctx = {
        "cell": cell, "config": cfg, "mix": mix, "window": win, "completed": done,
        "setup_s": setup_s, "timings": timings, "telemetry": delta, "trace": reduced, "stats": stats,
        "rows": rows, "tier": want_tier,
    }
    out_metrics = {}
    for m in spec.cell_metrics(bench, cell["name"], bool(args.trace)):
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "cpu" if rehearse else "gpu",
           "kind": "cpu" if rehearse else header["kind"],
           "count": 1 if rehearse else int(cell["chips"]),
           "memory_peak_bytes": int(peak)}
    if reduced:
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
    result = {"correct": verdict["correct"], "attempted": win.attempted,
              "failed": len(win.failures), "metrics": out_metrics, "device": dev}
    if reduced:
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    if not rehearse:
        result["card"] = header.get("nvidia_smi")
    result["checks"] = {k: {"value": v, "limit": verdict["limits"][k]}
                        for k, v in verdict["numbers"].items()}
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse-on-cpu", type=float, default=None, metavar="SCALE",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    import torch

    if args.rehearse_on_cpu is None and (not torch.cuda.is_available()
                                         or torch.cuda.device_count() < int(cell["chips"])):
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    # the program's kernel caches: fixed directories inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BENCH_DIR / ".cache" / "triton"))
    workdir = Path(tempfile.mkdtemp(prefix="hsbench-"))
    try:
        result = run_cell(args, bench, cell, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package loaded: {found}")
        return 3
    print(json.dumps(result, allow_nan=False, default=_finite), flush=True)
    return 0


def _finite(v):
    raise TypeError(f"not JSON: {v!r}")


if __name__ == "__main__":
    sys.exit(main())
