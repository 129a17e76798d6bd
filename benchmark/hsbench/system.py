"""The system under test: the port (``hyperspace_tpu_torch``) as a
deployment runs it. Set-up writes the sources, builds the covering
indexes the mix reads, makes them resident and starts the query server;
the window then only submits. Everything of the program that the
benchmark touches is here, so the rest of the harness stays plain."""

from __future__ import annotations

import threading
import time
from pathlib import Path

from . import avro
from .tpch import SCHEMAS


def build_kernels_async(on_card: bool) -> threading.Thread:
    """Build the CUDA kernels and the native IO runtime in the background
    (both cached in the checkout's ``hyperspace_tpu_torch/_build/``, so
    only the first run of a checkout compiles), while the sources are
    written. ``join()`` it before the first index build."""
    def work():
        from hyperspace_tpu_torch import native

        if on_card:
            from hyperspace_tpu_torch.ops.kernels import build_kernels

            build_kernels()
        native.available()  # builds the runtime where no build of it exists

    errors = []

    def run():
        try:
            work()
        except BaseException as e:  # noqa: BLE001 - re-raised by the joiner
            errors.append(e)

    t = threading.Thread(target=run, name="hsbench-build", daemon=True)
    t.errors = errors
    t.start()
    return t


class System:
    def __init__(self, cfg: dict, mix, tables: dict, workdir: Path, device: str,
                 overrides: dict):
        import hyperspace_tpu_torch as hs

        self.mix = mix
        self.timings = {"write_s": 0.0, "build_s": 0.0, "prefetch_s": 0.0}
        self.source_bytes = 0
        dirs = {}
        for name in mix.tables:
            spec = cfg["tables"][name]
            t0 = time.perf_counter()
            dirs[name] = workdir / "src" / name
            self.source_bytes += avro.write_dir(dirs[name], tables[name], SCHEMAS[name],
                                                int(spec["files"]))
            self.timings["write_s"] += time.perf_counter() - t0
        conf = dict(cfg["conf"])
        conf.update(overrides)
        conf["hyperspace.system.path"] = str(workdir / "indexes")
        conf["hyperspace.torch.device"] = device
        self.session = hs.HyperspaceSession(hs.HyperspaceConf(conf))
        self.hsp = hs.Hyperspace(self.session)
        self.frames = {n: self.session.read.avro(str(d)) for n, d in dirs.items()}
        self.indexes = [i for i in cfg["indexes"] if i["table"] in mix.tables]

    def build(self) -> None:
        """Every index the mix reads, then its columns made resident."""
        import hyperspace_tpu_torch as hs
        from hyperspace_tpu_torch.exec.hbm_cache import hbm_cache
        from hyperspace_tpu_torch.ops import fence

        for ix in self.indexes:
            t0 = time.perf_counter()
            self.hsp.create_index(self.frames[ix["table"]],
                                  hs.IndexConfig(ix["name"], ix["indexed"], ix["included"]))
            fence(self.session.device)
            self.timings["build_s"] += time.perf_counter() - t0
        self.session.enable_hyperspace()
        for ix in self.indexes:
            t0 = time.perf_counter()
            if not self.hsp.prefetch_index(ix["name"], ix["indexed"] + ix["included"]):
                raise RuntimeError(f"prefetch_index({ix['name']}) left it off the device")
            hbm_cache.wait_background()
            fence(self.session.device)
            self.timings["prefetch_s"] += time.perf_counter() - t0
        self.residency = hbm_cache.snapshot_residency()

    def tiers(self) -> list:
        return sorted(t["tier"] for t in self.residency["tables"])

    def query(self, shape, pset):
        """The DataFrame of one query of ``shape`` with parameter set
        ``pset``."""
        import hyperspace_tpu_torch as hs
        from hyperspace_tpu_torch.plan.expr import col

        cond = None
        for c, op, v in pset:
            term = {"<": col(c) < v, "<=": col(c) <= v, ">": col(c) > v,
                    ">=": col(c) >= v, "==": col(c) == v}[op]
            cond = term if cond is None else cond & term
        aggs = [hs.agg_count() if c is None else getattr(hs, f"agg_{fn}")(c)
                for fn, c in shape.aggs]
        df = self.frames[shape.table]
        df = df.filter(cond) if cond is not None else df
        return df.group_by(shape.group_by).agg(*aggs)

    def server(self):
        return self.session.serve(**self.mix.server)

    def close(self) -> None:
        """Stop the server and drop every resident table."""
        from hyperspace_tpu_torch.exec.hbm_cache import hbm_cache

        srv = getattr(self.session, "_server", None)
        if srv is not None and not srv.closed:
            srv.close()
        hbm_cache.reset()
