"""hyperspace_tpu_torch — the Hyperspace covering-index engine on PyTorch
and CUDA.

This package mirrors ``hyperspace_tpu``'s module layout and on-disk
formats (the JSON operation log and the TCB index files), so each of the
two packages can serve an index tree the other one wrote. Device work runs
on a CUDA card through torch ops and hand-written CUDA kernels (``csrc/``),
over columns uploaded per query or kept resident on the card
(``Hyperspace.prefetch_index``, ``exec/hbm_cache.py``); every entry point takes its device from the caller or the
session conf (``hyperspace.torch.device``, default ``cuda``) and never
falls back to the CPU on its own.

The package imports ``torch`` and nothing of JAX.
"""

__version__ = "0.1.0"

from .config import HyperspaceConf  # noqa: E402,F401
from .exceptions import HyperspaceException  # noqa: E402,F401
from .index.index_config import IndexConfig  # noqa: E402,F401


def __getattr__(name):
    # the session, facade and expression helpers load on first use
    if name == "HyperspaceSession":
        from .session import HyperspaceSession

        return HyperspaceSession
    if name == "Hyperspace":
        from .hyperspace import Hyperspace

        return Hyperspace
    if name == "DataFrame":
        from .dataframe import DataFrame

        return DataFrame
    if name in ("col", "lit", "is_in"):
        from .plan import expr

        return getattr(expr, name)
    if name in ("agg_sum", "agg_count", "agg_min", "agg_max", "agg_avg", "AggSpec"):
        from .plan import aggregates

        return getattr(aggregates, name)
    if name == "DataSkippingIndexConfig":
        from .index.index_config import DataSkippingIndexConfig

        return DataSkippingIndexConfig
    if name in ("MinMaxSketch", "BloomFilterSketch", "ValueListSketch"):
        from .index import sketches

        return getattr(sketches, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
