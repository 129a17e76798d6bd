"""Whole-plan compilation: an optimized plan lowers to one compiled
pipeline, and the interpreter becomes the fallback leg of a compiler.

Counterpart of ``hyperspace_tpu.compile`` (single device):

* ``pipeline_cache.get_or_lower(plan, executor, version_token)``, the
  compiled-pipeline cache behind ``Executor.execute``;
* ``result_cache``, the serve tier's memo of finished results;
* ``plan_fingerprint`` / ``batch_fingerprint``, the structural keys (the
  serve micro-batcher folds the coarse one into its batch keys).

The reference keys its XLA executables on predicate structure so that a
fresh literal does not recompile. The port has no such cost: K1's program
and literals ride each launch's parameters, so a pipeline stores routing
only and no cache of executables exists.
"""

from .cache import PipelineCache, pipeline_cache
from .fingerprint import batch_fingerprint, plan_fingerprint
from .lowering import classify_shape, lower
from .pipeline import CompiledPipeline
from .result_cache import ResultCache, result_cache

__all__ = [
    "CompiledPipeline",
    "PipelineCache",
    "ResultCache",
    "batch_fingerprint",
    "classify_shape",
    "lower",
    "pipeline_cache",
    "plan_fingerprint",
    "result_cache",
]
