"""Tools of the port, none imported by the engine: the measurement
probes that run on a CUDA card (``k1b_probe``, ``k1p_probe``,
``k2_probe``, and ``profile_probe`` for the per-query profiler's device
records) and the command lines that run anywhere — the static
analyzer (``python -m hyperspace_tpu_torch.tools.lint``) and the
metrics exporter (``python -m hyperspace_tpu_torch.tools.metrics``)."""
