"""Host-side parallelism: the worker pools of the pipelined build."""
