"""Seconds of the harness's clock around ``prefetch_index`` and the
residency cache's background wait, fenced, summed over the cell's
indexes."""


def read(ctx):
    return ctx["timings"]["prefetch_s"]
