"""Seconds of the harness's clock around each ``create_index`` of the
cell, fenced, summed."""


def read(ctx):
    return ctx["timings"]["build_s"]
