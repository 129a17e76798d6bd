"""Mean time of a compiled pipeline's run (the ``compile.pipeline_run``
timer, host clock) per query of the window."""


def read(ctx):
    t = ctx["telemetry"]["timers"].get("compile.pipeline_run")
    return None if t is None else t[0] / t[1] * 1e3
