"""Mean time of a device aggregate (the ``scan.resident_agg.device``
timer) per call in the window: host clock around the dispatch and the
copy home of the group vectors, which the copy fences."""


def read(ctx):
    t = ctx["telemetry"]["timers"].get("scan.resident_agg.device")
    return None if t is None else t[0] / t[1] * 1e3
