"""Share of the traced window in which no kernel, copy or set ran on the
card (the union of their intervals in a ``torch.profiler`` trace). Not
reported where the trace lost device records."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["records_missing"] or tr["window_s"] <= 0:
        return None
    return (1.0 - tr["busy_s"] / tr["window_s"]) * 100.0
