"""Mean queue wait of the window's served queries: the server's
``serve.wait_seconds`` histogram, admission to a worker's start."""


def read(ctx):
    h = ctx["telemetry"]["histograms"].get("serve.wait_seconds")
    return None if h is None else h[0] / h[1] * 1e3
