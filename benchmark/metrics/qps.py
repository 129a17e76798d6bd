"""Queries answered in the window per second of the window, taken on the
clients: every answer counts once, over all of the window."""


def read(ctx):
    return len(ctx["completed"]) / ctx["window"].seconds
