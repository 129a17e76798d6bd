"""Process start to the first timed query: data, sources, index builds,
kernel builds where none is cached, prefetch and warm-up."""


def read(ctx):
    return ctx["setup_s"]
