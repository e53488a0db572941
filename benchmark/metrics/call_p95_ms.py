"""The 95th percentile (nearest rank) of every call's time in the window,
host clock, ms."""
from benchmark.harness import window


def read(ctx):
    return window.call_p95_ms(ctx.window)
