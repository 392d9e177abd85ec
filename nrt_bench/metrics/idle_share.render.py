"""The device's idle share of an untraced rendered view, in %: one minus the
busy seconds a traced view over the wall seconds an untraced one of the same
window took (the profiler's host overhead would read as idle)."""

from nrt_bench.tracing import idle_share


def read(ctx):
    return idle_share(ctx)
