"""The host's blocking calls on the device (stream, device and event
synchronisations, synchronous copies) made inside the program's ``nrt.``
spans, per traced training step."""

from nrt_bench.spans import syncs_per_unit


def read(ctx):
    return syncs_per_unit(ctx)
