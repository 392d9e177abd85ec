"""K3 (the silhouette min-scan, ``nrt_fused_minscan_*``): the least time of
every sample of the traced steps' rays over K3's device time, in %."""

from nrt_bench.counts import march_bytes, sdf_ops, share
from nrt_bench.tracing import seconds_of


def read(ctx):
    w, cfg = ctx["work"], ctx["cfg"]
    return share(w["scan_evals"] * sdf_ops(cfg), seconds_of(ctx["summary"], "nrt_fused_minscan"),
                 march_bytes(cfg, w["rays"], outputs=1))
