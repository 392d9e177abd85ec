"""K2 (the sphere trace, ``nrt_fused_march_*``): the least time of the SDF
evaluations that the reference's march needs for the traced views' rays over
K2's device time, in %."""

from nrt_bench.counts import march_bytes, sdf_ops, share
from nrt_bench.tracing import seconds_of


def read(ctx):
    w, cfg = ctx["work"], ctx["cfg"]
    return share(w["march_evals"] * sdf_ops(cfg), seconds_of(ctx["summary"], "nrt_fused_march"),
                 march_bytes(cfg, w["rays"]))
