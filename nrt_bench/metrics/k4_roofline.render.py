"""K4 (the shadow march, ``nrt_fused_shadow_*``): the least time of the SDF
evaluations that the reference's shadow march needs for the traced views'
shadow rays over K4's device time, in %."""

from nrt_bench.counts import march_bytes, sdf_ops, share
from nrt_bench.tracing import seconds_of


def read(ctx):
    w, cfg = ctx["work"], ctx["cfg"]
    return share(w["shadow_evals"] * sdf_ops(cfg), seconds_of(ctx["summary"], "nrt_fused_shadow"),
                 march_bytes(cfg, w["rays"], outputs=1))
