"""K1 (the shading nets' tiled MLP, ``nrt_mlp_tile_*`` or
``nrt_fused_mlp_kernel``): the least time of the rows the program handed K1
in the traced views (its counters ``k1.flops`` and ``k1.bytes``) over K1's
device time, in %."""

from nrt_bench.spans import k1_roofline


def read(ctx):
    return k1_roofline(ctx)
