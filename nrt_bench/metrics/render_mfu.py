"""The window's share of the card's float32 peak, in %: the operations the
traced views needed (``counts.view_ops`` of the reference's work), scaled to
the untraced views of the window, over their seconds."""

from nrt_bench.counts import view_ops
from nrt_bench.tracing import mfu


def read(ctx):
    w = ctx["work"]
    return mfu(ctx, view_ops(ctx["cfg"], w["hits"], w["march_evals"], w["shadow_evals"],
                             w["blocked"]))
