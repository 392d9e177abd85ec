"""The window's share of the card's float32 peak, in %: the operations the
traced steps needed (``counts.train_step_ops`` of the reference's work),
scaled to the untraced steps of the window, over their seconds."""

from nrt_bench.counts import train_step_ops
from nrt_bench.tracing import mfu


def read(ctx):
    w = ctx["work"]
    return mfu(ctx, train_step_ops(ctx["cfg"], w["rays"], w["hits"], w["march_evals"],
                                   w["scan_evals"]))
