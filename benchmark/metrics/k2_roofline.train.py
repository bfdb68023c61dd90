"""K2 (csrc/fused_blend_bwd.cu) over a traced step: the least time of the
three renders' counted blend backward (counts.k2) over K2's device time."""

from benchmark.counts import k2, kernel_share


def read(ctx):
    return kernel_share(ctx, k2, "fused_blend_bwd_kernel")
