"""K1 (csrc/fused_blend_fwd.cu) over a traced step: the least time of the
three renders' counted blend work (counts.k1) over K1's device time."""

from benchmark.counts import k1, kernel_share


def read(ctx):
    return kernel_share(ctx, k1, "fused_blend_fwd_kernel")
