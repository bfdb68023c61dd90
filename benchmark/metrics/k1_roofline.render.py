"""K1 (csrc/fused_blend_fwd.cu) over a traced request: the least time of
its two renders' counted blend work (counts.k1) over K1's device time."""

from benchmark.counts import k1, kernel_share


def read(ctx):
    return kernel_share(ctx, k1, "fused_blend_fwd_kernel")
