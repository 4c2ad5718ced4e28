"""The RMSNorm kernels' share of their roofline over the traced steps:
bytes over HBM's bandwidth (or fp32 operations over the fp32 peak, the
larger) of the calls a step makes, over the kernels' device time."""

from perfbench.harness import peaks, work

KERNELS = {"fwd": ("rmsnorm_fwd_kernel",), "bwd": ("rmsnorm_bwd_kernel",)}


def read(ctx):
    return work.roofline_share(ctx.trace, ctx.work.get("rmsnorm"), KERNELS,
                               work.rmsnorm, ctx.work["elt_bytes"],
                               peaks.FP32_FLOPS, peaks.HBM_BYTES)
