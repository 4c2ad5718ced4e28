"""The flash attention passes' share of their roofline over the traced
steps: the bound of the attention calls a step makes (operations over the
bf16 tensor-core peak or bytes over HBM's, the larger) over the device
time of the kernels below.  The fp32 FMA kernels share the names' stems,
and are held to the same bf16 bound."""

from perfbench.harness import peaks, work

KERNELS = {"fwd": ("flash_fwd_kernel",),
           "dq": ("flash_bwd_dq_kernel",),
           "dkv": ("flash_bwd_dkv_kernel",)}


def read(ctx):
    return work.roofline_share(ctx.trace, ctx.work.get("attention"), KERNELS,
                               work.flash, ctx.work["elt_bytes"],
                               peaks.BF16_FLOPS, peaks.HBM_BYTES)
