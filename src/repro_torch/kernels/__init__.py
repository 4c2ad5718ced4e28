"""Hand-written CUDA kernels (Hopper, sm_90a) for the port's two paths.

The capacity sweep:

* ``shard_factor``     — the packed greedy axis-assignment / divisibility
  pass behind every shard denominator of the columnar table build.
* ``segmented_cummax`` — the per-cell max running prefix sum over the
  alloc/free event axis of the liveness assembly.

Serving (reached from the models through ``ops``):

* ``flash_attention``  — FlashAttention-2 forward (``flash_fwd``).
* ``rmsnorm``          — fused RMSNorm forward (``rmsnorm_fwd``).

``ref`` holds the plain-PyTorch oracles of the last two.

Each module holds the kernel's wrapper, a plain PyTorch version of the
same function (used for CPU tensors and as the on-device cross-check) and
a launch counter.  The CUDA sources live in ``csrc/`` and are compiled by
``_build`` with ``nvcc`` at first use; importing this package touches
neither ``nvcc`` nor a CUDA device.
"""
