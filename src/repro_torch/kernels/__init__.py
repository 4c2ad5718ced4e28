"""Hand-written CUDA kernels (Hopper, sm_90a) for the port's paths.

The capacity sweep:

* ``shard_factor``     — the packed greedy axis-assignment / divisibility
  pass behind every shard denominator of the columnar table build.
* ``segmented_cummax`` — the per-cell max running prefix sum over the
  alloc/free event axis of the liveness assembly.

Serving and training (reached from the models through ``ops``, whose
autograd Functions run the backward kernels in the backward):

* ``flash_attention``  — FlashAttention-2 forward (``flash_fwd``) and
  backward (``flash_bwd``: the dq pass and the dk / dv pass).
* ``rmsnorm``          — fused RMSNorm forward (``rmsnorm_fwd``) and
  backward (``rmsnorm_bwd``).
* ``ssd``              — the Mamba-2 chunked SSD scan (``ssd_scan``),
  forward only, behind every SSM prefill layer.

``ref`` holds the plain-PyTorch oracles of the last three.

Each module holds the kernels' wrappers, plain PyTorch versions of the
same functions (used for CPU tensors and as the on-device cross-check) and
launch counters.  The CUDA sources live in ``csrc/`` and are compiled by
``_build`` with ``nvcc`` at first use; importing this package touches
neither ``nvcc`` nor a CUDA device.
"""
