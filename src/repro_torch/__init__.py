"""PyTorch / CUDA port of the GPU-memory predictor.

The package stands beside the JAX reference package and imports nothing
from it: ``torch`` and ``numpy`` only.  The ported slice is the capacity
sweep — ``repro_torch.core.sweep.SweepEngine`` — whose per-cell
composition runs as int64 tensor ops on a CUDA device, with the shard
denominators and the liveness prefix-max in hand-written CUDA kernels
(``repro_torch.kernels``).  The calibration pipeline
(``repro_torch.calibrate``: measurements, the NNLS profile fit, the learned
residual model, the accuracy report and its CLI) corrects every prediction
path.
"""
