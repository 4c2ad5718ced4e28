"""Segmented cummax: the liveness assembly's per-cell peak.

The liveness assembly reduces every cell's alloc/free event program to an
``(n_events, n_cells)`` int64 delta stack whose per-cell peak is the max
over running event-axis prefix sums (exactly ``liveness.replay``'s
``max(prefixes)``).  This module holds

* :func:`segmented_cummax` — the wrapper: on a CUDA tensor it launches the
  hand-written kernel ``csrc/segmented_cummax.cu`` (which replaces the TPU
  kernel ``repro/kernels/segmented_cummax.py::_pallas_kernel``); on a CPU
  tensor it takes the plain version.  It never falls back: a CUDA tensor
  the kernel does not take raises.
* :func:`segmented_cummax_plain` — the same function in plain PyTorch
  (``cumsum`` + ``max``), the cross-check on the device and the CPU path.
* ``launches`` — how many times the kernel was launched.

Bound on an H100: bytes, ``(n_events + 1) * 8 * n``; at the sweep's sizes
that is around a microsecond, so a call costs its launch.  The kernel
takes the stack where the engine built it — on the device — and leaves
the peaks there: no host round trip, no synchronisation.

Exactness: int64 adds and maxes evaluated in event order; parity with the
numpy reference and with ``liveness.replay`` is asserted in
tests/test_torch_segmented_cummax.py, kernel-vs-plain equality on the
device by ``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

launches = 0


def segmented_cummax_plain(deltas: torch.Tensor) -> torch.Tensor:
    """``max_j sum_{e<=j} deltas[e]`` per column, plain PyTorch."""
    return torch.cumsum(deltas, 0).max(0).values


def _check(deltas: torch.Tensor) -> None:
    if not isinstance(deltas, torch.Tensor):
        raise TypeError(
            f"segmented_cummax takes a torch.Tensor, got {type(deltas)}")
    if deltas.dtype != torch.int64:
        raise TypeError(
            f"segmented_cummax takes int64 deltas, got {deltas.dtype}")
    if deltas.dim() != 2 or deltas.shape[0] < 1:
        raise ValueError(
            f"segmented_cummax takes an (n_events >= 1, n_cells) stack, "
            f"got shape {tuple(deltas.shape)}")


def segmented_cummax(deltas: torch.Tensor) -> torch.Tensor:
    """Per-cell peak of an ``(n_events, n_cells)`` int64 delta stack, as an
    ``(n_cells,)`` int64 tensor on the same device."""
    global launches
    _check(deltas)
    if deltas.device.type == "cpu":
        return segmented_cummax_plain(deltas)
    if deltas.device.type != "cuda":
        raise ValueError(
            f"segmented_cummax runs on cuda or cpu tensors, got "
            f"{deltas.device}")
    if not deltas.is_contiguous():
        raise ValueError(
            "segmented_cummax kernel takes a contiguous (row-major) stack")
    n_events, n = deltas.shape
    out = torch.empty((n,), dtype=torch.int64, device=deltas.device)
    if n == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(deltas.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.segmented_cummax_launch(deltas.data_ptr(), out.data_ptr(),
                                         n_events, n, stream)
    if rc != 0:
        raise RuntimeError(
            f"segmented_cummax kernel launch failed (cuda error {rc}) for "
            f"shape {tuple(deltas.shape)}")
    launches += 1
    return out


def _numpy_impl(device):
    def impl(deltas):
        t = torch.from_numpy(np.ascontiguousarray(deltas, np.int64))
        return segmented_cummax(t.to(device)).cpu().numpy()
    return impl


@contextlib.contextmanager
def use_backend(device="cuda"):
    """Route the host columnar path's ``core.batch.liveness_peak_batch``
    through :func:`segmented_cummax` on ``device`` for the dynamic extent
    of the context (numpy in, numpy out).  The torch engine does not need
    this: it calls the wrapper on its own device tensors."""
    from repro_torch.core import batch as B
    prev = B._liveness_peak_impl
    B._liveness_peak_impl = _numpy_impl(torch.device(device))
    try:
        yield
    finally:
        B._liveness_peak_impl = prev
