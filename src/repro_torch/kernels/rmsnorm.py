"""RMSNorm, forward and backward: the norm of every decoder block (twice per
block), the final norm and Qwen3's per-head q/k norm.

* :func:`rmsnorm_fwd` — the forward's wrapper: on CUDA tensors it
  launches the hand-written kernel ``csrc/rmsnorm.cu`` (which replaces the
  TPU kernel ``repro/kernels/rmsnorm.py::_fwd_kernel``); on CPU tensors it
  takes the plain version.  It never falls back: CUDA tensors the kernel
  does not take raise.
* :func:`rmsnorm_bwd` — the backward's wrapper, the same way: the kernel
  ``rmsnorm_bwd_kernel`` of ``csrc/rmsnorm.cu`` (replaces ``_bwd_kernel``)
  writes dx and one fp32 partial dscale row per block of
  :func:`bwd_partition` rows; the wrapper sums the partial rows, as the
  reference's wrapper does — deterministic, no atomics.
* :func:`rmsnorm_fwd_plain`, :func:`rmsnorm_bwd_plain` — the same
  functions in plain PyTorch (fp32 statistics; the backward by its
  explicit formula, its dscale summed over the same partial rows).  The
  cross-check on the device and the CPU path.
* ``launches``, ``bwd_launches`` — how many times each kernel was
  launched.

x of any leading shape is taken as ``R = numel / D`` rows of its last dim.
Bound on an H100: bytes, ``2*R*D*elt + D*elt`` forward and ``3*R*D*elt +
D*elt`` + the fp32 dscale backward.

Tolerance: 2e-5 in fp32 forward and 1e-4 backward (the kernels' ``rsqrtf``
and reduction order against torch's; the backward's two reductions and
its dscale sum over the rows), 2e-2 in bf16 (one rounding of each
output); tests/test_torch_rmsnorm.py holds the plain versions against the
reference package's Pallas kernels in interpret mode, ``chip_smoke.py``
the kernels against the plain versions on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.device_metrics import report_kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0          # forward kernel
bwd_launches = 0      # backward kernel

# the backward's rows are split into at most this many blocks, each
# writing one partial dscale row; the split depends on the row count
# alone, so the sum of the partial rows does not depend on the card
BWD_BLOCKS = 512
# up to this D a block sums its partial row in shared memory; above, in its
# row of the partial rows in device memory (csrc/rmsnorm.cu): any D
BWD_SMEM_D = 12032


def _check(x, scale) -> None:
    if not isinstance(x, torch.Tensor) or not isinstance(scale, torch.Tensor):
        raise TypeError("rmsnorm_fwd takes torch.Tensors")
    if x.dim() < 1 or scale.dim() != 1 or scale.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm_fwd takes x (..., D) and scale (D,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.dtype != scale.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm_fwd takes float32 or bfloat16 x and scale "
                        f"of one type, got {x.dtype} and {scale.dtype}")
    if x.device != scale.device:
        raise ValueError("rmsnorm_fwd: x and scale must be on one device")


def rmsnorm_fwd_plain(x, scale, eps: float = 1e-5):
    _check(x, scale)
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_fwd(x, scale, eps: float = 1e-5):
    """RMSNorm over the last dim; the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    global launches
    _check(x, scale)
    if x.device.type == "cpu":
        return rmsnorm_fwd_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_fwd runs on cuda or cpu tensors, got "
                         f"{x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_fwd kernel takes contiguous x and scale")
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if rows > 0x7FFFFFFF:
        raise ValueError(f"rmsnorm_fwd kernel takes < 2**31 rows, got {rows}")
    y = torch.empty_like(x)
    if rows == 0:
        return y
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rmsnorm_fwd_launch(x.data_ptr(), scale.data_ptr(),
                                    y.data_ptr(), _DTYPES[x.dtype], rows, D,
                                    float(eps), stream)
    if rc != 0:
        raise RuntimeError(
            f"rmsnorm_fwd kernel launch failed (cuda error {rc}) for x "
            f"{tuple(x.shape)}, {x.dtype}")
    launches += 1
    report_kernel((x, scale, y))                    # no dot
    return y


def bwd_partition(rows: int) -> tuple:
    """``(rows_per_block, n_blocks)`` of the backward's dscale partial
    rows for ``rows`` rows."""
    per = max(1, -(-rows // BWD_BLOCKS))
    return per, -(-rows // per)


def _check_bwd(x, scale, dy) -> None:
    _check(x, scale)
    if not isinstance(dy, torch.Tensor) or dy.shape != x.shape or \
            dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd: dy must be {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}, got "
                         f"{getattr(dy, 'dtype', None)} "
                         f"{tuple(getattr(dy, 'shape', ()))}")


def rmsnorm_bwd_plain(x, scale, dy, eps: float = 1e-5):
    """Plain PyTorch backward -> ``(dx, dscale)``: ``dx = inv * (dxhat -
    xhat * mean(dxhat * xhat))`` with ``xhat = x * inv``, ``dxhat = dy *
    scale``; ``dscale`` the sum of ``dy * xhat`` over the rows, taken as
    the kernel takes it (partial rows of :func:`bwd_partition`, then their
    sum), cast to scale's type."""
    _check_bwd(x, scale, dy)
    D = x.shape[-1]
    xf = x.reshape(-1, D).float()
    dyf = dy.reshape(-1, D).float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    dxhat = dyf * scale.float()
    dx = inv * (dxhat - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    rows = xf.shape[0]
    per, n = bwd_partition(rows)
    prod = torch.nn.functional.pad(dyf * xhat, (0, 0, 0, per * n - rows))
    dscale = prod.reshape(n, per, D).sum(1).sum(0)
    return dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype)


def rmsnorm_bwd(x, scale, dy, eps: float = 1e-5):
    """RMSNorm backward -> ``(dx, dscale)``; the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    global bwd_launches
    _check_bwd(x, scale, dy)
    if x.device.type == "cpu":
        return rmsnorm_bwd_plain(x, scale, dy, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_bwd runs on cuda or cpu tensors, got "
                         f"{x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()
            and dy.is_contiguous()):
        raise ValueError("rmsnorm_bwd kernel takes contiguous x, scale and "
                         "dy")
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(scale)
    per, n = bwd_partition(rows)
    parts = torch.empty((n, D), dtype=torch.float32, device=x.device)
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rmsnorm_bwd_launch(x.data_ptr(), scale.data_ptr(),
                                    dy.data_ptr(), dx.data_ptr(),
                                    parts.data_ptr(), _DTYPES[x.dtype], rows,
                                    per, D, float(eps), stream)
    if rc != 0:
        raise RuntimeError(
            f"rmsnorm_bwd kernel launch failed (cuda error {rc}) for x "
            f"{tuple(x.shape)}, {x.dtype}")
    bwd_launches += 1
    report_kernel((x, scale, dy, dx, parts))        # no dot
    return dx, parts.sum(0).to(scale.dtype)
