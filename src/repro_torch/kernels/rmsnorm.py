"""RMSNorm, forward: the norm of every decoder block (twice per block), the
final norm and Qwen3's per-head q/k norm.

* :func:`rmsnorm_fwd` — the wrapper: on CUDA tensors it launches the
  hand-written kernel ``csrc/rmsnorm.cu`` (which replaces the TPU kernel
  ``repro/kernels/rmsnorm.py::_fwd_kernel``); on CPU tensors it takes the
  plain version.  It never falls back: CUDA tensors the kernel does not
  take raise.
* :func:`rmsnorm_fwd_plain` — the same function in plain PyTorch,
  ``y = x * rsqrt(mean(x^2) + eps) * scale`` in fp32, cast back to x's
  type.  The cross-check on the device and the CPU path.
* ``launches`` — how many times the kernel was launched.

x of any leading shape is taken as ``R = numel / D`` rows of its last dim.
Bound on an H100: bytes, ``2*R*D*elt + D*elt``.

Tolerance: 2e-5 in fp32 (the kernel's ``rsqrtf`` and its reduction order
against torch's), 2e-2 in bf16 (one rounding of the output);
tests/test_torch_rmsnorm.py holds the plain version against the reference
package's Pallas kernel in interpret mode, ``chip_smoke.py`` the kernel
against the plain version on the card.
"""

from __future__ import annotations

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


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
    return y
