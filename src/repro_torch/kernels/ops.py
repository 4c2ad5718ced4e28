"""The model code's entry points to the attention and RMSNorm kernels.

``flash_attention`` and ``rmsnorm`` stand where the reference's models call
their pure-``lax`` twins of the Pallas kernels
(``repro.models.attention.flash_attention``, ``repro.models.layers.rmsnorm``):
same signature, same ``(B, S, H, D)`` layouts.  Forward only, for serving:

* on a CUDA tensor they launch the kernel (or raise), on a contiguous
  copy where the caller hands them a strided view (the last position's
  ``x[:, -1:]``), as XLA picks the reference's layouts;
* on a CPU tensor they take the kernel's plain version;
* on a CUDA input that autograd would have to record (grad mode on and an
  input that requires grad) they raise ``NotImplementedError``: the
  backward kernels are not ported yet, and autograd through the plain
  version is not a stand-in for them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn


def _refuse_grad(what: str, backward: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(
            t.is_cuda and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: the backward kernel{backward} not ported yet; run "
            f"serving under torch.inference_mode() or on tensors that do "
            f"not require grad")


def flash_attention(q, k, v, causal: bool = True, q_offset: int = 0):
    """q: (B,Sq,H,D); k/v: (B,Skv,Hkv,D/Dv) -> (B,Sq,H,Dv)."""
    _refuse_grad("flash_attention", "s (flash _dq_kernel, _dkv_kernel) are",
                 q, k, v)
    out, _ = _fa.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, q_offset=q_offset)
    return out


def rmsnorm(x, scale, eps: float = 1e-5):
    """RMSNorm over the last dim of x (any leading shape)."""
    _refuse_grad("rmsnorm", " (rmsnorm _bwd_kernel) is", x, scale)
    return _rn.rmsnorm_fwd(x.contiguous(), scale.contiguous(), eps)
