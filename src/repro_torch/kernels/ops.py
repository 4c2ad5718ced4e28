"""The model code's entry points to the attention, RMSNorm and SSD kernels.

``flash_attention`` and ``rmsnorm`` stand where the reference's models call
their pure-``lax`` twins of the Pallas kernels
(``repro.models.attention.flash_attention``, ``repro.models.layers.rmsnorm``):
same signature, same ``(B, S, H, D)`` layouts.  Each is a
``torch.autograd.Function`` — the counterpart of the reference's
``custom_vjp``s (``repro.kernels.ops``) — whose forward is the forward
kernel and whose backward is the backward kernel(s):

* on a CUDA tensor they launch the kernels (or raise), on contiguous
  copies where the caller hands them a strided view (the last position's
  ``x[:, -1:]``), as XLA picks the reference's layouts;
* on a CPU tensor the kernels' wrappers take their plain versions, so the
  CPU tests run the same wiring, forward and backward, as the card.

The attention forward saves ``q, k, v, out, lse`` for its backward; the
RMSNorm forward saves ``x, scale``.

``ssd_scan`` stands where the reference's SSM prefill calls the SSD's
pure-``lax`` twin (``repro.models.mamba.ssd_chunked``); like the
reference's ``ops.ssd_scan`` it is forward only — no Function, and a
request for a gradient raises (the SSM family's training, which takes
``ssd_chunked``, is not ported yet).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd as _ssd


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int):
        out, lse = _fa.flash_fwd(q, k, v, causal=causal, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _fa.flash_bwd(q, k, v, out, lse, dout.contiguous(),
                                   causal=ctx.causal, q_offset=ctx.q_offset)
        return dq, dk, dv, None, None


class _RMSNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rn.rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = _rn.rmsnorm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale if ctx.needs_input_grad[1] else None, None


def flash_attention(q, k, v, causal: bool = True, q_offset: int = 0):
    """q: (B,Sq,H,D); k/v: (B,Skv,Hkv,D/Dv) -> (B,Sq,H,Dv)."""
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, q_offset)


def rmsnorm(x, scale, eps: float = 1e-5):
    """RMSNorm over the last dim of x (any leading shape)."""
    return _RMSNorm.apply(x.contiguous(), scale.contiguous(), eps)


def ssd_scan(x, dt, A, B, C, chunk: int = 256):
    """Chunked SSD, forward only.  x: (b,S,H,P); dt: (b,S,H) fp32
    post-softplus; A: (H,) fp32; B, C: (b,S,N) -> (y (b,S,H,P), final
    state (b,H,P,N) fp32).  x, B and C may be views (strided tokens)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (x, dt, A, B, C)):
        raise NotImplementedError(
            "ssd_scan is forward only: the SSM family's training path "
            "(ssd_chunked) is not ported yet")
    return _ssd.ssd_scan(x, dt, A, B, C, chunk)
