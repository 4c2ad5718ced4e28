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
RMSNorm forward saves ``x, scale``.  Each forward and backward runs in a
``device_metrics.span`` (``repro_torch.ops.<op>.fwd`` / ``.bwd``) that
holds the wrapper's copies with the kernels.

``ssd_scan`` stands where the reference's SSM prefill calls the SSD's
pure-``lax`` twin; like the reference's ``ops.ssd_scan`` it is forward
only — no Function, and a request for a gradient raises, naming the path
to use under autograd: ``models/mamba.ssd_chunked``, the chunked SSD in
plain tensor ops, which the SSM family's training runs.

A ``DTensor`` argument (a tensor placed on a ``DeviceMesh``) reaches the
kernels as its local shard, and the result is the ``DTensor`` of the
kernel's local result on the same placements.  That is only the whole
function where no dim the kernel reduces over is split: each entry point
names the dims it may take sharded (attention: batch and heads; RMSNorm:
every dim of ``x`` but the last, its scale whole; SSD: batch), every
``DTensor`` argument must share one mesh and placements, and anything else
is refused with a ``ValueError`` — never gathered, localised or sent to
the plain version quietly.
"""

from __future__ import annotations

import torch

from repro_torch.core.device_metrics import span
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
        with span("repro_torch.ops.flash_attention.bwd"):
            dq, dk, dv = _fa.flash_bwd(q, k, v, out, lse, dout.contiguous(),
                                       causal=ctx.causal,
                                       q_offset=ctx.q_offset)
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
        with span("repro_torch.ops.rmsnorm.bwd"):
            dx, dscale = _rn.rmsnorm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale if ctx.needs_input_grad[1] else None, None


def _placed(op: str, args: dict, free: dict):
    """``None`` when no argument is a ``DTensor``; else the (mesh,
    placements) the result takes.  Each argument named in ``free`` may be
    split on the dims listed there (none the kernel reduces over) and all
    of them share one mesh and placements; the others (a norm's scale, the
    SSD's A) are plain or replicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    placed = {n: t for n, t in args.items() if isinstance(t, DTensor)}
    if not placed:
        return None
    for name, t in placed.items():
        for m, pl in enumerate(t.placements):
            if isinstance(pl, Replicate):
                continue
            if type(pl) is not Shard or \
                    pl.dim % t.dim() not in free.get(name, ()):
                raise ValueError(
                    f"{op}: {name} is placed {t.placements}; the kernel "
                    f"reduces over that dim (it takes {name} split only on "
                    f"dims {sorted(free.get(name, ()))})")
            if t.shape[pl.dim] % t.device_mesh.size(m):
                # uneven shards would pair a rank's q heads with another
                # rank's kv heads
                raise ValueError(f"{op}: {name} is split unevenly "
                                 f"({tuple(t.shape)}, {t.placements})")
    first = next((args[n] for n in free if n in placed),
                 next(iter(placed.values())))
    layout = (first.device_mesh, tuple(first.placements))
    split = any(not isinstance(pl, Replicate) for pl in layout[1])
    for name, t in args.items():
        same = isinstance(t, DTensor) and t.device_mesh == layout[0] \
            and tuple(t.placements) == layout[1]
        if name in free and split and not same:
            raise ValueError(f"{op}: {name} is not placed as "
                             f"{next(n for n in free if n in placed)} "
                             f"({layout[1]})")
        if isinstance(t, DTensor) and t.device_mesh != layout[0]:
            raise ValueError(f"{op}: DTensor arguments on different meshes")
    return layout


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _wrap(t, layout):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, layout[0], layout[1], run_check=False)


def flash_attention(q, k, v, causal: bool = True, q_offset: int = 0):
    """q: (B,Sq,H,D); k/v: (B,Skv,Hkv,D/Dv) -> (B,Sq,H,Dv)."""
    layout = _placed("flash_attention", {"q": q, "k": k, "v": v},
                     {"q": (0, 2), "k": (0, 2), "v": (0, 2)})
    if layout is not None:
        return _wrap(flash_attention(_local(q), _local(k), _local(v),
                                     causal, q_offset), layout)
    with span("repro_torch.ops.flash_attention.fwd"):
        return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal, q_offset)


def rmsnorm(x, scale, eps: float = 1e-5):
    """RMSNorm over the last dim of x (any leading shape)."""
    layout = _placed("rmsnorm", {"x": x, "scale": scale},
                     {"x": tuple(range(x.dim() - 1))})
    if layout is not None:
        return _wrap(rmsnorm(_local(x), _local(scale), eps), layout)
    with span("repro_torch.ops.rmsnorm.fwd"):
        return _RMSNorm.apply(x.contiguous(), scale.contiguous(), eps)


def ssd_scan(x, dt, A, B, C, chunk: int = 256):
    """Chunked SSD, forward only.  x: (b,S,H,P); dt: (b,S,H) fp32
    post-softplus; A: (H,) fp32; B, C: (b,S,N) -> (y (b,S,H,P), final
    state (b,H,P,N) fp32).  x, B and C may be views (strided tokens)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (x, dt, A, B, C)):
        raise NotImplementedError(
            "ssd_scan is forward only, as the reference's: under autograd "
            "use models/mamba.ssd_chunked, the chunked SSD in plain tensor "
            "ops that the SSM family's training runs")
    layout = _placed("ssd_scan", {"x": x, "dt": dt, "A": A, "B": B, "C": C},
                     {"x": (0,), "dt": (0,), "B": (0,), "C": (0,)})
    if layout is not None:
        y, state = _ssd.ssd_scan(*map(_local, (x, dt, A, B, C)), chunk)
        return _wrap(y, layout), _wrap(state, layout)
    return _ssd.ssd_scan(x, dt, A, B, C, chunk)
