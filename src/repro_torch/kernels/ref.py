"""Plain-PyTorch oracles of the attention and RMSNorm kernels.

Each function is the mathematical definition the kernel must match,
written as directly as possible (naive O(S^2) attention with the KV heads
repeated, an fp32 RMSNorm, the SSD as its sequential recurrence); the
tests hold the kernels' plain versions and the reference package against
them.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, causal: bool = True, q_offset: int = 0):
    """Naive GQA attention.  q: (B,Sq,H,D); k/v: (B,Skv,Hkv,D/Dv).
    Returns (out (B,Sq,H,Dv) in q's type, lse (B,H,Sq) fp32)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    kf = k.repeat_interleave(G, dim=2).float()
    vf = v.repeat_interleave(G, dim=2).float()
    qf = q.float() * D ** -0.5
    s = torch.einsum("bshd,bthd->bhst", qf, kf)
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        mask = torch.arange(Skv, device=q.device)[None, :] <= q_pos[:, None]
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)                       # (B,H,Sq)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhst,bthd->bshd", p, vf)
    return out.to(q.dtype), lse


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    """x: (..., D); scale: (D,)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def ssd_ref(x, dt, A, B, C, initial_state=None):
    """Sequential Mamba-2 SSD recurrence (group size 1).

    x: (b, S, H, P); dt: (b, S, H) post-softplus; A: (H,) negative;
    B, C: (b, S, N).  Returns (y (b,S,H,P) in x's type, final_state
    (b,H,P,N) fp32)."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    st = (initial_state.float() if initial_state is not None
          else x.new_zeros((b, H, P, N), dtype=torch.float32))
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A[None, :])             # (b, H)
        dBx = torch.einsum("bn,bhp,bh->bhpn", B[:, t].float(),
                           x[:, t].float(), dt[:, t].float())
        st = st * dA[..., None, None] + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", st, C[:, t].float()))
    return torch.stack(ys, 1).to(x.dtype), st
