"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060): spec builder and
the serving applies.

The block is in_proj -> split (z | x | B | C | dt) -> depthwise causal conv
+ SiLU over (x | B | C) -> the SSD scan -> ``+ x D`` -> RMSNorm of ``y *
SiLU(z)`` -> out_proj.  Prefill runs the chunked SSD through the
hand-written kernel (``kernels.ops.ssd_scan``) where the reference's
prefill calls its pure-``lax`` twin ``ssd_chunked``; decode is the O(1)
recurrent step on a (H, P, N) fp32 state per layer, in plain tensor ops.
Both RMSNorms go through the RMSNorm kernel.

Training runs ``mamba2_forward``, which calls ``ssd_chunked``, the
counterpart of the reference's pure-``lax`` function and not the SSD
kernel (which is forward only; the reference has no SSD backward either):
the chunked dual form in plain tensor ops, a loop over chunks with each
chunk's body under a non-reentrant ``torch.utils.checkpoint`` where the
reference scans ``jax.checkpoint(body)``.  So the backward keeps only the
fp32 state carried into each chunk (the byte model's ``chunk_states``
term) and recomputes the (b, H, Q, Q) decay matrix chunk by chunk.

The applies follow the reference's ``repro/models/mamba.py`` op for op, in
the same dtypes: softplus as ``jax.nn.softplus`` writes it
(``logaddexp(x, 0)``), the causal conv accumulated in fp32 tap by tap in
the order k = 0..K-1, the decode conv window in bf16 whatever the model's
type, ``y + x * D`` summed in fp32 (bf16 x times fp32 D promotes) and cast
once.  Where the reference names fp32 the port takes
``promote_types(dtype, float32)``: fp32 for every type the model runs in,
float64 for float64 inputs (a float64 witness of the same program).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.core.spec import (ActTerm, LayerSpec, ParamSpec,
                                   AXIS_CONV, AXIS_EMBED, AXIS_FFN, AXIS_SSM)
from repro_torch.kernels import ops
from repro_torch.models.layers import silu


def mamba2_spec(name: str, d_model: int, ssm, dtype: str = "bfloat16") -> LayerSpec:
    d_inner = ssm.d_inner(d_model)
    H = ssm.n_heads(d_model)
    G, N = ssm.n_groups, ssm.d_state
    d_in_proj = 2 * d_inner + 2 * G * N + H
    conv_ch = d_inner + 2 * G * N
    params = {
        "in_proj": ParamSpec((d_model, d_in_proj), dtype, (AXIS_EMBED, AXIS_FFN)),
        "conv_w": ParamSpec((ssm.d_conv, conv_ch), dtype, (AXIS_CONV, AXIS_FFN)),
        "conv_b": ParamSpec((conv_ch,), dtype, (AXIS_FFN,), init="zeros"),
        "A_log": ParamSpec((H,), "float32", (AXIS_SSM,), init="ssm_a"),
        "D": ParamSpec((H,), "float32", (AXIS_SSM,), init="ones"),
        "dt_bias": ParamSpec((H,), "float32", (AXIS_SSM,), init="dt_bias"),
        "norm_scale": ParamSpec((d_inner,), dtype, (AXIS_FFN,), init="ones"),
        "out_proj": ParamSpec((d_inner, d_model), dtype, (AXIS_FFN, AXIS_EMBED)),
    }
    flops = 2.0 * d_model * d_in_proj + 2.0 * d_inner * d_model \
        + 2.0 * ssm.d_conv * conv_ch \
        + 2.0 * 2 * H * ssm.head_dim * N  # state update + readout per token
    return LayerSpec(
        name=name, kind="ssm", params=params,
        acts=[
            ActTerm(f"{name}.in", ("B", "S", d_model), dtype,
                    ("batch", "seq", AXIS_EMBED)),
            ActTerm(f"{name}.zxbcdt", ("B", "S", d_in_proj), dtype,
                    ("batch", "seq", AXIS_FFN)),
            ActTerm(f"{name}.conv", ("B", "S", conv_ch), dtype,
                    ("batch", "seq", AXIS_FFN)),
            ActTerm(f"{name}.y", ("B", "S", d_inner), dtype,
                    ("batch", "seq", AXIS_FFN)),
            # per-chunk states saved by the scan across chunks
            ActTerm(f"{name}.chunk_states",
                    ("B", "S", H * ssm.head_dim * N // ssm.chunk), "float32",
                    ("batch", "seq", AXIS_SSM)),
        ],
        flops_per_token=flops,
        meta={"d_inner": d_inner, "n_heads": H, "head_dim": ssm.head_dim,
              "d_state": N, "n_groups": G, "d_conv": ssm.d_conv,
              "chunk": ssm.chunk, "d_in_proj": d_in_proj, "conv_ch": conv_ch,
              "state_bytes": 4 * H * ssm.head_dim * N
              + 2 * (ssm.d_conv - 1) * conv_ch})


# ---------------------------------------------------------------------------
# pieces of the block
# ---------------------------------------------------------------------------


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The type the reference accumulates in: fp32 (float64 for float64)."""
    return torch.promote_types(dtype, torch.float32)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` written as jax writes it,
    ``max(x, 0) + log1p(exp(-|x|))`` (``F.softplus`` switches to x above
    a threshold of 20 and rounds elsewhere)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def split_proj(zxbcdt: torch.Tensor, meta: dict):
    """(..., d_in_proj) -> views z, x, B, C, dt along the last dim."""
    d_inner, G, N = meta["d_inner"], meta["n_groups"], meta["d_state"]
    return torch.split(zxbcdt, [d_inner, d_inner, G * N, G * N,
                                meta["n_heads"]], dim=-1)


def xbc_of(zxbcdt: torch.Tensor, meta: dict) -> torch.Tensor:
    """The conv's input ``concat([x, B, C])``: the contiguous run of the
    projection between z and dt, as a view (the values the reference's
    concatenation copies)."""
    d_inner = meta["d_inner"]
    return zxbcdt[..., d_inner:d_inner + meta["conv_ch"]]


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (K, C), accumulated in fp32
    tap by tap (k = 0..K-1), the bias added last, cast to x's type."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=_acc(x.dtype), device=x.device)
    for k in range(K):
        out += xp[:, k:k + S].float() * w[k].float()
    return (out + b.float()).to(x.dtype)


def mamba2_init_state(meta: dict, batch: int, device) -> dict:
    H, P, N = meta["n_heads"], meta["head_dim"], meta["d_state"]
    return {
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, meta["d_conv"] - 1, meta["conv_ch"]),
                            dtype=torch.bfloat16, device=device),
    }


# ---------------------------------------------------------------------------
# chunked SSD core (the training path)
# ---------------------------------------------------------------------------


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) -> (..., Q, Q) with out[i, j] = sum_{k=j+1..i} a_k (i >=
    j), -inf above the diagonal: the reference's cumsum difference (not
    the "stable" segment sum of other Mamba code, which rounds
    differently)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def _ssd_chunk(A: torch.Tensor, out_dtype: torch.dtype, st: torch.Tensor,
               xq: torch.Tensor, dtq: torch.Tensor, Bq: torch.Tensor,
               Cq: torch.Tensor):
    """One chunk: the intra-chunk quadratic term and the state passed on.
    st (b, H, P, N) in the accumulation type; xq (b, Q, H, P), dtq (b, Q,
    H), Bq / Cq (b, Q, N) -> (new state, y (b, Q, H, P) in ``out_dtype``)."""
    acc = st.dtype
    a = (dtq * A[None, None, :]).movedim(-1, 1)           # (b, H, Q) <= 0
    a_cum = torch.cumsum(a, dim=-1)
    a_tot = a_cum[..., -1]                                 # (b, H)
    L = torch.exp(_segsum(a))                              # (b, H, Q, Q)
    Cf, Bf = Cq.to(acc), Bq.to(acc)
    scores = torch.einsum("bqn,bkn->bqk", Cf, Bf)          # (b, Q, Q)
    xdt = (xq * dtq[..., None]).to(acc)                    # (b, Q, H, P)
    y_diag = torch.einsum("bhqk,bkhp->bqhp", L * scores[:, None], xdt)
    y_off = torch.einsum("bqn,bhpn->bqhp", Cf, st) \
        * torch.exp(a_cum).movedim(1, -1)[..., None]
    decay_to_end = torch.exp(a_tot[..., None] - a_cum)     # (b, H, Q)
    new_st = st * torch.exp(a_tot)[..., None, None] + torch.einsum(
        "bqhp,bqn->bhpn", xdt * decay_to_end.movedim(1, -1)[..., None], Bf)
    return new_st, (y_diag + y_off).to(out_dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None):
    """SSD dual form, differentiable (the reference's ``ssd_chunked``).

    x: (b, S, H, P); dt: (b, S, H) (already softplus'd); A: (H,) negative
    reals; B, C: (b, S, G, N) with G == 1.  Returns (y (b, S, H, P) in
    x's type, final state (b, H, P, N) fp32).  A ragged last chunk is
    padded with zeros (dt = 0 there, so the state passes it unchanged).
    Each chunk's body runs under a non-reentrant checkpoint: its backward
    recomputes it from the state carried in, as the reference's
    ``jax.checkpoint`` inside ``lax.scan`` does."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    if B.shape[2] != 1:
        raise NotImplementedError("ssd_chunked: n_groups == 1 supported")
    Bm, Cm = B[:, :, 0], C[:, :, 0]                        # (b, S, N)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    acc = _acc(dt.dtype)
    st = initial_state.to(acc) if initial_state is not None \
        else torch.zeros((b, H, P, N), dtype=acc, device=x.device)
    ys = []
    for lo in range(0, S + pad, chunk):
        hi = lo + chunk
        st, y = _ckpt.checkpoint(_ssd_chunk, A, x.dtype, st, x[:, lo:hi],
                                 dt[:, lo:hi], Bm[:, lo:hi], Cm[:, lo:hi],
                                 use_reentrant=False)
        ys.append(y)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    return y[:, :S], st


# ---------------------------------------------------------------------------
# block applies
# ---------------------------------------------------------------------------


def mamba2_forward(p, hidden: torch.Tensor, meta: dict,
                   norm_eps: float = 1e-5) -> torch.Tensor:
    """The training block: ``mamba2_prefill``'s op chain with the SSD
    through ``ssd_chunked`` (differentiable) and no cache.  hidden: (B, S,
    d_model) -> (B, S, d_model)."""
    Bsz, S, _ = hidden.shape
    H, P, N, G = (meta["n_heads"], meta["head_dim"], meta["d_state"],
                  meta["n_groups"])
    if G != 1:
        raise NotImplementedError("Mamba-2 with n_groups > 1 is not ported")
    zxbcdt = hidden @ p.in_proj
    z, _, _, _, dt = split_proj(zxbcdt, meta)
    xbc = silu(causal_conv(xbc_of(zxbcdt, meta), p.conv_w, p.conv_b))
    xin, Bv, Cv = torch.split(xbc, [meta["d_inner"], N, N], dim=-1)
    dt = softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    xh = xin.reshape(Bsz, S, H, P)
    y, _ = ssd_chunked(xh, dt, A, Bv.reshape(Bsz, S, G, N),
                       Cv.reshape(Bsz, S, G, N), chunk=meta["chunk"])
    y = (y + xh * p.D[None, None, :, None]).to(hidden.dtype)
    y = y.reshape(Bsz, S, H * P)
    y = ops.rmsnorm(y * silu(z), p.norm_scale, norm_eps)
    return (y @ p.out_proj).to(hidden.dtype)


# ---------------------------------------------------------------------------
# serving applies
# ---------------------------------------------------------------------------


def mamba2_prefill(p, hidden: torch.Tensor, meta: dict,
                   norm_eps: float = 1e-5):
    """The block over a whole prompt (the body the reference's
    ``ssm_prefill`` inlines).  hidden: (B, S, d_model) -> (out, final ssm
    state (B, H, P, N) fp32, conv tail (B, min(S, K-1), conv_ch) bf16)."""
    Bsz, S, _ = hidden.shape
    H, P, N = meta["n_heads"], meta["head_dim"], meta["d_state"]
    if meta["n_groups"] != 1:
        raise NotImplementedError("Mamba-2 with n_groups > 1 is not ported")
    zxbcdt = hidden @ p.in_proj
    z, _, _, _, dt = split_proj(zxbcdt, meta)
    xbc = xbc_of(zxbcdt, meta)
    conv_tail = xbc[:, -(meta["d_conv"] - 1):].to(torch.bfloat16)
    xbc = silu(causal_conv(xbc, p.conv_w, p.conv_b))
    d_inner = meta["d_inner"]
    xin, Bv, Cv = torch.split(xbc, [d_inner, N, N], dim=-1)
    dt = softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    xh = xin.reshape(Bsz, S, H, P)                       # a view
    y, final_state = ops.ssd_scan(xh, dt, A, Bv, Cv, chunk=meta["chunk"])
    y = (y + xh * p.D[None, None, :, None]).to(hidden.dtype)
    y = y.reshape(Bsz, S, H * P)
    y = ops.rmsnorm(y * silu(z), p.norm_scale, norm_eps)
    return (y @ p.out_proj).to(hidden.dtype), final_state, conv_tail


def mamba2_decode(p, hidden: torch.Tensor, state: dict, meta: dict,
                  norm_eps: float = 1e-5):
    """hidden: (B, 1, d_model); the O(1) recurrent step -> (out, new ssm
    state, new conv window), new tensors (the caller writes them into its
    cache)."""
    Bsz = hidden.shape[0]
    H, P, N = meta["n_heads"], meta["head_dim"], meta["d_state"]
    zxbcdt = hidden @ p.in_proj
    z, _, _, _, dt = split_proj(zxbcdt[:, 0], meta)
    xbc = xbc_of(zxbcdt[:, 0], meta)                     # (B, conv_ch)
    window = torch.cat([state["conv"],
                        xbc[:, None].to(state["conv"].dtype)], dim=1)
    conv = (window.float() * p.conv_w.float()[None]).sum(1) \
        + p.conv_b.float()
    xbc = silu(conv).to(hidden.dtype)
    d_inner = meta["d_inner"]
    x, Bv, Cv = torch.split(xbc, [d_inner, N, N], dim=-1)
    dt = softplus(dt.float() + p.dt_bias)                # (B, H)
    A = -torch.exp(p.A_log)
    dA = torch.exp(dt * A[None, :])                      # (B, H)
    xh = x.reshape(Bsz, H, P).float()
    dBx = (xh * dt[..., None])[..., None] * Bv.float()[:, None, None, :]
    ssm = state["ssm"] * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", ssm, Cv.float())
    y = y + xh * p.D[None, :, None]
    y = y.reshape(Bsz, 1, H * P).to(hidden.dtype)
    y = ops.rmsnorm(y * silu(z)[:, None], p.norm_scale, norm_eps)
    out = (y @ p.out_proj).to(hidden.dtype)
    return out, ssm, window[:, 1:]
