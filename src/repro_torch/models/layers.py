"""Fine-grained layers: spec builders + forward applies.

Every builder returns a :class:`LayerSpec` whose ``params`` dict names the
parameter leaves of the layer and whose ``acts``/``flops`` metadata feed the
memory predictor.  The applies take the layer's
:class:`~repro_torch.models.param.LayerParams` and follow the reference's
``repro/models/layers.py`` op for op, in the same dtypes: RMSNorm goes
through the kernel (``kernels.ops.rmsnorm``), the rest is plain PyTorch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.spec import (ActTerm, LayerSpec, ParamSpec,
                                   AXIS_EMBED, AXIS_FFN, AXIS_VOCAB)
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------


def linear_spec(name: str, d_in: int, d_out: int,
                axes=(AXIS_EMBED, AXIS_FFN), dtype: str = "bfloat16",
                bias: bool = False, out_act_axes=("batch", None, AXIS_FFN),
                init_scale: float = 1.0) -> LayerSpec:
    params = {"w": ParamSpec((d_in, d_out), dtype, axes, init_scale=init_scale)}
    if bias:
        params["b"] = ParamSpec((d_out,), dtype, (axes[1],), init="zeros")
    return LayerSpec(
        name=name, kind="linear", params=params,
        acts=[ActTerm(f"{name}.in", ("B", "S", d_in), dtype,
                      ("batch", "seq", axes[0]))],
        flops_per_token=2.0 * d_in * d_out,
        meta={"d_in": d_in, "d_out": d_out})


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)`` in the promoted type of x and w, as ``jnp.matmul``
    types it (an fp32 config keeps the projector's and the patch
    projection's bf16 weights)."""
    dt = torch.promote_types(x.dtype, p.w.dtype)
    y = x.to(dt) @ p.w.to(dt)
    if "b" in p:
        y = y + p.b
    return y


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def embedding_spec(name: str, vocab: int, d_model: int,
                   dtype: str = "bfloat16", tied: bool = False) -> LayerSpec:
    """Untied tables shard columns (embed_cols -> model): the lookup then
    never gathers the table.  Tied tables must stay vocab-sharded for the
    vocab-parallel loss; the lookup's table all-gather is modelled by the
    predictor (meta['lookup_gather'])."""
    axes = (AXIS_VOCAB, AXIS_EMBED) if tied else (None, "embed_cols")
    return LayerSpec(
        name=name, kind="embedding",
        params={"w": ParamSpec((vocab, d_model), dtype, axes, init="embed")},
        acts=[ActTerm(f"{name}.ids", ("B", "S"), "int32", ("batch", "seq"))],
        flops_per_token=0.0,
        meta={"vocab": vocab, "d_model": d_model, "lookup_gather": tied})


def embed(p, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, p.w)


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 (loss numerics)."""
    return (x @ p.w.T).float()


def lm_head_spec(name: str, d_model: int, vocab: int,
                 dtype: str = "bfloat16") -> LayerSpec:
    return LayerSpec(
        name=name, kind="linear",
        params={"w": ParamSpec((d_model, vocab), dtype,
                               (AXIS_EMBED, AXIS_VOCAB))},
        acts=[ActTerm(f"{name}.in", ("B", "S", d_model), dtype,
                      ("batch", "seq", AXIS_EMBED))],
        flops_per_token=2.0 * d_model * vocab,
        meta={"d_in": d_model, "d_out": vocab})


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(name: str, d: int, dtype: str = "bfloat16") -> LayerSpec:
    return LayerSpec(
        name=name, kind="rmsnorm",
        params={"scale": ParamSpec((d,), dtype, (None,), init="ones")},
        acts=[ActTerm(f"{name}.in", ("B", "S", d), dtype,
                      ("batch", "seq", AXIS_EMBED))],
        flops_per_token=5.0 * d,
        meta={"d": d})


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return ops.rmsnorm(x, p.scale, eps)


def layernorm_spec(name: str, d: int, dtype: str = "bfloat16") -> LayerSpec:
    return LayerSpec(
        name=name, kind="layernorm",
        params={"scale": ParamSpec((d,), dtype, (None,), init="ones"),
                "bias": ParamSpec((d,), dtype, (None,), init="zeros")},
        acts=[ActTerm(f"{name}.in", ("B", "S", d), dtype,
                      ("batch", "seq", AXIS_EMBED))],
        flops_per_token=8.0 * d,
        meta={"d": d})


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p.scale.float() + p.bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_spec(name: str, d_model: int, d_ff: int,
             dtype: str = "bfloat16", gated: bool = True) -> LayerSpec:
    if gated:
        params = {
            "wg": ParamSpec((d_model, d_ff), dtype, (AXIS_EMBED, AXIS_FFN)),
            "wu": ParamSpec((d_model, d_ff), dtype, (AXIS_EMBED, AXIS_FFN)),
            "wd": ParamSpec((d_ff, d_model), dtype, (AXIS_FFN, AXIS_EMBED)),
        }
        flops = 2.0 * d_model * d_ff * 3
        n_ff_acts = 3
    else:
        params = {
            "wu": ParamSpec((d_model, d_ff), dtype, (AXIS_EMBED, AXIS_FFN)),
            "wd": ParamSpec((d_ff, d_model), dtype, (AXIS_FFN, AXIS_EMBED)),
        }
        flops = 2.0 * d_model * d_ff * 2
        n_ff_acts = 2
    return LayerSpec(
        name=name, kind="mlp", params=params,
        acts=[ActTerm(f"{name}.in", ("B", "S", d_model), dtype,
                      ("batch", "seq", AXIS_EMBED))]
             + [ActTerm(f"{name}.h{i}", ("B", "S", d_ff), dtype,
                        ("batch", "seq", AXIS_FFN)) for i in range(n_ff_acts)],
        flops_per_token=flops,
        meta={"d_model": d_model, "d_ff": d_ff, "gated": gated})


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, every
    op rounding to x's type — the program the reference's ``jax.nn.silu``
    lowers to.  ``F.silu`` rounds once and lands one bf16 ulp away on a
    third of the elements, which two blocks grow past the parity tests'
    tolerance; written out, the dense models match the reference
    bit for bit."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation, as the reference
    writes it (each op rounding to x's type); the same function as
    ``F.gelu(x, approximate="tanh")`` up to those roundings."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU when the layer has a gate, else GELU (tanh approximation)."""
    if "wg" in p:
        h = silu(x @ p.wg) * (x @ p.wu)
    else:
        h = gelu_tanh(x @ p.wu)
    return h @ p.wd


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)                      # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotated split-half; positions: (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs      # (..., S, D/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
