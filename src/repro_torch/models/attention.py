"""Attention: GQA (llama/qwen/mistral-style) and MLA (deepseek/minicpm-style).

* ``gqa_spec`` / ``mla_spec`` — the parameter leaves and saved activations
  of a grouped-query / multi-head latent attention layer as the memory
  predictor reads them;
* ``gqa_forward`` — full-sequence attention through the flash kernel
  (``kernels.ops.flash_attention``), where the reference calls its
  pure-``lax`` twin of the Pallas kernel;
* ``gqa_decode`` / ``decode_attention`` — one token against the KV cache,
  plain PyTorch as in the reference (no kernel there either).

The MLA forward (``mla_forward`` / ``mla_decode``) is not ported yet: it
comes with the runnable MLA family (ROADMAP A7b) and raises until then.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.spec import (ActTerm, LayerSpec, ParamSpec,
                                   AXIS_EMBED, AXIS_HEADS, AXIS_KV_HEADS,
                                   AXIS_LORA)
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def gqa_spec(name: str, d_model: int, n_heads: int, n_kv_heads: int,
             head_dim: int, qk_norm: bool = False,
             dtype: str = "bfloat16") -> LayerSpec:
    params = {
        "wq": ParamSpec((d_model, n_heads * head_dim), dtype,
                        (AXIS_EMBED, AXIS_HEADS)),
        "wk": ParamSpec((d_model, n_kv_heads * head_dim), dtype,
                        (AXIS_EMBED, AXIS_KV_HEADS)),
        "wv": ParamSpec((d_model, n_kv_heads * head_dim), dtype,
                        (AXIS_EMBED, AXIS_KV_HEADS)),
        "wo": ParamSpec((n_heads * head_dim, d_model), dtype,
                        (AXIS_HEADS, AXIS_EMBED)),
    }
    if qk_norm:
        params["q_norm"] = ParamSpec((head_dim,), dtype, (None,), init="ones")
        params["k_norm"] = ParamSpec((head_dim,), dtype, (None,), init="ones")
    proj_flops = 2.0 * d_model * head_dim * (2 * n_heads + 2 * n_kv_heads)
    return LayerSpec(
        name=name, kind="attention", params=params,
        acts=[
            # 4-D head layouts mirror the runtime's reshape-then-shard order:
            # a head count that does not divide the mesh axis replicates in
            # BOTH the live code and the prediction (e.g. smollm's 15 heads).
            ActTerm(f"{name}.in", ("B", "S", d_model), dtype,
                    ("batch", "seq", AXIS_EMBED)),
            ActTerm(f"{name}.q", ("B", "S", n_heads, head_dim), dtype,
                    ("batch", "seq", AXIS_HEADS, None)),
            ActTerm(f"{name}.k", ("B", "S", n_kv_heads, head_dim), dtype,
                    ("batch", "seq", AXIS_KV_HEADS, None)),
            ActTerm(f"{name}.v", ("B", "S", n_kv_heads, head_dim), dtype,
                    ("batch", "seq", AXIS_KV_HEADS, None)),
            ActTerm(f"{name}.ctx", ("B", "S", n_heads, head_dim), dtype,
                    ("batch", "seq", AXIS_HEADS, None)),
            # flash softmax statistics (fp32 lse per head per position)
            ActTerm(f"{name}.lse", ("B", n_heads, "S"), "float32",
                    ("batch", "heads", "seq")),
        ],
        flops_per_token=proj_flops,
        meta={"n_heads": n_heads, "n_kv_heads": n_kv_heads,
              "head_dim": head_dim, "qk_norm": qk_norm, "d_model": d_model,
              "kv_bytes_per_token": 2 * n_kv_heads * head_dim,
              "attn_kind": "gqa"})


def mla_spec(name: str, d_model: int, n_heads: int, mla,
             dtype: str = "bfloat16") -> LayerSpec:
    """DeepSeek-V2-style multi-head latent attention.

    Decode caches only (kv_lora + rope_dim) per token — the spec records
    that via ``kv_bytes_per_token`` so cache prediction is exact.
    """
    qk_head = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    params: dict[str, ParamSpec] = {}
    if mla.q_lora_rank:
        params["wq_a"] = ParamSpec((d_model, mla.q_lora_rank), dtype,
                                   (AXIS_EMBED, AXIS_LORA))
        params["q_norm"] = ParamSpec((mla.q_lora_rank,), dtype, (None,),
                                     init="ones")
        params["wq_b"] = ParamSpec((mla.q_lora_rank, n_heads * qk_head),
                                   dtype, (AXIS_LORA, AXIS_HEADS))
        q_flops = 2.0 * d_model * mla.q_lora_rank \
            + 2.0 * mla.q_lora_rank * n_heads * qk_head
    else:
        params["wq"] = ParamSpec((d_model, n_heads * qk_head), dtype,
                                 (AXIS_EMBED, AXIS_HEADS))
        q_flops = 2.0 * d_model * n_heads * qk_head
    params.update({
        "wkv_a": ParamSpec((d_model, mla.kv_lora_rank + mla.qk_rope_head_dim),
                           dtype, (AXIS_EMBED, None)),
        "kv_norm": ParamSpec((mla.kv_lora_rank,), dtype, (None,), init="ones"),
        "wkv_b": ParamSpec((mla.kv_lora_rank,
                            n_heads * (mla.qk_nope_head_dim + mla.v_head_dim)),
                           dtype, (AXIS_LORA, AXIS_HEADS)),
        "wo": ParamSpec((n_heads * mla.v_head_dim, d_model), dtype,
                        (AXIS_HEADS, AXIS_EMBED)),
    })
    flops = (q_flops
             + 2.0 * d_model * (mla.kv_lora_rank + mla.qk_rope_head_dim)
             + 2.0 * mla.kv_lora_rank * n_heads
             * (mla.qk_nope_head_dim + mla.v_head_dim)
             + 2.0 * n_heads * mla.v_head_dim * d_model)
    return LayerSpec(
        name=name, kind="attention", params=params,
        acts=[
            ActTerm(f"{name}.in", ("B", "S", d_model), dtype,
                    ("batch", "seq", AXIS_EMBED)),
            ActTerm(f"{name}.q", ("B", "S", n_heads, qk_head), dtype,
                    ("batch", "seq", AXIS_HEADS, None)),
            ActTerm(f"{name}.kv_latent", ("B", "S",
                                          mla.kv_lora_rank + mla.qk_rope_head_dim),
                    dtype, ("batch", "seq", None)),
            ActTerm(f"{name}.k", ("B", "S", n_heads, qk_head), dtype,
                    ("batch", "seq", AXIS_HEADS, None)),
            ActTerm(f"{name}.v", ("B", "S", n_heads, mla.v_head_dim), dtype,
                    ("batch", "seq", AXIS_HEADS, None)),
            ActTerm(f"{name}.ctx", ("B", "S", n_heads, mla.v_head_dim), dtype,
                    ("batch", "seq", AXIS_HEADS, None)),
            ActTerm(f"{name}.lse", ("B", n_heads, "S"), "float32",
                    ("batch", "heads", "seq")),
        ],
        flops_per_token=flops,
        meta={"n_heads": n_heads, "head_dim": qk_head,
              "v_head_dim": mla.v_head_dim, "mla": mla,
              "d_model": d_model,
              "kv_bytes_per_token": 2 * (mla.kv_lora_rank + mla.qk_rope_head_dim),
              "attn_kind": "mla"})


# ---------------------------------------------------------------------------
# applies
# ---------------------------------------------------------------------------


def gqa_forward(p, x: torch.Tensor, *, n_heads: int, n_kv_heads: int,
                head_dim: int, theta: float, qk_norm: bool = False,
                norm_eps: float = 1e-5, causal: bool = True,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q = (x @ p.wq).reshape(B, S, n_heads, head_dim)
    k = (x @ p.wk).reshape(B, S, n_kv_heads, head_dim)
    v = (x @ p.wv).reshape(B, S, n_kv_heads, head_dim)
    if qk_norm:
        q = ops.rmsnorm(q, p.q_norm, norm_eps)
        k = ops.rmsnorm(k, p.k_norm, norm_eps)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    ctx = ops.flash_attention(q, k, v, causal)
    return ctx.reshape(B, S, n_heads * head_dim) @ p.wo


def gqa_decode(p, x: torch.Tensor, cache: dict, *, n_heads: int,
               n_kv_heads: int, head_dim: int, theta: float,
               qk_norm: bool = False, norm_eps: float = 1e-5) -> tuple:
    """One-token decode: x (B, 1, d); cache {'k','v': (B, S_max, Hkv, D),
    'len': (B,)} -> (out, new_cache).

    The new K/V land at position ``cache["len"][0]`` of every row, as in
    the reference; the write is IN PLACE into the cache tensors (the
    reference donates the cache so XLA aliases the update — the memory
    the predictor models).  The index stays on the device: no host sync.
    """
    B = x.shape[0]
    pos = cache["len"][:, None]                                   # (B,1)
    q = (x @ p.wq).reshape(B, 1, n_heads, head_dim)
    k = (x @ p.wk).reshape(B, 1, n_kv_heads, head_dim)
    v = (x @ p.wv).reshape(B, 1, n_kv_heads, head_dim)
    if qk_norm:
        q = ops.rmsnorm(q, p.q_norm, norm_eps)
        k = ops.rmsnorm(k, p.k_norm, norm_eps)
    q = apply_rope(q, pos, theta)
    k = apply_rope(k, pos, theta)
    at = cache["len"][:1].long()
    k_cache = cache["k"].index_copy_(1, at, k.to(cache["k"].dtype))
    v_cache = cache["v"].index_copy_(1, at, v.to(cache["v"].dtype))
    ctx = decode_attention(q, k_cache, v_cache, cache["len"] + 1)
    out = ctx.reshape(B, 1, n_heads * head_dim) @ p.wo
    return out, {"k": k_cache, "v": v_cache, "len": cache["len"] + 1}


def decode_attention(q, k_cache, v_cache, kv_len):
    """q: (B, 1, H, D); caches: (B, S_max, Hkv, D); kv_len: (B,).

    q is scaled in its own type before the dot, as the reference does
    (the flash path upcasts first); products accumulate in fp32."""
    B, _, H, Dq = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = (q * Dq ** -0.5).reshape(B, 1, Hkv, G, Dq)
    s = torch.einsum("bshgd,bthd->bshgt", qg.float(),
                     k_cache.to(qg.dtype).float())
    valid = torch.arange(Smax, device=q.device)[None] < kv_len[:, None]
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    piv = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bshgt,bthd->bshgd",
                       piv.to(v_cache.dtype).float(), v_cache.float())
    return ctx.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


def mla_forward(*args, **kwargs):
    raise NotImplementedError(
        "MLA attention's forward (mla_forward, mla_decode) is not ported "
        "yet: it comes with the runnable MLA family (ROADMAP A7b)")


mla_decode = mla_forward
