"""Attention: GQA (llama/qwen/mistral-style) and MLA (deepseek/minicpm-style).

* ``gqa_spec`` / ``mla_spec`` — the parameter leaves and saved activations
  of a grouped-query / multi-head latent attention layer as the memory
  predictor reads them;
* ``gqa_forward`` — full-sequence attention through the flash kernel
  (``kernels.ops.flash_attention``), where the reference calls its
  pure-``lax`` twin of the Pallas kernel;
* ``gqa_decode`` / ``decode_attention`` — one token against the KV cache,
  plain PyTorch as in the reference (no kernel there either);
* ``mla_forward`` / ``mla_decode`` — multi-head latent attention: q (through
  the low-rank ``wq_a`` / ``q_norm`` / ``wq_b`` where the config has a q
  rank), the normed kv latent and the un-roped rope key (``_mla_q``,
  ``_mla_kv``), the latent expanded to full-head k and v
  (``_mla_expand_kv``), and the flash kernel at the head dims (qk_nope +
  qk_rope, v); the decode step caches only the latent and the raw rope key
  and, as the reference does, ropes and re-expands the whole cache on every
  step before plain ``decode_attention``.
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


def _mla_q(p, x: torch.Tensor, mla, n_heads: int,
           norm_eps: float) -> torch.Tensor:
    """q (B, S, H, qk_nope + qk_rope), through the q rank where the layer
    has one (``wq_a``, ``q_norm``, ``wq_b``)."""
    B, S, _ = x.shape
    qk_head = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    if "wq_a" in p:
        qa = ops.rmsnorm(x @ p.wq_a, p.q_norm, norm_eps)
        return (qa @ p.wq_b).reshape(B, S, n_heads, qk_head)
    return (x @ p.wq).reshape(B, S, n_heads, qk_head)


def _mla_kv(p, x: torch.Tensor, mla, norm_eps: float) -> tuple:
    """(normed latent (B, S, kv_lora), raw rope key (B, S, qk_rope)): both
    come out of one product with ``wkv_a``; the rope key is a view of it."""
    latent, k_rope = (x @ p.wkv_a).split(
        [mla.kv_lora_rank, mla.qk_rope_head_dim], dim=-1)
    return ops.rmsnorm(latent, p.kv_norm, norm_eps), k_rope


def _mla_qkv(p, x: torch.Tensor, mla, n_heads: int, norm_eps: float):
    """The reference's ``_mla_qkv``: (q, latent, k_rope)."""
    return (_mla_q(p, x, mla, n_heads, norm_eps),
            *_mla_kv(p, x, mla, norm_eps))


def _mla_expand_kv(p, latent: torch.Tensor, k_rope: torch.Tensor,
                   positions: torch.Tensor, mla, n_heads: int) -> tuple:
    """The latent (B, S, kv_lora) and raw rope key (B, S, qk_rope) ->
    k (B, S, H, qk_nope + qk_rope), a real tensor (the rope key roped at
    ``positions`` with theta 10,000 and broadcast over the heads), and v
    (B, S, H, v_head), a view of the expanded latent.  A latent in
    another type than ``wkv_b`` (the bf16 cache of an fp32 model) is
    cast to it, as the reference's type promotion does."""
    B, S, _ = latent.shape
    w = p.wkv_b
    kv = (latent.to(w.dtype) @ w).reshape(
        B, S, n_heads, mla.qk_nope_head_dim + mla.v_head_dim)
    k_nope, v = kv.split([mla.qk_nope_head_dim, mla.v_head_dim], dim=-1)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, 10000.0)
    k_rope = k_rope.to(k_nope.dtype).expand(B, S, n_heads,
                                            mla.qk_rope_head_dim)
    return torch.cat([k_nope, k_rope], dim=-1), v


def _rope_q(q: torch.Tensor, positions: torch.Tensor, mla) -> torch.Tensor:
    q_nope, q_rope = q.split([mla.qk_nope_head_dim, mla.qk_rope_head_dim],
                             dim=-1)
    return torch.cat([q_nope, apply_rope(q_rope, positions, 10000.0)],
                     dim=-1)


def mla_forward(p, x: torch.Tensor, *, n_heads: int, mla,
                norm_eps: float = 1e-5, causal: bool = True,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence MLA through the flash kernel at head dims (qk_nope +
    qk_rope, v_head); the softmax scale is (qk_nope + qk_rope) ** -0.5."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, latent, k_rope = _mla_qkv(p, x, mla, n_heads, norm_eps)
    q = _rope_q(q, positions, mla)
    k, v = _mla_expand_kv(p, latent, k_rope, positions, mla, n_heads)
    ctx = ops.flash_attention(q, k, v, causal)
    return ctx.reshape(B, S, n_heads * mla.v_head_dim) @ p.wo


def mla_decode(p, x: torch.Tensor, cache: dict, *, n_heads: int, mla,
               norm_eps: float = 1e-5) -> tuple:
    """One-token MLA decode: cache {'latent': (B, S_max, kv_lora),
    'k_rope': (B, S_max, qk_rope), 'len': (B,)} -> (out, new_cache).

    The new latent and raw rope key land at position ``cache["len"][0]``,
    IN PLACE (as :func:`gqa_decode`); then, as the reference does, every
    one of the S_max positions is roped and expanded to full-head k and v
    before plain :func:`decode_attention`."""
    B = x.shape[0]
    pos = cache["len"][:, None]
    q, latent, k_rope = _mla_qkv(p, x, mla, n_heads, norm_eps)
    q = _rope_q(q, pos, mla)
    at = cache["len"][:1].long()
    lat_c = cache["latent"].index_copy_(
        1, at, latent.to(cache["latent"].dtype))
    kr_c = cache["k_rope"].index_copy_(1, at,
                                       k_rope.to(cache["k_rope"].dtype))
    Smax = lat_c.shape[1]
    positions = torch.arange(Smax, device=x.device).expand(B, Smax)
    k, v = _mla_expand_kv(p, lat_c, kr_c, positions, mla, n_heads)
    ctx = decode_attention(q, k, v, cache["len"] + 1)
    out = ctx.reshape(B, 1, n_heads * mla.v_head_dim) @ p.wo
    return out, {"latent": lat_c, "k_rope": kr_c, "len": cache["len"] + 1}
