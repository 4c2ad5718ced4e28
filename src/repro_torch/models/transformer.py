"""Decoder-only LM family: llama / qwen / mistral (GQA, dense FFN).

Spec functions and the serving path.  Blocks are depth-stacked
(``scanned``) modules in the spec; their parameters are one
:class:`~repro_torch.models.param.ModuleParams` per block, walked by a
Python loop where the reference scans.  The loss the byte model describes
is a chunked, vocab-sharded cross-entropy that never materializes the full
(B, S, V) logits (``LOSS_CHUNK`` rows at a time); the loss and the train
step come with the backward kernels.  MLA attention and MoE FFNs are not
built yet: ``lm_spec`` raises ``NotImplementedError`` for configs that
need them.

The serving functions keep the reference's program so that the memory and
the launches measured are those of the program the predictor models:
``lm_prefill`` recomputes each block's K/V through ``_prefill_kv`` from its
own ``norm1`` (so ``norm1`` runs twice per block), and the KV cache is
bf16 whatever the model's type.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.spec import LayerSpec, ModuleSpec
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.attention import gqa_decode, gqa_forward, gqa_spec

LOSS_CHUNK = 512


def attn_spec_for(cfg: ArchConfig) -> LayerSpec:
    if cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention spec function is not ported yet")
    return gqa_spec("attn", cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim, cfg.qk_norm, cfg.dtype)


def _block_layers(cfg: ArchConfig) -> list[LayerSpec]:
    return [L.rmsnorm_spec("norm1", cfg.d_model, cfg.dtype),
            attn_spec_for(cfg),
            L.rmsnorm_spec("norm2", cfg.d_model, cfg.dtype),
            L.mlp_spec("ffn", cfg.d_model, cfg.d_ff, cfg.dtype)]


def lm_spec(cfg: ArchConfig, name: str = "language_model") -> ModuleSpec:
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE FFN spec function is not ported yet")
    children = [ModuleSpec(
        name="embed", modality="text",
        layers=[L.embedding_spec("tok", cfg.vocab, cfg.d_model, cfg.dtype,
                                 tied=cfg.tie_embeddings)])]
    children.append(ModuleSpec(
        name="blocks", modality="text", repeat=cfg.n_layers,
        scanned=True, layers=_block_layers(cfg)))
    final = [L.rmsnorm_spec("final_norm", cfg.d_model, cfg.dtype)]
    if not cfg.tie_embeddings:
        final.append(L.lm_head_spec("lm_head", cfg.d_model, cfg.vocab,
                                    cfg.dtype))
    children.append(ModuleSpec(name="head", modality="text", layers=final))
    return ModuleSpec(name=name, modality="text", children=children)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.mla or cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention / MoE FFN blocks are not ported yet")


def _attn_apply(cfg: ArchConfig, ap, h: torch.Tensor,
                positions) -> torch.Tensor:
    return gqa_forward(ap, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                       head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta,
                       qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps,
                       positions=positions)


def _block_apply(cfg: ArchConfig, bp, x: torch.Tensor,
                 positions=None) -> torch.Tensor:
    h = L.rmsnorm(bp.norm1, x, cfg.norm_eps)
    x = x + _attn_apply(cfg, bp.attn, h, positions)
    h = L.rmsnorm(bp.norm2, x, cfg.norm_eps)
    return x + L.mlp(bp.ffn, h)


def lm_backbone(cfg: ArchConfig, p, embeds: torch.Tensor,
                positions=None) -> torch.Tensor:
    """embeds: (B, S, D) -> final-normed hidden (B, S, D)."""
    _dense_only(cfg)
    x = embeds
    for bp in p.blocks:
        x = _block_apply(cfg, bp, x, positions)
    return L.rmsnorm(p.head.final_norm, x, cfg.norm_eps)


def embed_tokens(cfg: ArchConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    return L.embed(p.embed.tok, tokens)


def lm_logits(cfg: ArchConfig, p, hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return L.unembed(p.embed.tok, hidden)
    return L.linear(p.head.lm_head, hidden).float()


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                  device) -> dict:
    """Stacked (L-leading) cache: {'blocks': {'k', 'v': (L, B, max_len,
    Hkv, D) bf16}, 'len': (B,) int32}, zeroed, on ``device``."""
    _dense_only(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"blocks": {"k": torch.zeros(shape, dtype=torch.bfloat16,
                                        device=device),
                       "v": torch.zeros(shape, dtype=torch.bfloat16,
                                        device=device)},
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _prefill_kv(cfg: ArchConfig, ap, h: torch.Tensor) -> dict:
    """Recompute the cacheable K/V for a full sequence."""
    B, S, _ = h.shape
    hd = cfg.resolved_head_dim
    positions = torch.arange(S, device=h.device).expand(B, S)
    k = (h @ ap.wk).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        k = ops.rmsnorm(k, ap.k_norm, cfg.norm_eps)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    v = (h @ ap.wv).reshape(B, S, cfg.n_kv_heads, hd)
    return {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}


def prefill_embeds(cfg: ArchConfig, lm, x: torch.Tensor):
    """Prefill of the LM blocks over ready embeddings x (B, S, D): the
    last position's logits (B, 1, V) fp32 and the populated cache (sized
    to S).  Each block's K/V is written straight into the stacked cache."""
    _dense_only(cfg)
    B, S, _ = x.shape
    cache = init_kv_cache(cfg, B, S, x.device)
    for i, bp in enumerate(lm.blocks):
        h = L.rmsnorm(bp.norm1, x, cfg.norm_eps)
        kv = _prefill_kv(cfg, bp.attn, h)
        cache["blocks"]["k"][i] = kv["k"]
        cache["blocks"]["v"][i] = kv["v"]
        x = _block_apply(cfg, bp, x)
    cache["len"].fill_(S)
    x = L.rmsnorm(lm.head.final_norm, x[:, -1:], cfg.norm_eps)
    return lm_logits(cfg, lm, x), cache


def lm_prefill(cfg: ArchConfig, params, tokens: torch.Tensor):
    """Full-sequence prefill: last-position logits + populated cache
    (layout of :func:`init_kv_cache` with max_len == S)."""
    lm = params.language_model
    return prefill_embeds(cfg, lm, embed_tokens(cfg, lm, tokens))


def _decode_block(cfg: ArchConfig, bp, x: torch.Tensor, layer_cache: dict):
    h = L.rmsnorm(bp.norm1, x, cfg.norm_eps)
    a, new_cache = gqa_decode(bp.attn, h, layer_cache, n_heads=cfg.n_heads,
                              n_kv_heads=cfg.n_kv_heads,
                              head_dim=cfg.resolved_head_dim,
                              theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                              norm_eps=cfg.norm_eps)
    x = x + a
    h = L.rmsnorm(bp.norm2, x, cfg.norm_eps)
    return x + L.mlp(bp.ffn, h)


def decode_lm(cfg: ArchConfig, lm, token: torch.Tensor, cache: dict):
    """token: (B, 1) -> (logits (B, 1, V) fp32, cache).  The cache tensors
    are updated in place; the returned dict carries ``len + 1``."""
    _dense_only(cfg)
    x = embed_tokens(cfg, lm, token)
    length = cache["len"]
    k_all, v_all = cache["blocks"]["k"], cache["blocks"]["v"]
    for i, bp in enumerate(lm.blocks):
        x = _decode_block(cfg, bp, x, {"k": k_all[i], "v": v_all[i],
                                       "len": length})
    x = L.rmsnorm(lm.head.final_norm, x, cfg.norm_eps)
    return lm_logits(cfg, lm, x), {"blocks": {"k": k_all, "v": v_all},
                                   "len": length + 1}


def lm_decode_step(cfg: ArchConfig, params, token: torch.Tensor,
                   cache: dict):
    """token: (B, 1) -> (logits (B, 1, V), new cache)."""
    return decode_lm(cfg, params.language_model, token, cache)
