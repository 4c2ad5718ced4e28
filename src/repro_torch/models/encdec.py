"""Encoder-decoder backbone (seamless-m4t-large-v2).

The speech frontend is a stub: inputs are precomputed frame embeddings
(B, T_enc, d_frontend).  Encoder: bidirectional transformer.  Decoder:
causal self-attention + cross-attention over the encoder memory, both
through the flash kernel (``kernels.ops.flash_attention``; the cross
attention non-causal with Sq = decoder length, Skv = encoder length).

The functions follow the reference's ``repro/models/encdec.py`` program:

* each encoder and decoder block runs under the remat policy
  (``transformer._remat``), as the LM's blocks do;
* the serving cache holds ``k``, ``v``, ``cross_k`` and ``cross_v`` in
  bf16 whatever the model's type;
* ``encdec_prefill`` computes each layer's cross K/V twice, once for the
  cache and once inside the block, and each layer's self K/V from its own
  ``norm1`` (``transformer._prefill_kv``), as the reference's program
  does: the memory measured is that of the program the predictor models.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.spec import ModuleSpec, AXIS_EMBED
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.attention import (decode_attention, gqa_decode,
                                          gqa_forward, gqa_spec)


def encdec_model_spec(cfg: ArchConfig) -> ModuleSpec:
    e = cfg.encdec
    frontend = ModuleSpec(
        name="frontend_proj", modality="audio",
        layers=[L.linear_spec("proj", e.d_frontend, cfg.d_model,
                              axes=(None, AXIS_EMBED))])
    enc_block = ModuleSpec(
        name="encoder_blocks", modality="audio", repeat=e.n_enc_layers,
        scanned=True,
        layers=[L.rmsnorm_spec("norm1", cfg.d_model, cfg.dtype),
                T.attn_spec_for(cfg),
                L.rmsnorm_spec("norm2", cfg.d_model, cfg.dtype),
                L.mlp_spec("ffn", cfg.d_model, cfg.d_ff, cfg.dtype)])
    enc_final = ModuleSpec(name="encoder_head", modality="audio",
                           layers=[L.rmsnorm_spec("enc_norm", cfg.d_model,
                                                  cfg.dtype)])
    encoder = ModuleSpec(name="speech_encoder", modality="audio",
                         children=[frontend, enc_block, enc_final])

    dec_block = ModuleSpec(
        name="decoder_blocks", modality="text", repeat=cfg.n_layers,
        scanned=True,
        layers=[L.rmsnorm_spec("norm1", cfg.d_model, cfg.dtype),
                T.attn_spec_for(cfg),
                L.rmsnorm_spec("norm_x", cfg.d_model, cfg.dtype),
                _cross_attn_spec(cfg),
                L.rmsnorm_spec("norm2", cfg.d_model, cfg.dtype),
                L.mlp_spec("ffn", cfg.d_model, cfg.d_ff, cfg.dtype)])
    decoder = ModuleSpec(
        name="text_decoder", modality="text",
        children=[
            ModuleSpec(name="embed", modality="text",
                       layers=[L.embedding_spec("tok", cfg.vocab, cfg.d_model,
                                                cfg.dtype, tied=cfg.tie_embeddings)]),
            dec_block,
            ModuleSpec(name="head", modality="text",
                       layers=[L.rmsnorm_spec("final_norm", cfg.d_model,
                                              cfg.dtype),
                               L.lm_head_spec("lm_head", cfg.d_model,
                                              cfg.vocab, cfg.dtype)]),
        ])
    return ModuleSpec(name="encdec", modality="multimodal",
                      children=[encoder, decoder])


def _cross_attn_spec(cfg: ArchConfig):
    s = gqa_spec("cross_attn", cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                 cfg.resolved_head_dim, dtype=cfg.dtype)
    s.meta["cross"] = True
    return s


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _encoder_block(cfg: ArchConfig, bp, x: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(bp.norm1, x, cfg.norm_eps)
    x = x + gqa_forward(bp.attn, h, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_kv_heads,
                        head_dim=cfg.resolved_head_dim,
                        theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
                        causal=False)
    h = L.rmsnorm(bp.norm2, x, cfg.norm_eps)
    return x + L.mlp(bp.ffn, h)


def encode(cfg: ArchConfig, p, frames: torch.Tensor,
           remat: Optional[str] = None) -> torch.Tensor:
    """frames (B, T_enc, d_frontend) -> encoder memory (B, T_enc, D);
    ``p`` holds ``speech_encoder``."""
    enc = p.speech_encoder
    x = L.linear(enc.frontend_proj.proj, frames)
    block = T._remat(functools.partial(_encoder_block, cfg),
                     remat if remat is not None else cfg.remat)
    for bp in enc.encoder_blocks:
        x = block(bp, x)
    return L.rmsnorm(enc.encoder_head.enc_norm, x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder: train / prefill / decode
# ---------------------------------------------------------------------------


def _cross_kv(cfg: ArchConfig, cp, memory: torch.Tensor) -> tuple:
    B, Te, _ = memory.shape
    hd = cfg.resolved_head_dim
    k = (memory @ cp.wk).reshape(B, Te, cfg.n_kv_heads, hd)
    v = (memory @ cp.wv).reshape(B, Te, cfg.n_kv_heads, hd)
    return k, v


def _decoder_block(cfg: ArchConfig, bp, x: torch.Tensor,
                   memory: torch.Tensor, positions=None) -> torch.Tensor:
    hd = cfg.resolved_head_dim
    h = L.rmsnorm(bp.norm1, x, cfg.norm_eps)
    x = x + gqa_forward(bp.attn, h, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_kv_heads, head_dim=hd,
                        theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
                        causal=True, positions=positions)
    h = L.rmsnorm(bp.norm_x, x, cfg.norm_eps)
    B, S, _ = h.shape
    q = (h @ bp.cross_attn.wq).reshape(B, S, cfg.n_heads, hd)
    k, v = _cross_kv(cfg, bp.cross_attn, memory)
    ctx = ops.flash_attention(q, k, v, False)
    x = x + ctx.reshape(B, S, -1) @ bp.cross_attn.wo
    h = L.rmsnorm(bp.norm2, x, cfg.norm_eps)
    return x + L.mlp(bp.ffn, h)


def encdec_loss(cfg: ArchConfig, params, batch: dict,
                remat: Optional[str] = None):
    """batch: {'frames': (B, T, d_frontend), 'tokens', 'labels': (B, S)}
    -> (loss, {"xent", "n_tok"})."""
    p = params.encdec
    memory = encode(cfg, p, batch["frames"], remat)
    dec = p.text_decoder
    x = T.embed_tokens(cfg, dec, batch["tokens"])
    block = T._remat(functools.partial(_decoder_block, cfg),
                     remat if remat is not None else cfg.remat)
    for bp in dec.decoder_blocks:
        x = block(bp, x, memory)
    x = L.rmsnorm(dec.head.final_norm, x, cfg.norm_eps)
    return T.xent_loss(cfg, dec, x, batch["labels"])


def encdec_init_cache(cfg: ArchConfig, batch: int, max_len: int,
                      enc_len: int, device) -> dict:
    """Stacked (L-leading) cache, zeroed, on ``device``: {'blocks': {'k',
    'v': (L, B, max_len, Hkv, D), 'cross_k', 'cross_v': (L, B, enc_len,
    Hkv, D)}, all bf16; 'len': (B,) int32}."""
    hd = cfg.resolved_head_dim

    def zeros(n):
        return torch.zeros((cfg.n_layers, batch, n, cfg.n_kv_heads, hd),
                           dtype=torch.bfloat16, device=device)
    return {"blocks": {"k": zeros(max_len), "v": zeros(max_len),
                       "cross_k": zeros(enc_len), "cross_v": zeros(enc_len)},
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def encdec_prefill(cfg: ArchConfig, params, batch: dict):
    """Encode + decoder prefill: the last position's logits (B, 1, V) fp32
    and the cache (:func:`encdec_init_cache`'s layout, max_len = S,
    enc_len = T_enc), each layer's self and cross K/V written straight
    into it."""
    p = params.encdec
    memory = encode(cfg, p, batch["frames"])
    dec = p.text_decoder
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = T.embed_tokens(cfg, dec, tokens)
    cache = encdec_init_cache(cfg, B, S, memory.shape[1], x.device)
    blocks = cache["blocks"]
    for i, bp in enumerate(dec.decoder_blocks):
        h = L.rmsnorm(bp.norm1, x, cfg.norm_eps)
        kv = T._prefill_kv(cfg, bp.attn, h)
        ck, cv = _cross_kv(cfg, bp.cross_attn, memory)
        blocks["k"][i], blocks["v"][i] = kv["k"], kv["v"]
        blocks["cross_k"][i], blocks["cross_v"][i] = ck, cv
        x = _decoder_block(cfg, bp, x, memory)
    cache["len"].fill_(S)
    x = L.rmsnorm(dec.head.final_norm, x[:, -1:], cfg.norm_eps)
    return T.lm_logits(cfg, dec, x), cache


def encdec_decode_step(cfg: ArchConfig, params, token: torch.Tensor,
                       cache: dict):
    """token: (B, 1) -> (logits (B, 1, V) fp32, cache).  The self K/V are
    written into the cache in place; the cross K/V are read only; the
    returned dict carries ``len + 1``."""
    p = params.encdec.text_decoder
    x = T.embed_tokens(cfg, p, token)
    length = cache["len"]
    hd = cfg.resolved_head_dim
    blocks = cache["blocks"]
    B = x.shape[0]
    enc_len = torch.full((B,), blocks["cross_k"].shape[2], dtype=torch.int32,
                         device=x.device)
    for i, bp in enumerate(p.decoder_blocks):
        h = L.rmsnorm(bp.norm1, x, cfg.norm_eps)
        a, _ = gqa_decode(bp.attn, h, {"k": blocks["k"][i],
                                       "v": blocks["v"][i], "len": length},
                          n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                          head_dim=hd, theta=cfg.rope_theta,
                          norm_eps=cfg.norm_eps)
        x = x + a
        h = L.rmsnorm(bp.norm_x, x, cfg.norm_eps)
        q = (h @ bp.cross_attn.wq).reshape(B, 1, cfg.n_heads, hd)
        ctx = decode_attention(q, blocks["cross_k"][i], blocks["cross_v"][i],
                               enc_len)
        x = x + ctx.reshape(B, 1, -1) @ bp.cross_attn.wo
        h = L.rmsnorm(bp.norm2, x, cfg.norm_eps)
        x = x + L.mlp(bp.ffn, h)
    x = L.rmsnorm(p.head.final_norm, x, cfg.norm_eps)
    return T.lm_logits(cfg, p, x), {"blocks": blocks, "len": length + 1}
