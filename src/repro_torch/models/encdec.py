"""Encoder-decoder backbone (seamless-m4t-large-v2): the spec half.

The speech frontend is a stub: inputs are precomputed frame embeddings
(B, T_enc, d_frontend).  Encoder: bidirectional transformer.  Decoder:
causal self-attention + cross-attention over the encoder memory.

The forward (``encode``, cross-attention, ``encdec_loss``,
``encdec_prefill``, ``encdec_decode_step``, ``encdec_init_cache``) is not
ported yet: it comes with the runnable enc-dec family (ROADMAP A7e);
until then the model's entry points raise (``models.registry``).
"""

from __future__ import annotations

from repro_torch.configs import ArchConfig
from repro_torch.core.spec import ModuleSpec, AXIS_EMBED
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.attention import gqa_spec


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
