"""Decoder-only LM family: llama / qwen / mistral (GQA, dense FFN).

Spec functions only.  Blocks are depth-stacked (``scanned``) modules; the
loss the byte model describes is a chunked, vocab-sharded cross-entropy
that never materializes the full (B, S, V) logits (``LOSS_CHUNK`` rows at
a time).  MLA attention and MoE FFNs are not built yet: ``lm_spec`` raises
``NotImplementedError`` for configs that need them.
"""

from __future__ import annotations

from repro_torch.configs import ArchConfig
from repro_torch.core.spec import LayerSpec, ModuleSpec
from repro_torch.models import layers as L
from repro_torch.models.attention import gqa_spec

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
