"""Hybrid SSM + shared-attention model (zamba2-2.7b): the spec half.

54 Mamba-2 blocks (stacked per segment) with 2 weight-tied ("shared")
full-attention transformer blocks applied before every ``attn_every``-th
mamba layer, alternating A/B (zamba2's global shared blocks; the
per-invocation LoRA is omitted).  The KV cache exists only for the shared
blocks' invocations, which is why this arch runs long_500k.

The forward (``hybrid_loss``, ``hybrid_prefill``, ``hybrid_decode_step``,
``hybrid_init_cache``) is not ported yet: it comes with the runnable
hybrid family (ROADMAP A7d); until then the model's entry points raise
(``models.registry``).
"""

from __future__ import annotations

from repro_torch.configs import ArchConfig
from repro_torch.core.spec import ModuleSpec
from repro_torch.models import layers as L
from repro_torch.models.attention import gqa_spec
from repro_torch.models.mamba import mamba2_spec


def _n_attn_invocations(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.hybrid.attn_every


def hybrid_model_spec(cfg: ArchConfig, name: str = "language_model") -> ModuleSpec:
    shared = ModuleSpec(
        name="shared_attn", modality="text",
        repeat=cfg.hybrid.shared_attn_blocks, scanned=True,
        layers=[L.rmsnorm_spec("norm1", cfg.d_model, cfg.dtype),
                gqa_spec("attn", cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.resolved_head_dim, dtype=cfg.dtype),
                L.rmsnorm_spec("norm2", cfg.d_model, cfg.dtype),
                L.mlp_spec("ffn", cfg.d_model, cfg.d_ff, cfg.dtype)])
    # Weight tying: 2 distinct blocks, but n_layers/attn_every INVOCATIONS.
    # Params/grads/opt scale with the weight count (repeat=2); activations
    # and KV-cache slots scale with invocations, and the invocations are
    # unrolled (no scan remat).  The predictor reads these markers.
    for lyr in shared.layers:
        lyr.meta["invocation_repeat"] = _n_attn_invocations(cfg)
    shared.layers[1].meta["cache_repeat"] = _n_attn_invocations(cfg)
    children = [
        ModuleSpec(name="embed", modality="text",
                   layers=[L.embedding_spec("tok", cfg.vocab, cfg.d_model,
                                            cfg.dtype, tied=cfg.tie_embeddings)]),
        shared,
        ModuleSpec(name="blocks", modality="text", repeat=cfg.n_layers,
                   scanned=True,
                   layers=[L.rmsnorm_spec("norm", cfg.d_model, cfg.dtype),
                           mamba2_spec("mixer", cfg.d_model, cfg.ssm,
                                       cfg.dtype)]),
        ModuleSpec(name="head", modality="text",
                   layers=[L.rmsnorm_spec("final_norm", cfg.d_model,
                                          cfg.dtype)]),
    ]
    return ModuleSpec(name=name, modality="text", children=children)
