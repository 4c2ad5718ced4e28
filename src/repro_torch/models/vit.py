"""CLIP-style ViT vision tower (real params — used by the paper-repro
llava15-7b config, where the tower is FROZEN during both training stages):
its spec and its forward pass, with non-causal attention through the flash
kernel (``kernels.ops.flash_attention``) on the ragged 577-token sequence
(576 patches + CLS)."""

from __future__ import annotations

import torch

from repro_torch.core.spec import LayerSpec, ModuleSpec, ParamSpec, AXIS_EMBED
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.attention import gqa_spec


def vit_spec(vlm, dtype: str = "bfloat16") -> ModuleSpec:
    d = vlm.d_vision
    n_patches = (vlm.vit_image_size // vlm.vit_patch) ** 2
    patch_dim = 3 * vlm.vit_patch ** 2
    head_dim = d // vlm.vit_heads
    embed = ModuleSpec(
        name="patch_embed", modality="vision",
        layers=[
            L.linear_spec("proj", patch_dim, d, axes=(None, AXIS_EMBED)),
            LayerSpec("pos_embed", "embedding",
                      params={"w": ParamSpec((n_patches + 1, d), dtype,
                                             (None, AXIS_EMBED), init="embed"),
                              "cls": ParamSpec((d,), dtype, (AXIS_EMBED,),
                                               init="embed")},
                      acts=[], flops_per_token=0.0,
                      meta={"n_patches": n_patches}),
            L.layernorm_spec("ln_pre", d, dtype),
        ])
    block = ModuleSpec(
        name="blocks", modality="vision", repeat=vlm.vit_layers, scanned=True,
        layers=[
            L.layernorm_spec("ln1", d, dtype),
            _vit_attn_spec(d, vlm.vit_heads, head_dim, dtype),
            L.layernorm_spec("ln2", d, dtype),
            L.mlp_spec("mlp", d, vlm.vit_d_ff, dtype, gated=False),
        ])
    post = ModuleSpec(name="post", modality="vision",
                      layers=[L.layernorm_spec("ln_post", d, dtype)])
    return ModuleSpec(name="vision_tower", modality="vision",
                      children=[embed, block, post])


def _vit_attn_spec(d, n_heads, head_dim, dtype):
    spec = gqa_spec("attn", d, n_heads, n_heads, head_dim, dtype=dtype)
    spec.meta["causal"] = False
    return spec


def vit_forward(params, patches: torch.Tensor, vlm,
                norm_eps: float = 1e-5) -> torch.Tensor:
    """patches: (B, n_patches, 3*patch^2) pre-extracted pixel patches ->
    (B, n_patches, d_vision); ``params`` holds ``vision_tower``."""
    p = params.vision_tower
    emb = p.patch_embed
    x = L.linear(emb.proj, patches)
    B, _, d = x.shape
    cls = emb.pos_embed.cls.expand(B, 1, d).to(x.dtype)
    x = torch.cat([cls, x], dim=1)
    x = x + emb.pos_embed.w[None, :x.shape[1]]
    x = L.layernorm(emb.ln_pre, x, norm_eps)

    n_heads = vlm.vit_heads
    head_dim = vlm.d_vision // n_heads
    for bp in p.blocks:
        h = L.layernorm(bp.ln1, x, norm_eps)
        B_, S_, _ = h.shape
        q = (h @ bp.attn.wq).reshape(B_, S_, n_heads, head_dim)
        k = (h @ bp.attn.wk).reshape(B_, S_, n_heads, head_dim)
        v = (h @ bp.attn.wv).reshape(B_, S_, n_heads, head_dim)
        ctx = ops.flash_attention(q, k, v, False)
        x = x + ctx.reshape(B_, S_, -1) @ bp.attn.wo
        h = L.layernorm(bp.ln2, x, norm_eps)
        x = x + L.mlp(bp.mlp, h)
    x = L.layernorm(p.post.ln_post, x, norm_eps)
    return x[:, 1:]                                      # drop CLS
