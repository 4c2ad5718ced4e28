"""CLIP-style ViT vision tower spec (used by the paper-repro llava15-7b
config, where the tower is FROZEN during both training stages).  Spec
function only; the forward pass arrives with the runnable model zoo."""

from __future__ import annotations

from repro_torch.core.spec import LayerSpec, ModuleSpec, ParamSpec, AXIS_EMBED
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
