"""Vision-language model specs.

* llava-next-mistral-7b: STUB anyres frontend — the input is precomputed
  patch embeddings (B, n_image_tokens, d_vision); projector + Mistral
  backbone are real.
* llava15-7b (paper repro): REAL CLIP ViT-L/14 vision tower (frozen per the
  paper's training stages) + 2-layer MLP projector + Vicuna-7B.

Sequence layout: [projected image tokens | text embeddings].  Spec
functions only; the forward passes arrive with the runnable model zoo.
"""

from __future__ import annotations

from repro_torch.configs import ArchConfig
from repro_torch.core.spec import ModuleSpec, AXIS_EMBED
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.vit import vit_spec


def projector_spec(cfg: ArchConfig) -> ModuleSpec:
    v = cfg.vlm
    layers = []
    d_in = v.d_vision
    for i in range(v.projector_layers):
        layers.append(L.linear_spec(f"fc{i}", d_in, cfg.d_model,
                                    axes=(None, AXIS_EMBED), bias=True))
        d_in = cfg.d_model
    return ModuleSpec(name="projector", modality="vision", layers=layers)


def vlm_model_spec(cfg: ArchConfig) -> ModuleSpec:
    children = []
    if cfg.vlm.vision_tower:
        children.append(vit_spec(cfg.vlm, cfg.dtype))
    children.append(projector_spec(cfg))
    children.append(T.lm_spec(cfg, name="language_model"))
    return ModuleSpec(name="vlm", modality="multimodal", children=children)
