"""Vision-language model specs.

* llava-next-mistral-7b: STUB anyres frontend — the input is precomputed
  patch embeddings (B, n_image_tokens, d_vision); projector + Mistral
  backbone are real.
* llava15-7b (paper repro): REAL CLIP ViT-L/14 vision tower (frozen per the
  paper's training stages) + 2-layer MLP projector + Vicuna-7B.

Sequence layout: [projected image tokens | text embeddings].  Specs, the
training loss (over the text positions) and the serving path (prefill over
the image and the prompt, then decode).
"""

from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.spec import ModuleSpec, AXIS_EMBED
from repro_torch.models import layers as L
from repro_torch.models.param import TORCH_DTYPES
from repro_torch.models import transformer as T
from repro_torch.models.vit import vit_forward, vit_spec


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


def project_image(cfg: ArchConfig, p, feats: torch.Tensor) -> torch.Tensor:
    """feats (B, n, d_vision) -> (B, n, d_model); ``p`` holds
    ``projector``."""
    x = feats
    for i in range(cfg.vlm.projector_layers):
        x = L.linear(p.projector[f"fc{i}"], x)
        if i < cfg.vlm.projector_layers - 1:
            x = L.gelu_tanh(x)
    return x


def vlm_embeds(cfg: ArchConfig, params, batch: dict) -> torch.Tensor:
    """batch: {'tokens': (B, S_text), 'patch_embeds' | 'patches'} ->
    embeds (B, S_total, D)."""
    p = params.vlm
    if cfg.vlm.vision_tower:
        feats = vit_forward(p, batch["patches"], cfg.vlm, cfg.norm_eps)
    else:
        feats = batch["patch_embeds"]
    img = project_image(cfg, p, feats).to(TORCH_DTYPES[cfg.dtype])
    txt = T.embed_tokens(cfg, p.language_model, batch["tokens"])
    return torch.cat([img, txt], dim=1)


def vlm_loss(cfg: ArchConfig, params, batch: dict, remat=None):
    """batch: {'tokens', 'labels': (B, S_text), 'patch_embeds' | 'patches'}
    -> (loss, {"xent", "n_tok"}).  The image positions are labelled -100,
    so the loss is over the text.  A frozen tower (leaves that do not
    require grad, inputs that do not either) records no graph."""
    embeds = vlm_embeds(cfg, params, batch)
    B, S_total, _ = embeds.shape
    n_img = S_total - batch["tokens"].shape[1]
    lm = params.vlm.language_model
    hidden, _ = T.lm_backbone(cfg, lm, embeds, remat=remat)
    labels = torch.cat([torch.full((B, n_img), -100, dtype=torch.int32,
                                   device=embeds.device),
                        batch["labels"].to(torch.int32)], dim=1)
    return T.xent_loss(cfg, lm, hidden, labels)


def vlm_prefill(cfg: ArchConfig, params, batch: dict):
    """Prefill over [image tokens | text]; returns logits + cache."""
    return T.prefill_embeds(cfg, params.vlm.language_model,
                            vlm_embeds(cfg, params, batch))


def vlm_decode_step(cfg: ArchConfig, params, token: torch.Tensor,
                    cache: dict):
    return T.decode_lm(cfg, params.vlm.language_model, token, cache)
