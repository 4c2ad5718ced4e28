"""llava15-7b — the PAPER's evaluation model (LLaVA-1.5 7B):
CLIP ViT-L/14-336 vision tower (REAL params, frozen) + 2-layer MLP projector
+ Vicuna-7B (llama-arch) language model.  Used by benchmarks/fig2a, fig2b.
"""
from repro_torch.configs import ArchConfig, VLMConfig

CONFIG = ArchConfig(
    name="llava15-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=32000, head_dim=128,
    vlm=VLMConfig(d_vision=1024, n_image_tokens=576, projector_layers=2,
                  vision_tower=True, vit_layers=24, vit_heads=16,
                  vit_d_ff=4096, vit_patch=14, vit_image_size=336),
    notes="Paper-repro model: frozen CLIP ViT-L/14 + projector + Vicuna-7B.",
)
