"""llava-next-mistral-7b [vlm] — anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Backbone-only per assignment: the anyres vision frontend is a STUB —
input_specs() provides precomputed patch embeddings (B, n_image_tokens,
d_vision); the projector and Mistral-7B backbone are real.
"""
from repro_torch.configs import ArchConfig, VLMConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, head_dim=128,
    rope_theta=1000000.0,
    vlm=VLMConfig(d_vision=1024, n_image_tokens=576,
                  projector_layers=2, vision_tower=False),
    notes="Mistral-7B backbone (GQA kv=8, SwiGLU); stub anyres frontend.",
)
