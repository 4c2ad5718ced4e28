"""minicpm3-4b [dense/MLA] — MLA [hf:openbmb/MiniCPM3-4B; hf]."""
from repro_torch.configs import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73448,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    tie_embeddings=True,
    notes="Multi-head latent attention: q_lora 768, kv_lora 256; "
          "decode caches the 256-d latent + 32-d rope key only.",
)
