"""llama3.2-3b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B; unverified]."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=128256, head_dim=128,
    rope_theta=500000.0, tie_embeddings=True,
    notes="GQA kv=8; SwiGLU; RoPE theta 500k.",
)
