"""llama3.1-8b [dense] — llama3.1 8B [hf:meta-llama/Llama-3.1-8B;
unverified].  Registered as a capacity-planning target (not part of the
assigned dry-run cell set in ARCH_NAMES)."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llama3.1-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, head_dim=128,
    rope_theta=500000.0,
    notes="GQA kv=8; SwiGLU; RoPE theta 500k; untied embeddings.",
)
