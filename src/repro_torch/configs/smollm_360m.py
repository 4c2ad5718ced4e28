"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, head_dim=64,
    tie_embeddings=True,
    notes="GQA kv=5; 15 heads (not 16) — TP policy replicates attention "
          "projections over the model axis (960/16 OK for FFN, heads 15%16!=0).",
)
