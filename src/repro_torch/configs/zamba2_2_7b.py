"""zamba2-2.7b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242; hf]."""
from repro_torch.configs import ArchConfig, HybridConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, head_dim=80,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=256),
    hybrid=HybridConfig(attn_every=6, shared_attn_blocks=2),
    tie_embeddings=True,
    subquadratic=True,
    notes="54 Mamba-2 blocks; 2 shared (weight-tied) full-attention blocks "
          "applied every 6 layers, alternating. KV cache exists only for the "
          "shared blocks' 9 invocations.",
)
