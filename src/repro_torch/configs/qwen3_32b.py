"""qwen3-32b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
    d_ff=25600, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1000000.0,
    fsdp=True,  # 32B: params must shard over data too to fit 16GB v5e chips
    notes="qk-norm on per-head q/k; GQA kv=8; FSDP over data axis.",
)
