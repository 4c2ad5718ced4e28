"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf]."""
from repro_torch.configs import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864,  # dense-residual FFN width
    vocab=32000, head_dim=128,
    moe=MoEConfig(n_experts=128, top_k=2, d_expert=4864,
                  dense_residual=True),
    optimizer="adafactor",  # Adam fp32 states (5.8 TB) cannot fit a v5e pod
    fsdp=True,              # params/grads/opt sharded over BOTH mesh axes
    remat="block",
    notes="Dense FFN residual in parallel with 128-expert top-2 MoE. "
          "Memory plan (core/planner.py): Adafactor + 2-axis FSDP required; "
          "see EXPERIMENTS.md.",
)
