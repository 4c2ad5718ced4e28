"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512 [arXiv:2405.04434; hf]."""
from repro_torch.configs import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944,  # dense first-layer FFN width
    vocab=102400,
    mla=MLAConfig(q_lora_rank=0, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2,
                  d_expert=1408, n_dense_layers=1),
    notes="MLA (no q compression in lite); 64 routed experts top-6 + 2 shared; "
          "first layer dense FFN 10944.",
)
