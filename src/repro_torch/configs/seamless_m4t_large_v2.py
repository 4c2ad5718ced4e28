"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal [arXiv:2308.11596; hf].

Backbone-only per assignment: the speech frontend is a STUB — input_specs()
provides precomputed frame embeddings (B, enc_seq, d_frontend). 24L encoder
+ 24L decoder with cross-attention; text vocab 256206.
"""
from repro_torch.configs import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, head_dim=64,
    encdec=EncDecConfig(n_enc_layers=24, d_frontend=1024, enc_seq_ratio=1.0),
    notes="Encoder-decoder; decode_32k decodes with 32k-decoder KV cache + "
          "cross-attention over 32k encoder memory.",
)
