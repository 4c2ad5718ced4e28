"""The program's encoder-decoder (``repro_torch.models.encdec``) as the
configuration file states it.  The program's blocks have one head count
and one feed-forward width for both stacks."""

from __future__ import annotations

import dataclasses


def arch_config(cfg: dict):
    from repro_torch.configs import get_config
    if cfg["encoder_attention_heads"] != cfg["decoder_attention_heads"] or \
            cfg["encoder_ffn_dim"] != cfg["decoder_ffn_dim"]:
        raise ValueError("the program's encoder and decoder share one head "
                         "count and one feed-forward width")
    base = get_config(cfg["program_arch"])
    heads = cfg["decoder_attention_heads"]
    return dataclasses.replace(
        base, n_layers=cfg["decoder_layers"], d_model=cfg["hidden_size"],
        n_heads=heads, n_kv_heads=heads, d_ff=cfg["decoder_ffn_dim"],
        vocab=cfg["vocab_size"], head_dim=cfg["head_dim"],
        norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
        tie_embeddings=cfg["tie_word_embeddings"], dtype=cfg["torch_dtype"],
        remat=cfg["training"]["remat"],
        encdec=dataclasses.replace(
            base.encdec, n_enc_layers=cfg["encoder_layers"],
            d_frontend=cfg["frame_embedding_dim"], enc_seq_ratio=1.0))
