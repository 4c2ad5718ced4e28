"""The program's vision-language model (``repro_torch.models.vlm``) as the
configuration file states it."""

from __future__ import annotations

import dataclasses


def arch_config(cfg: dict):
    from repro_torch.configs import get_config
    base = get_config(cfg["program_arch"])
    return dataclasses.replace(
        base, n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        head_dim=cfg["head_dim"], norm_eps=cfg["rms_norm_eps"],
        rope_theta=cfg["rope_theta"],
        tie_embeddings=cfg["tie_word_embeddings"], dtype=cfg["torch_dtype"],
        remat=cfg["training"]["remat"],
        vlm=dataclasses.replace(
            base.vlm, d_vision=cfg["vision_config"]["hidden_size"],
            n_image_tokens=cfg["image_seq_length"],
            projector_layers=cfg["projector_layers"], vision_tower=False))
