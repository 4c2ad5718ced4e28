"""Plain reference of the vision-language family: the two-layer projector
(GELU, tanh form) over the patch embeddings that stand in for the vision
tower, then a decoder LM of pre-norm blocks (RMSNorm, grouped-query
attention with split-half RoPE, SwiGLU MLP) over [image | text]; the loss
is the next-token cross-entropy over the text positions."""

from __future__ import annotations

import math

import torch

from perfbench.reference import common as C


def _lm(cfg: dict) -> tuple:
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    hd = cfg["head_dim"]
    return d, L, hd, cfg["num_attention_heads"], cfg["num_key_value_heads"]


def weight_specs(cfg: dict) -> list:
    """(name, shape, init) of every weight, in the order they are drawn:
    init is ("normal", scale), ("ones",) or ("zeros",)."""
    d, L, hd, H, Hkv = _lm(cfg)
    dv, ff, V = cfg["vision_config"]["hidden_size"], \
        cfg["intermediate_size"], cfg["vocab_size"]
    fan = lambda n: ("normal", 1.0 / math.sqrt(n))
    out = []
    d_in = dv
    for i in range(cfg["projector_layers"]):
        out += [(f"vlm.projector.fc{i}.w", (d_in, d), fan(d_in)),
                (f"vlm.projector.fc{i}.b", (d,), ("zeros",))]
        d_in = d
    lm = "vlm.language_model"
    out.append((f"{lm}.embed.tok.w", (V, d), ("normal", 0.02)))
    for i in range(L):
        b = f"{lm}.blocks.{i}"
        out += [(f"{b}.norm1.scale", (d,), ("ones",)),
                (f"{b}.attn.wq", (d, H * hd), fan(d)),
                (f"{b}.attn.wk", (d, Hkv * hd), fan(d)),
                (f"{b}.attn.wv", (d, Hkv * hd), fan(d)),
                (f"{b}.attn.wo", (H * hd, d), fan(H * hd)),
                (f"{b}.norm2.scale", (d,), ("ones",)),
                (f"{b}.ffn.wg", (d, ff), fan(d)),
                (f"{b}.ffn.wu", (d, ff), fan(d)),
                (f"{b}.ffn.wd", (ff, d), fan(ff))]
    out += [(f"{lm}.head.final_norm.scale", (d,), ("ones",)),
            (f"{lm}.head.lm_head.w", (d, V), fan(d))]
    return out


def loss_rows(cfg: dict, W: dict, batch: dict, rnd=C.identity):
    """batch: patch_embeds (b, n_img, d_vision), tokens and labels
    (b, S_text) -> (loss summed over the text positions, their count)."""
    d, L, hd, H, Hkv = _lm(cfg)
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    x = batch["patch_embeds"].to(C.F32)
    n = cfg["projector_layers"]
    for i in range(n):
        x = C.linear(x, W[f"vlm.projector.fc{i}.w"], rnd) \
            + W[f"vlm.projector.fc{i}.b"].to(C.F32)
        if i < n - 1:
            x = C.gelu_tanh(x)
    n_img = x.shape[1]
    lm = "vlm.language_model"
    x = torch.cat([x, C.embed(batch["tokens"], W[f"{lm}.embed.tok.w"])],
                    dim=1)
    for i in range(L):
        b = f"{lm}.blocks.{i}"
        h = C.rmsnorm(x, W[f"{b}.norm1.scale"], eps)
        x = x + C.gqa(h, W, f"{b}.attn", H, Hkv, hd, theta, True, rnd)
        h = C.rmsnorm(x, W[f"{b}.norm2.scale"], eps)
        x = x + C.swiglu(h, W[f"{b}.ffn.wg"], W[f"{b}.ffn.wu"],
                         W[f"{b}.ffn.wd"], rnd)
    h = C.rmsnorm(x[:, n_img:], W[f"{lm}.head.final_norm.scale"], eps)
    return C.xent_sum(h.reshape(-1, d), W[f"{lm}.head.lm_head.w"],
                      batch["labels"].reshape(-1), rnd)
