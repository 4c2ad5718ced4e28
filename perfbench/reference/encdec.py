"""Plain reference of the encoder-decoder family: frame embeddings (the
stub speech frontend's output) through a linear projection and a stack of
bidirectional pre-norm blocks (RMSNorm, attention with split-half RoPE,
SwiGLU MLP) and a final norm; a decoder of causal blocks that add
cross-attention over that memory (queries from the decoder, keys and
values from the memory, no rotation); the loss is the next-token
cross-entropy over the decoder's positions."""

from __future__ import annotations

import math

from perfbench.reference import common as C

ENC = "encdec.speech_encoder"
DEC = "encdec.text_decoder"


def _dims(cfg: dict) -> tuple:
    return (cfg["hidden_size"], cfg["head_dim"],
            cfg["decoder_attention_heads"], cfg["decoder_ffn_dim"])


def weight_specs(cfg: dict) -> list:
    d, hd, H, ff = _dims(cfg)
    He, ffe = cfg["encoder_attention_heads"], cfg["encoder_ffn_dim"]
    V, df = cfg["vocab_size"], cfg["frame_embedding_dim"]
    fan = lambda n: ("normal", 1.0 / math.sqrt(n))
    attn = lambda p, h: [(f"{p}.wq", (d, h * hd), fan(d)),
                         (f"{p}.wk", (d, h * hd), fan(d)),
                         (f"{p}.wv", (d, h * hd), fan(d)),
                         (f"{p}.wo", (h * hd, d), fan(h * hd))]
    mlp = lambda p, f: [(f"{p}.wg", (d, f), fan(d)),
                        (f"{p}.wu", (d, f), fan(d)),
                        (f"{p}.wd", (f, d), fan(f))]
    out = [(f"{ENC}.frontend_proj.proj.w", (df, d), fan(df))]
    for i in range(cfg["encoder_layers"]):
        b = f"{ENC}.encoder_blocks.{i}"
        out += [(f"{b}.norm1.scale", (d,), ("ones",)), *attn(f"{b}.attn", He),
                (f"{b}.norm2.scale", (d,), ("ones",)), *mlp(f"{b}.ffn", ffe)]
    out.append((f"{ENC}.encoder_head.enc_norm.scale", (d,), ("ones",)))
    out.append((f"{DEC}.embed.tok.w", (V, d), ("normal", 0.02)))
    for i in range(cfg["decoder_layers"]):
        b = f"{DEC}.decoder_blocks.{i}"
        out += [(f"{b}.norm1.scale", (d,), ("ones",)), *attn(f"{b}.attn", H),
                (f"{b}.norm_x.scale", (d,), ("ones",)),
                *attn(f"{b}.cross_attn", H),
                (f"{b}.norm2.scale", (d,), ("ones",)), *mlp(f"{b}.ffn", ff)]
    out += [(f"{DEC}.head.final_norm.scale", (d,), ("ones",)),
            (f"{DEC}.head.lm_head.w", (d, V), fan(d))]
    return out


def loss_rows(cfg: dict, W: dict, batch: dict, rnd=C.identity):
    """batch: frames (b, T, d_frame), tokens and labels (b, S) -> (loss
    summed over the labelled decoder positions, their count)."""
    d, hd, H, _ = _dims(cfg)
    He = cfg["encoder_attention_heads"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    mlp = lambda x, p: C.swiglu(x, W[f"{p}.wg"], W[f"{p}.wu"], W[f"{p}.wd"],
                                rnd)
    x = C.linear(batch["frames"].to(C.F32),
                 W[f"{ENC}.frontend_proj.proj.w"], rnd)
    for i in range(cfg["encoder_layers"]):
        b = f"{ENC}.encoder_blocks.{i}"
        h = C.rmsnorm(x, W[f"{b}.norm1.scale"], eps)
        x = x + C.gqa(h, W, f"{b}.attn", He, He, hd, theta, False, rnd)
        x = x + mlp(C.rmsnorm(x, W[f"{b}.norm2.scale"], eps), f"{b}.ffn")
    memory = C.rmsnorm(x, W[f"{ENC}.encoder_head.enc_norm.scale"], eps)
    x = C.embed(batch["tokens"], W[f"{DEC}.embed.tok.w"])
    for i in range(cfg["decoder_layers"]):
        b = f"{DEC}.decoder_blocks.{i}"
        h = C.rmsnorm(x, W[f"{b}.norm1.scale"], eps)
        x = x + C.gqa(h, W, f"{b}.attn", H, H, hd, theta, True, rnd)
        h = C.rmsnorm(x, W[f"{b}.norm_x.scale"], eps)
        x = x + C.gqa(h, W, f"{b}.cross_attn", H, H, hd, theta, False, rnd,
                      memory=memory)
        x = x + mlp(C.rmsnorm(x, W[f"{b}.norm2.scale"], eps), f"{b}.ffn")
    h = C.rmsnorm(x, W[f"{DEC}.head.final_norm.scale"], eps)
    return C.xent_sum(h.reshape(-1, d), W[f"{DEC}.head.lm_head.w"],
                      batch["labels"].reshape(-1), rnd)
