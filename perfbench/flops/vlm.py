"""Work of a training step of the vision-language family.

Forward: the projector over the image positions, every LM block's
products over all positions, causal attention over [image | text], the
LM head over the text positions only (the loss reads no other logits).
Backward: input gradients of every LM product and of the head (the
gradient reaches the projector through the image positions; counted over
all positions of every block, which overstates the bottom block's need by
its text positions), weight gradients of the trainable layers, and the
projector's input gradients above its first layer.  Attention's backward
is the four products dV, dP, dQ, dK (no recompute of the scores)."""

from __future__ import annotations

from perfbench.harness.inputs import shape_of
from perfbench.harness.work import scores
from perfbench.harness.weights import DTYPES


def _trains(cfg: dict, name: str) -> bool:
    return any(p in name for p in cfg["training"]["trainable"])


def work(cfg: dict, traffic: dict) -> dict:
    shapes = {s["name"]: shape_of(s, cfg) for s in traffic["inputs"]}
    B, n_img, dv = shapes["patch_embeds"]
    s_txt = shapes["tokens"][1]
    S = n_img + s_txt
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, Hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    ff, V, P = cfg["intermediate_size"], cfg["vocab_size"], \
        cfg["projector_layers"]
    t_img, t_txt = B * n_img, B * s_txt
    lin = 2.0 * (d * H * hd + 2 * d * Hkv * hd + H * hd * d + 3 * d * ff)
    call = {"B": B, "Sq": S, "Skv": S, "H": H, "Hkv": Hkv, "D": hd,
            "Dv": hd, "causal": True, "calls": L}
    attn_fwd = 2.0 * scores(call) * (hd + hd)
    attn_bwd = 2.0 * scores(call) * (2 * hd + 2 * hd)
    proj = [2.0 * t_img * (dv if i == 0 else d) * d for i in range(P)]
    head = 2.0 * t_txt * d * V
    lm_fwd = L * (B * S * lin + attn_fwd)
    fwd = sum(proj) + lm_fwd + head
    lm_trains = _trains(cfg, "vlm.language_model.blocks.0.attn.wq")
    bwd = L * (B * S * lin + attn_bwd) + head
    if lm_trains:
        bwd += L * B * S * lin + head
    if _trains(cfg, "vlm.projector.fc0.w"):
        bwd += sum(proj) + sum(proj[1:])
    return {
        "model_flops": fwd + bwd,
        "positions": B * S,
        "elt_bytes": DTYPES[cfg["torch_dtype"]].itemsize,
        "attention": [call],
        "rmsnorm": [{"rows": B * S, "D": d, "calls": 2 * L + 1}],
    }
