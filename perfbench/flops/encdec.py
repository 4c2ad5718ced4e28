"""Work of a training step of the encoder-decoder family.

Forward: the frame projection, the encoder's blocks (bidirectional
attention), the decoder's blocks (causal self-attention; cross-attention
whose keys and values are products over the encoder's positions), the LM
head over every decoder position.  Backward: weight and input gradients
of every trainable product, except the frame projection's input gradient
(the frames are inputs); attention's backward is the four products dV,
dP, dQ, dK (no recompute of the scores)."""

from __future__ import annotations

from perfbench.harness.inputs import shape_of
from perfbench.harness.work import scores
from perfbench.harness.weights import DTYPES


def work(cfg: dict, traffic: dict) -> dict:
    if cfg["training"]["trainable"] != ["encdec"]:
        raise ValueError("the encoder-decoder's work is counted for full "
                         "training only")
    shapes = {s["name"]: shape_of(s, cfg) for s in traffic["inputs"]}
    B, T, df = shapes["frames"]
    S = shapes["tokens"][1]
    d, hd, V = cfg["hidden_size"], cfg["head_dim"], cfg["vocab_size"]
    He, Hd = cfg["encoder_attention_heads"], cfg["decoder_attention_heads"]
    Le, Ld = cfg["encoder_layers"], cfg["decoder_layers"]
    ffe, ffd = cfg["encoder_ffn_dim"], cfg["decoder_ffn_dim"]
    front = 2.0 * B * T * df * d
    enc = Le * 2.0 * B * T * (4 * d * He * hd + 3 * d * ffe)
    dec = Ld * 2.0 * (B * S * (4 * d * Hd * hd + 2 * d * Hd * hd
                               + 3 * d * ffd) + B * T * 2 * d * Hd * hd)
    head = 2.0 * B * S * d * V
    calls = [{"B": B, "Sq": T, "Skv": T, "H": He, "Hkv": He, "D": hd,
              "Dv": hd, "causal": False, "calls": Le},
             {"B": B, "Sq": S, "Skv": S, "H": Hd, "Hkv": Hd, "D": hd,
              "Dv": hd, "causal": True, "calls": Ld},
             {"B": B, "Sq": S, "Skv": T, "H": Hd, "Hkv": Hd, "D": hd,
              "Dv": hd, "causal": False, "calls": Ld}]
    attn = sum(c["calls"] * 2.0 * scores(c) * (c["D"] + c["Dv"])
               for c in calls)
    linear = front + enc + dec + head
    fwd = linear + attn
    bwd = 2 * linear - front + 2 * attn
    return {
        "model_flops": fwd + bwd,
        "positions": B * (T + S),
        "elt_bytes": DTYPES[cfg["torch_dtype"]].itemsize,
        "attention": calls,
        "rmsnorm": [{"rows": B * T, "D": d, "calls": 2 * Le + 1},
                    {"rows": B * S, "D": d, "calls": 3 * Ld + 1}],
    }

