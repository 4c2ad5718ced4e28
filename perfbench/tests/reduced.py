"""The benchmark's cells cut to a size the CPU runs in a second: every
width and depth of the configuration shrunk, the traffic's batch and
lengths with it; the kinds of layer, the policy and the optimizer kept."""

from __future__ import annotations

import copy

from perfbench.harness import cell as CELL

SHRINK = {
    "llava_next_mistral_7b_stage1": dict(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        vocab_size=256, image_seq_length=16,
        vision_config={"hidden_size": 32}),
    "seamless_m4t_large_v2_full": dict(
        hidden_size=64, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, head_dim=16,
        encoder_ffn_dim=128, decoder_ffn_dim=128, vocab_size=256,
        frame_embedding_dim=32),
}
# per cell and input: (rows, positions) at the reduced size
SHAPES = {"vlm_stage1_8x2k": {"patch_embeds": (2, 16), "tokens": (2, 48)},
          "speech_full_4x2k": {"frames": (2, 40), "tokens": (2, 32)}}
CELLS = tuple(SHAPES)


def cell(name: str, dtype: str = "bfloat16") -> CELL.Cell:
    c = CELL.load(name)
    conf = next(w["config"] for w in CELL.load_benchmark()["workloads"]
                if w["name"] == name)
    c.config = dict(copy.deepcopy(c.config), **SHRINK[conf],
                    torch_dtype=dtype)
    c.traffic = copy.deepcopy(c.traffic)
    for spec in c.traffic["inputs"]:
        rows, length = SHAPES[name][spec["name"]]
        spec["shape"] = [rows, length] + spec["shape"][2:]
        spec["positions"] = [rows, length]
    return c
