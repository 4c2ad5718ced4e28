"""Attention layer specs: GQA (llama/qwen/mistral-style).

Spec function only: the parameter leaves and saved activations of a
grouped-query attention layer as the memory predictor reads them.  The
compute paths (flash attention kernel, decode attention) and the MLA
variant arrive with the runnable model zoo.
"""

from __future__ import annotations

from repro_torch.core.spec import (ActTerm, LayerSpec, ParamSpec,
                                   AXIS_EMBED, AXIS_HEADS, AXIS_KV_HEADS)


def gqa_spec(name: str, d_model: int, n_heads: int, n_kv_heads: int,
             head_dim: int, qk_norm: bool = False,
             dtype: str = "bfloat16") -> LayerSpec:
    params = {
        "wq": ParamSpec((d_model, n_heads * head_dim), dtype,
                        (AXIS_EMBED, AXIS_HEADS)),
        "wk": ParamSpec((d_model, n_kv_heads * head_dim), dtype,
                        (AXIS_EMBED, AXIS_KV_HEADS)),
        "wv": ParamSpec((d_model, n_kv_heads * head_dim), dtype,
                        (AXIS_EMBED, AXIS_KV_HEADS)),
        "wo": ParamSpec((n_heads * head_dim, d_model), dtype,
                        (AXIS_HEADS, AXIS_EMBED)),
    }
    if qk_norm:
        params["q_norm"] = ParamSpec((head_dim,), dtype, (None,), init="ones")
        params["k_norm"] = ParamSpec((head_dim,), dtype, (None,), init="ones")
    proj_flops = 2.0 * d_model * head_dim * (2 * n_heads + 2 * n_kv_heads)
    return LayerSpec(
        name=name, kind="attention", params=params,
        acts=[
            # 4-D head layouts mirror the runtime's reshape-then-shard order:
            # a head count that does not divide the mesh axis replicates in
            # BOTH the live code and the prediction (e.g. smollm's 15 heads).
            ActTerm(f"{name}.in", ("B", "S", d_model), dtype,
                    ("batch", "seq", AXIS_EMBED)),
            ActTerm(f"{name}.q", ("B", "S", n_heads, head_dim), dtype,
                    ("batch", "seq", AXIS_HEADS, None)),
            ActTerm(f"{name}.k", ("B", "S", n_kv_heads, head_dim), dtype,
                    ("batch", "seq", AXIS_KV_HEADS, None)),
            ActTerm(f"{name}.v", ("B", "S", n_kv_heads, head_dim), dtype,
                    ("batch", "seq", AXIS_KV_HEADS, None)),
            ActTerm(f"{name}.ctx", ("B", "S", n_heads, head_dim), dtype,
                    ("batch", "seq", AXIS_HEADS, None)),
            # flash softmax statistics (fp32 lse per head per position)
            ActTerm(f"{name}.lse", ("B", n_heads, "S"), "float32",
                    ("batch", "heads", "seq")),
        ],
        flops_per_token=proj_flops,
        meta={"n_heads": n_heads, "n_kv_heads": n_kv_heads,
              "head_dim": head_dim, "qk_norm": qk_norm, "d_model": d_model,
              "kv_bytes_per_token": 2 * n_kv_heads * head_dim,
              "attn_kind": "gqa"})
