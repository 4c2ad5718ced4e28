"""Fine-grained layers: spec functions.

Every function here returns a :class:`LayerSpec` whose ``params`` dict names the
parameter leaves of the layer and whose ``acts``/``flops`` metadata feed the
memory predictor.  The functional applies (forward passes) arrive with the
runnable model zoo.
"""

from __future__ import annotations

from repro_torch.core.spec import (ActTerm, LayerSpec, ParamSpec,
                                   AXIS_EMBED, AXIS_FFN, AXIS_VOCAB)

# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------


def linear_spec(name: str, d_in: int, d_out: int,
                axes=(AXIS_EMBED, AXIS_FFN), dtype: str = "bfloat16",
                bias: bool = False, out_act_axes=("batch", None, AXIS_FFN),
                init_scale: float = 1.0) -> LayerSpec:
    params = {"w": ParamSpec((d_in, d_out), dtype, axes, init_scale=init_scale)}
    if bias:
        params["b"] = ParamSpec((d_out,), dtype, (axes[1],), init="zeros")
    return LayerSpec(
        name=name, kind="linear", params=params,
        acts=[ActTerm(f"{name}.in", ("B", "S", d_in), dtype,
                      ("batch", "seq", axes[0]))],
        flops_per_token=2.0 * d_in * d_out,
        meta={"d_in": d_in, "d_out": d_out})


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def embedding_spec(name: str, vocab: int, d_model: int,
                   dtype: str = "bfloat16", tied: bool = False) -> LayerSpec:
    """Untied tables shard columns (embed_cols -> model): the lookup then
    never gathers the table.  Tied tables must stay vocab-sharded for the
    vocab-parallel loss; the lookup's table all-gather is modelled by the
    predictor (meta['lookup_gather'])."""
    axes = (AXIS_VOCAB, AXIS_EMBED) if tied else (None, "embed_cols")
    return LayerSpec(
        name=name, kind="embedding",
        params={"w": ParamSpec((vocab, d_model), dtype, axes, init="embed")},
        acts=[ActTerm(f"{name}.ids", ("B", "S"), "int32", ("batch", "seq"))],
        flops_per_token=0.0,
        meta={"vocab": vocab, "d_model": d_model, "lookup_gather": tied})


def lm_head_spec(name: str, d_model: int, vocab: int,
                 dtype: str = "bfloat16") -> LayerSpec:
    return LayerSpec(
        name=name, kind="linear",
        params={"w": ParamSpec((d_model, vocab), dtype,
                               (AXIS_EMBED, AXIS_VOCAB))},
        acts=[ActTerm(f"{name}.in", ("B", "S", d_model), dtype,
                      ("batch", "seq", AXIS_EMBED))],
        flops_per_token=2.0 * d_model * vocab,
        meta={"d_in": d_model, "d_out": vocab})


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(name: str, d: int, dtype: str = "bfloat16") -> LayerSpec:
    return LayerSpec(
        name=name, kind="rmsnorm",
        params={"scale": ParamSpec((d,), dtype, (None,), init="ones")},
        acts=[ActTerm(f"{name}.in", ("B", "S", d), dtype,
                      ("batch", "seq", AXIS_EMBED))],
        flops_per_token=5.0 * d,
        meta={"d": d})


def layernorm_spec(name: str, d: int, dtype: str = "bfloat16") -> LayerSpec:
    return LayerSpec(
        name=name, kind="layernorm",
        params={"scale": ParamSpec((d,), dtype, (None,), init="ones"),
                "bias": ParamSpec((d,), dtype, (None,), init="zeros")},
        acts=[ActTerm(f"{name}.in", ("B", "S", d), dtype,
                      ("batch", "seq", AXIS_EMBED))],
        flops_per_token=8.0 * d,
        meta={"d": d})


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_spec(name: str, d_model: int, d_ff: int,
             dtype: str = "bfloat16", gated: bool = True) -> LayerSpec:
    if gated:
        params = {
            "wg": ParamSpec((d_model, d_ff), dtype, (AXIS_EMBED, AXIS_FFN)),
            "wu": ParamSpec((d_model, d_ff), dtype, (AXIS_EMBED, AXIS_FFN)),
            "wd": ParamSpec((d_ff, d_model), dtype, (AXIS_FFN, AXIS_EMBED)),
        }
        flops = 2.0 * d_model * d_ff * 3
        n_ff_acts = 3
    else:
        params = {
            "wu": ParamSpec((d_model, d_ff), dtype, (AXIS_EMBED, AXIS_FFN)),
            "wd": ParamSpec((d_ff, d_model), dtype, (AXIS_FFN, AXIS_EMBED)),
        }
        flops = 2.0 * d_model * d_ff * 2
        n_ff_acts = 2
    return LayerSpec(
        name=name, kind="mlp", params=params,
        acts=[ActTerm(f"{name}.in", ("B", "S", d_model), dtype,
                      ("batch", "seq", AXIS_EMBED))]
             + [ActTerm(f"{name}.h{i}", ("B", "S", d_ff), dtype,
                        ("batch", "seq", AXIS_FFN)) for i in range(n_ff_acts)],
        flops_per_token=flops,
        meta={"d_model": d_model, "d_ff": d_ff, "gated": gated})
