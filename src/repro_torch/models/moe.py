"""Mixture-of-Experts FFN: the spec half.

For the memory model the spec carries the expert-parallel metadata: the
routed weight stacks' leading ``E`` dim is the ``experts`` logical axis
(rule: ``mesh_ctx.EXPERT_AXIS`` first, then TP on what stays divisible)
and the dispatch/capacity buffers carry the EP-only ``expert_buf`` axis —
so a mesh with an ``expert`` axis divides exactly the MoE weights and
dispatch buffers, never a dense layer's tensors.

The forward — routing (``_route``: softmax, top-k, capacity with drop),
``moe_forward``, the dense single-device ``_dense_moe`` and the
expert-parallel all-to-all path — is not ported yet: it comes with the
runnable MoE family (ROADMAP A7c); until then the model's forward entry
points raise (``models.registry``).
"""

from __future__ import annotations

from repro_torch.core.spec import (ActTerm, LayerSpec, ParamSpec,
                                   AXIS_EMBED, AXIS_EXPERTS, AXIS_EXPERT_BUF,
                                   AXIS_FFN)


def moe_spec(name: str, d_model: int, moe, dtype: str = "bfloat16") -> LayerSpec:
    E, F = moe.n_experts, moe.d_expert
    params = {
        "router": ParamSpec((d_model, E), "float32", (AXIS_EMBED, None)),
        "wg": ParamSpec((E, d_model, F), dtype, (AXIS_EXPERTS, AXIS_EMBED, None)),
        "wu": ParamSpec((E, d_model, F), dtype, (AXIS_EXPERTS, AXIS_EMBED, None)),
        "wd": ParamSpec((E, F, d_model), dtype, (AXIS_EXPERTS, None, AXIS_EMBED)),
    }
    if moe.n_shared_experts:
        Fs = F * moe.n_shared_experts
        params.update({
            "shared_wg": ParamSpec((d_model, Fs), dtype, (AXIS_EMBED, AXIS_FFN)),
            "shared_wu": ParamSpec((d_model, Fs), dtype, (AXIS_EMBED, AXIS_FFN)),
            "shared_wd": ParamSpec((Fs, d_model), dtype, (AXIS_FFN, AXIS_EMBED)),
        })
    # active-expert FLOPs per token (top_k routed + shared)
    flops = 2.0 * d_model * E \
        + 2.0 * 3 * d_model * F * (moe.top_k + moe.n_shared_experts)
    cap = moe.capacity_factor
    return LayerSpec(
        name=name, kind="moe", params=params,
        acts=[
            ActTerm(f"{name}.in", ("B", "S", d_model), dtype,
                    ("batch", "seq", AXIS_EMBED)),
            ActTerm(f"{name}.router", ("B", "S", E), "float32",
                    ("batch", "seq", None)),
            # dispatched expert buffers (top_k * capacity_factor copies);
            # the capacity dim carries the EP-only `expert_buf` axis: each
            # expert shard holds its own experts' fixed-capacity blocks.
            # int() truncates the float product, as the runtime sizes them
            ActTerm(f"{name}.dispatch",
                    ("B", "S", int(d_model * moe.top_k * cap)), dtype,
                    ("batch", "seq", AXIS_EXPERT_BUF)),
            ActTerm(f"{name}.h",
                    ("B", "S", int(3 * F * moe.top_k * cap)), dtype,
                    ("batch", "seq", AXIS_EXPERT_BUF)),
        ] + ([ActTerm(f"{name}.shared_h",
                      ("B", "S", 3 * F * moe.n_shared_experts), dtype,
                      ("batch", "seq", AXIS_FFN))]
             if moe.n_shared_experts else []),
        flops_per_token=flops,
        meta={"n_experts": E, "top_k": moe.top_k, "d_expert": F,
              "d_model": d_model, "capacity_factor": cap,
              "n_shared_experts": moe.n_shared_experts})

