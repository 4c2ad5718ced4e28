"""Mixture-of-Experts FFN: the spec and the forward.

For the memory model the spec carries the expert-parallel metadata: the
routed weight stacks' leading ``E`` dim is the ``experts`` logical axis
(rule: ``mesh_ctx.EXPERT_AXIS`` first, then TP on what stays divisible)
and the dispatch/capacity buffers carry the EP-only ``expert_buf`` axis —
so a mesh with an ``expert`` axis divides exactly the MoE weights and
dispatch buffers, never a dense layer's tensors.

The forward follows the reference's ``repro/models/moe.py``.
``moe_forward`` picks its path as the reference does, by whether a mesh
is active (``mesh_ctx.mesh_context``):

* with a mesh, the expert-parallel dispatch ``_ep_local``: per
  data-parallel shard, route (softmax -> top-k -> renormalize), give each
  (token, expert) pair a slot in its expert's fixed-capacity buffer in
  token order, drop the pairs past the capacity, run each expert's SwiGLU
  on its buffer (batched products), and combine.  On one device
  ``ep_size`` is 1; the all-to-all of ``ep_size > 1`` needs
  ``torch.distributed`` and raises (ROADMAP A8);
* with none, ``_dense_moe``: every expert on every token, weighted by the
  routed probabilities (no capacity, no drop).

The reference evaluates the router twice on its expert-parallel path
(inside ``_ep_local`` and again for the aux loss); the port evaluates it
once (``_ep_local`` returns its routing) and takes the aux loss from it:
the same values, one (T, E) fp32 tensor fewer.  A dropped pair reads
zeros: where the reference scatters with ``mode="drop"`` at the sentinel
slot ``C`` and gathers with ``mode="fill"``, the port scatters only the
kept pairs (their (expert, slot) indices are unique, so the write is a
plain ``index_put``) and gathers from the expert outputs padded with one
zero slot.  ``torch.topk`` leaves the order of ties unspecified where
``lax.top_k`` puts the lower index first, so ``_route`` takes the top k
of a stable descending sort.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.spec import (ActTerm, LayerSpec, ParamSpec,
                                   AXIS_EMBED, AXIS_EXPERTS, AXIS_EXPERT_BUF,
                                   AXIS_FFN)
from repro_torch.mesh_ctx import current_mesh_shape, mesh_axis_sizes
from repro_torch.models.layers import silu


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



# ---------------------------------------------------------------------------
# routing helpers
# ---------------------------------------------------------------------------


def _route(logits: torch.Tensor, top_k: int):
    """softmax -> top-k -> renormalize.  logits: (T, E) -> (top_p (T, k)
    fp32, top_i (T, k) int64, probs (T, E) fp32); among equal
    probabilities the lower expert index comes first (``lax.top_k``)."""
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :top_k], top_i[:, :top_k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_p, top_i, probs


def load_balance_loss(probs: torch.Tensor, top_i: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e (f_e: the share of routed
    slots per token that chose expert e)."""
    T, k = top_i.shape
    counts = torch.zeros((T, n_experts), dtype=torch.float32,
                         device=top_i.device)
    counts.scatter_add_(1, top_i, torch.ones(top_i.shape, dtype=torch.float32,
                                             device=top_i.device))
    f = counts.mean(0)
    return n_experts * torch.sum(f * probs.mean(0) / max(k, 1))


def _expert_ffn(wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                xb: torch.Tensor) -> torch.Tensor:
    """xb: (E_loc, C_tot, D); weights (E_loc, D, F) / (E_loc, F, D): each
    expert's SwiGLU on its buffer, as batched products."""
    return torch.bmm(silu(torch.bmm(xb, wg)) * torch.bmm(xb, wu), wd)


def _capacity(t_loc: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(t_loc * top_k * cf / n_experts)
    return max(8, -(-c // 8) * 8)


def _slots(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each (token, expert) pair's slot in its expert's buffer: the number
    of earlier pairs (in token-major order) routed to the same expert."""
    onehot = F.one_hot(flat_e, n_experts)                  # (T*k, E)
    pos = torch.cumsum(onehot, dim=0) - onehot             # slots before me
    return (pos * onehot).sum(-1)


# ---------------------------------------------------------------------------
# expert-parallel path (the active mesh's data shards, one device)
# ---------------------------------------------------------------------------


def _ep_local(x, router_w, wg, wu, wd, *, top_k: int, n_experts: int,
              cf: float, ep_size: int):
    """One data shard's tokens x (B_loc, S_loc, D) through the local
    experts wg / wu / wd (E_loc, ...) with a fixed capacity per expert ->
    (y (B_loc, S_loc, D), top_i (T, k), probs (T, E)).  The reference's
    returns y alone and evaluates the router again for the aux loss; the
    port hands its routing back instead.  ``ep_size > 1`` raises (ROADMAP
    A8)."""
    if ep_size > 1:
        raise NotImplementedError(
            f"the MoE all-to-all over an expert-parallel axis of size "
            f"{ep_size} needs torch.distributed; it comes with the runtime "
            f"shell (ROADMAP A8)")
    B_loc, S_loc, D = x.shape
    x = x.reshape(B_loc * S_loc, D)
    T, E = B_loc * S_loc, n_experts
    C = _capacity(T, top_k, E, cf)
    top_p, top_i, probs = _route(x.float() @ router_w, top_k)
    flat_e = top_i.reshape(-1)                             # (T*k,)
    slot = _slots(flat_e, E)
    keep = slot < C                                        # the rest drop
    token = torch.arange(T * top_k, device=x.device) // top_k
    send = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
    send = send.index_put((flat_e[keep], slot[keep]), x[token[keep]])
    out_b = _expert_ffn(wg, wu, wd, send)                  # (E, C, D)
    gathered = F.pad(out_b, (0, 0, 0, 1))[flat_e, slot.clamp_max(C)]
    y = (gathered.reshape(T, top_k, D).float() * top_p[..., None]).sum(1)
    return y.to(x.dtype).reshape(B_loc, S_loc, D), top_i, probs


def moe_forward(p, x: torch.Tensor, meta: dict):
    """x: (B, S, D) -> (y (B, S, D), aux loss fp32 scalar).  With an
    active mesh whose data axes divide B (and whose ``model`` axis divides
    S and E) the expert-parallel path runs per data shard; otherwise the
    dense path."""
    B, S, D = x.shape
    E, top_k, cf = meta["n_experts"], meta["top_k"], meta["capacity_factor"]
    sizes = mesh_axis_sizes()
    use_ep = False
    if current_mesh_shape() is not None:
        nb = 1
        for a in ("pod", "data"):
            nb *= sizes.get(a, 1)
        ep = sizes.get("model", 1)
        use_ep = B % max(nb, 1) == 0 and S % max(ep, 1) == 0 \
            and E % max(ep, 1) == 0
    if use_ep:
        outs = [_ep_local(xs, p.router, p.wg, p.wu, p.wd, top_k=top_k,
                          n_experts=E, cf=cf, ep_size=ep)
                for xs in x.chunk(nb, dim=0)]
        y = torch.cat([o[0] for o in outs]) if nb > 1 else outs[0][0]
        aux = load_balance_loss(torch.cat([o[2] for o in outs]),
                                torch.cat([o[1] for o in outs]), E)
    else:
        y, aux = _dense_moe(p, x.reshape(B * S, D), meta)
        y = y.reshape(B, S, D)
    if meta["n_shared_experts"]:
        y = y + (silu(x @ p.shared_wg) * (x @ p.shared_wu)) @ p.shared_wd
    return y, aux


def _dense_moe(p, tokens: torch.Tensor, meta: dict):
    """Every expert on every token, combined by the routed weights (no
    capacity): tokens (T, D) -> (y (T, D), aux)."""
    E, top_k = meta["n_experts"], meta["top_k"]
    top_p, top_i, probs = _route(tokens.float() @ p.router, top_k)
    w = torch.zeros_like(probs).scatter(1, top_i, top_p)  # (T, E)
    xb = tokens.expand(E, *tokens.shape)                   # (E, T, D)
    yo = _expert_ffn(p.wg, p.wu, p.wd, xb)                 # (E, T, D)
    y = torch.einsum("etd,te->td", yo.float(), w)
    return y.to(tokens.dtype), load_balance_loss(probs, top_i, E)
