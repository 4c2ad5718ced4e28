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

* with a mesh shape alone (one device), the expert-parallel dispatch
  ``_ep_local`` per data-parallel shard: route (softmax -> top-k ->
  renormalize), give each (token, expert) pair a slot in its expert's
  fixed-capacity buffer in token order, drop the pairs past the capacity,
  run each expert's SwiGLU on its buffer (batched products), and combine.
  Its ``model`` axis must be 1: an expert-parallel exchange needs ranks;
* with a live ``DeviceMesh`` (one process per device), ``x`` is this
  rank's rows (batch over the data axes), the same on every rank of
  ``model``, as the port's ZeRO step runs every rank on the whole of its
  rows.  The router runs on the rows; each rank of ``model`` then takes
  its block of the sequence (:class:`_Split`) — the reference's
  ``shard_map`` block — and ``_dispatch`` runs on it with the
  expert-parallel exchange over the **``model``** axis: each rank fills
  ``send (E, C, D)``, an all-to-all over the ``model`` sub-group turns it
  into its local experts' ``(E_loc, ep*C, D)`` — the sources' blocks in
  order of their ``model`` coordinate — the local experts run, the
  reverse all-to-all brings each token's outputs home, and the blocks are
  gathered back into the rows (:class:`_Unsplit`).  Every exchange is
  differentiable, and each rank's gradients are those of the rows' loss,
  the same on every rank of ``model``: :class:`_AllToAll`'s backward is
  the same exchange of the gradients, :class:`_Split`'s gathers every
  block's gradient and :class:`_Unsplit`'s keeps the rank's block.  The
  experts are the rank's block of the stacks (a ``DTensor``'s local
  shard, or the block of a whole tensor through :class:`_Split`);
* with none, ``_dense_moe``: every expert on every token, weighted by the
  routed probabilities (no capacity, no drop).

The reference evaluates the router twice on its expert-parallel path
(inside ``_ep_local`` and again, on the global tokens, for the aux loss);
the port evaluates it once (``_ep_local`` returns its routing) and takes
the aux loss from it: the same values, one (T, E) fp32 tensor fewer.
Under a ``DeviceMesh`` the routing of every rank of the batch axes is
all-gathered first, so every rank computes the reference's global
scalar; :class:`_AllGather`'s backward sums every rank's gradient of the
whole and keeps the rank's rows, so the ZeRO step's average over the
batch axes is the gradient of that one scalar.  A dropped pair reads
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
from repro_torch.mesh_ctx import (current_mesh, current_mesh_shape,
                                  mesh_axis_sizes)
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
# the exchanges between ranks
# ---------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group`` with equal splits of dim 0:
    block j goes to the group's rank j, and block j of the result came
    from it.  The backward is the same exchange of the gradients."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        # the gradient of a transposed view keeps its strides, and
        # empty_like would too: the exchange needs contiguous blocks
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def _gathered(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in ``group``'s rank
    order (no autograd)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` (each its own rows) concatenated along dim 0 in
    ``group``'s rank order.  Each rank's loss reads the whole, so the
    backward is the gradient of the sum of the ranks' losses: every rank's
    gradient of the whole, summed over ``group``, this rank's rows of it.
    A step that then averages the ranks' gradients over ``group`` (the
    ZeRO step over the batch axes) gets the gradient of the one scalar."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group, ctx.rows = group, x.shape[0]
        ctx.index = dist.get_rank(group)
        return _gathered(x, group)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], None


class _Split(torch.autograd.Function):
    """This rank's block of ``x`` along ``dim``, where every rank of
    ``group`` holds the same ``x``: block i of n equal ones for the rank
    of index i.  The other blocks reach the (same) loss on their own
    ranks, so the backward gathers every rank's block of the gradient:
    the gradient of the whole, the same on every rank."""

    @staticmethod
    def forward(ctx, x, group, dim):
        import torch.distributed as dist
        ctx.group, ctx.dim = group, dim
        size = x.shape[dim] // dist.get_world_size(group)
        return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gathered(g, ctx.group, ctx.dim), None, None


class _Unsplit(torch.autograd.Function):
    """The inverse of :class:`_Split`: every rank's block concatenated
    along ``dim`` in ``group``'s rank order, the same whole on every rank.
    What reads it is the same on every rank, so the backward keeps this
    rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        import torch.distributed as dist
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return _gathered(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


def _gather_batch(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t``'s rows from every rank of the batch axes (``pod``, ``data``)
    of ``mesh``, each in turn; a floating ``t`` through
    :class:`_AllGather`."""
    for dim, name in enumerate(mesh.mesh_dim_names):
        if name in ("pod", "data") and mesh.size(dim) > 1:
            group = mesh.get_group(dim)
            t = _AllGather.apply(t, group) if t.is_floating_point() \
                else _gathered(t, group)
    return t


def _model_group(mesh):
    """The ``model`` sub-group of ``mesh``, checked to rank its members by
    their ``model`` coordinate (the order the exchange concatenates)."""
    import torch.distributed as dist
    group = mesh.get_group("model")
    if dist.get_rank(group) != mesh.get_local_rank("model"):
        raise RuntimeError("the model sub-group does not rank its members "
                           "by their model coordinate")
    return group


def _local_experts(w: torch.Tensor, mesh, group) -> torch.Tensor:
    """This rank's block of an expert stack (E, ...): a ``DTensor``'s
    local shard (sharded on E over ``model`` alone), or the block of a
    whole tensor by the rank's ``model`` coordinate (:class:`_Split`)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    m = mesh.mesh_dim_names.index("model")
    if isinstance(w, DTensor):
        want = tuple(Shard(0) if i == m else Replicate()
                     for i in range(mesh.ndim))
        if tuple(w.placements) != want:
            raise ValueError(f"expert stack placed {w.placements}; the "
                             f"expert-parallel path takes {want}")
        return w.to_local()
    return _Split.apply(w, group, 0)


# ---------------------------------------------------------------------------
# expert-parallel path
# ---------------------------------------------------------------------------


def _ep_local(x, router_w, wg, wu, wd, *, top_k: int, n_experts: int,
              cf: float, ep_size: int = 1):
    """One device's shard of tokens x (B_loc, S_loc, D) through the
    experts with a fixed capacity per expert -> (y (B_loc, S_loc, D),
    top_i (T, k), probs (T, E)).  The reference's returns y alone and
    evaluates the router again for the aux loss; the port hands its
    routing back instead.  An expert-parallel axis (``ep_size > 1``)
    needs ranks: :func:`_moe_on_ranks` runs it."""
    if ep_size > 1:
        raise NotImplementedError(
            f"the MoE all-to-all over an expert-parallel axis of size "
            f"{ep_size} exchanges between ranks: run under "
            f"mesh_context(DeviceMesh), one process per device, not a mesh "
            f"shape")
    top_p, top_i, probs = _route(
        x.reshape(-1, x.shape[-1]).float() @ router_w, top_k)
    return _dispatch(x, top_p, top_i, wg, wu, wd, n_experts=n_experts,
                     cf=cf), top_i, probs


def _dispatch(x, top_p, top_i, wg, wu, wd, *, n_experts: int, cf: float,
              ep_group=None):
    """Tokens x (B_loc, S_loc, D), routed to ``top_i`` with weights
    ``top_p`` (T, k), through the experts with a fixed capacity per expert
    -> y (B_loc, S_loc, D).  ``wg`` / ``wu`` / ``wd`` are the local experts
    (E_loc, ...); with ``ep_group`` (the ``model`` sub-group of a live
    ``DeviceMesh``) the buffers are exchanged over it, as the reference's
    ``all_to_all(split_axis=0, concat_axis=1, tiled=True)``."""
    import torch.distributed as dist
    B_loc, S_loc, D = x.shape
    x = x.reshape(B_loc * S_loc, D)
    T, E, top_k = B_loc * S_loc, n_experts, top_i.shape[1]
    C = _capacity(T, top_k, E, cf)
    flat_e = top_i.reshape(-1)                             # (T*k,)
    slot = _slots(flat_e, E)
    keep = slot < C                                        # the rest drop
    token = torch.arange(T * top_k, device=x.device) // top_k
    send = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
    send = send.index_put((flat_e[keep], slot[keep]), x[token[keep]])
    if ep_group is not None:
        # (E, C, D) -> (E_loc, ep*C, D): each rank keeps its experts and
        # receives every source's capacity block, in the sources' order
        ep_size = dist.get_world_size(ep_group)
        e_loc = E // ep_size
        recv = _AllToAll.apply(send.view(ep_size, e_loc, C, D), ep_group)
        recv = recv.transpose(0, 1).reshape(e_loc, ep_size * C, D)
        out_b = _expert_ffn(wg, wu, wd, recv)              # (E_loc, ep*C, D)
        back = out_b.view(e_loc, ep_size, C, D).transpose(0, 1)
        out_b = _AllToAll.apply(back.contiguous(), ep_group).reshape(E, C, D)
    else:
        out_b = _expert_ffn(wg, wu, wd, send)              # (E, C, D)
    gathered = F.pad(out_b, (0, 0, 0, 1))[flat_e, slot.clamp_max(C)]
    y = (gathered.reshape(T, top_k, D).float() * top_p[..., None]).sum(1)
    return y.to(x.dtype).reshape(B_loc, S_loc, D)


def moe_forward(p, x: torch.Tensor, meta: dict):
    """x: (B, S, D) -> (y (B, S, D), aux loss fp32 scalar).  Under a live
    ``DeviceMesh`` x is this rank's rows, the same on every rank of
    ``model``, and the expert-parallel exchange runs over ``model`` (the
    dense path on the rows where ``model`` does not divide S and E, as
    the reference's falls back); under a mesh shape whose data axes
    divide B (and whose ``model`` axis, which must be 1, divides S and E)
    the expert-parallel path runs per data shard; otherwise the dense
    path."""
    B, S, D = x.shape
    E, top_k, cf = meta["n_experts"], meta["top_k"], meta["capacity_factor"]
    mesh = current_mesh()
    if mesh is not None:
        y, aux = _moe_on_ranks(p, x, meta, mesh)
    else:
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


def _moe_on_ranks(p, x: torch.Tensor, meta: dict, mesh):
    """The routed experts of this rank's rows ``x`` (B_loc, S, D), the
    same on every rank of ``model``, under a live ``DeviceMesh``: each
    rank of ``model`` takes its block of the sequence (the reference's
    ``shard_map`` block), the exchange over ``model``, the blocks
    gathered back; and the aux loss of every rank's routing."""
    B, S, D = x.shape
    E, top_k, cf = meta["n_experts"], meta["top_k"], meta["capacity_factor"]
    ep = mesh_axis_sizes(mesh).get("model", 1)
    tokens = x.reshape(B * S, D)
    top_p, top_i, probs = _route(tokens.float() @ p.router, top_k)
    if E % ep or S % ep:
        y = _dense_experts(p, tokens, top_p, top_i, E).reshape(B, S, D)
    elif ep == 1:
        y = _dispatch(x, top_p, top_i, p.wg, p.wu, p.wd, n_experts=E, cf=cf)
    else:
        group = _model_group(mesh)

        def block(t):
            return _Split.apply(t.reshape(B, S, *t.shape[1:]), group, 1)

        w = [_local_experts(t, mesh, group) for t in (p.wg, p.wu, p.wd)]
        y = _dispatch(block(x.reshape(B * S, D)),
                      block(top_p).reshape(-1, top_k),
                      block(top_i).reshape(-1, top_k), *w, n_experts=E,
                      cf=cf, ep_group=group)
        y = _Unsplit.apply(y, group, 1)
    aux = load_balance_loss(_gather_batch(probs, mesh),
                            _gather_batch(top_i, mesh), E)
    return y, aux


def _dense_experts(p, tokens: torch.Tensor, top_p: torch.Tensor,
                   top_i: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Every expert on every token, combined by the routed weights (no
    capacity): tokens (T, D) -> y (T, D)."""
    w = top_p.new_zeros((tokens.shape[0], n_experts)).scatter(
        1, top_i, top_p)                                   # (T, E)
    xb = tokens.expand(n_experts, *tokens.shape)           # (E, T, D)
    yo = _expert_ffn(p.wg, p.wu, p.wd, xb)                 # (E, T, D)
    y = torch.einsum("etd,te->td", yo.float(), w)
    return y.to(tokens.dtype)


def _dense_moe(p, tokens: torch.Tensor, meta: dict):
    """Every expert on every token, combined by the routed weights (no
    capacity): tokens (T, D) -> (y (T, D), aux)."""
    E = meta["n_experts"]
    top_p, top_i, probs = _route(tokens.float() @ p.router, meta["top_k"])
    return (_dense_experts(p, tokens, top_p, top_i, E),
            load_balance_loss(probs, top_i, E))
