"""Logical-axis sharding arithmetic.

Models are described against *logical* axis names (see core.spec).  A single
rule table maps logical axes to physical mesh axes; divisibility is checked
against the concrete shape so non-divisible dims gracefully replicate (e.g.
smollm's 15 heads on a 16-way model axis).

This is the arithmetic half of the resolution logic: the memory predictor
turns the per-dim axis assignment into shard factors.  ``extra`` axes
implement FSDP/ZeRO: they are greedily assigned to the first divisible,
still-free dimension (params for FSDP, optimizer states for ZeRO).

``mesh_context`` is the size half of the reference's: it activates a mesh
*shape* (axis name -> size, no devices) and a rule table for model code.
Model code reads it where the reference reads whether a mesh is live (the
MoE FFN picks its expert-parallel path by it).  Device meshes and sharding
constraints come with the runtime shell (ROADMAP A8).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

# The pipeline-parallel physical axis: chips along it hold different
# pipeline STAGES (disjoint layer slices, see core.stages), so no tensor
# dimension is ever sharded over it — assign_axes skips it in both the
# rule pass and the FSDP/ZeRO extra pass even if a rule table names it.
# Its degree reaches the predictor as PredictContext.pp.
PIPE_AXIS = "pipe"

# The expert-parallel physical axis: chips along it hold disjoint routed
# EXPERTS.  Unlike `pipe` it IS a tensor-sharding axis, but only the MoE
# logical dims name it (`experts` weight stacks, `expert_buf` dispatch
# buffers) — dense layers carry neither, so `expert` can never shard a
# dense tensor.  Its degree reaches the predictor as PredictContext.ep.
EXPERT_AXIS = "expert"

# The context-parallel (ring-attention) physical axis: shards the `seq`
# dim of train/prefill activations (launch.mesh.arch_rules prepends it to
# the `seq` rule), with the per-hop ring KV send/recv transient modelled
# in core.factors.ring_kv_spec.  Decode KV caches stay on `cache_seq`
# (never mapped to this axis).  Degree reaches PredictContext.cp.
CONTEXT_AXIS = "context"

# logical axis -> tuple of physical mesh axes (applied together)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),                  # sequence-parallel policies set ("model",) etc.
                                # and launch.mesh.arch_rules prepends
                                # CONTEXT_AXIS for train/prefill
    "vocab": ("model",),
    "embed": (),                # residual dim replicated by default
    "embed_cols": ("model",),   # untied embedding tables shard columns:
                                # a vocab-sharded table would be fully
                                # all-gathered by the token lookup
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "experts": (EXPERT_AXIS, "model"),  # routed-expert stacks: EP first,
                                        # TP on what stays divisible
    "expert_buf": (EXPERT_AXIS,),       # MoE dispatch/capacity buffers
                                        # shard over EP only
    "lora": ("model",),
    "conv": (),
    "ssm": ("model",),
    "layers": (),
    "cache_seq": (),            # serve policies may shard cache seq
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh_shape: Optional[dict[str, int]] = None
        self.rules: dict[str, tuple[str, ...]] = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def mesh_context(mesh_shape: Optional[dict], rules: Optional[dict] = None):
    """Activate a mesh shape (``{"data": 1, "model": 1}``; None: no mesh)
    and a logical rule table (overrides on top of the defaults)."""
    old_shape, old_rules = _CTX.mesh_shape, _CTX.rules
    _CTX.mesh_shape = dict(mesh_shape) if mesh_shape is not None else None
    _CTX.rules = {**DEFAULT_RULES, **(rules or {})}
    try:
        yield
    finally:
        _CTX.mesh_shape, _CTX.rules = old_shape, old_rules


def current_mesh_shape() -> Optional[dict]:
    """The active mesh shape, or None outside any ``mesh_context``."""
    return None if _CTX.mesh_shape is None else dict(_CTX.mesh_shape)


def mesh_axis_sizes(mesh_shape: Optional[dict] = None) -> dict[str, int]:
    """Axis name -> size of ``mesh_shape`` (default: the active one; {}
    when there is none)."""
    shape = mesh_shape if mesh_shape is not None else _CTX.mesh_shape
    return dict(shape) if shape else {}


def current_rules() -> dict:
    return dict(_CTX.rules)


def assign_axes(shape: Sequence[int],
                axes: Sequence[Optional[str]],
                sizes: dict[str, int],
                rules: Optional[dict] = None,
                extra: Sequence[str] = ()) -> list[list[str]]:
    """Core resolution: per-dim list of physical mesh axes.

    Base pass maps each dim's logical axis through ``rules`` (skipping
    non-divisible / already-used physical axes); the ``extra`` pass then
    greedily adds each extra physical axis to the first dim that stays
    divisible (FSDP / ZeRO sharding).  The pipeline axis (:data:`PIPE_AXIS`)
    partitions *layers*, not tensors, and is never assigned.
    """
    rules = rules if rules is not None else _CTX.rules
    used: set[str] = set()
    per_dim: list[list[str]] = [[] for _ in shape]
    for i, (dim, ax) in enumerate(zip(shape, axes)):
        if not ax:
            continue
        total = 1
        for a in rules.get(ax, ()):
            if a == PIPE_AXIS or a not in sizes or a in used:
                continue
            if dim % (total * sizes[a]) == 0:
                per_dim[i].append(a)
                used.add(a)
                total *= sizes[a]
    for a in extra:
        if a == PIPE_AXIS or a not in sizes or a in used:
            continue
        best = None
        for i, dim in enumerate(shape):
            # Never FSDP/ZeRO-shard the scan-stack dim: a stack sharded on
            # `layers` cannot be sliced per iteration, so XLA all-gathers
            # the ENTIRE depth-stacked weight before the loop.  Sharding a
            # contraction dim instead
            # yields the per-layer deferred all-gather real FSDP does.
            if axes[i] == "layers":
                continue
            total = math.prod(sizes[x] for x in per_dim[i])
            if dim % (total * sizes[a]) == 0:
                best = i
                break
        if best is not None:
            per_dim[best].append(a)
            used.add(a)
    return per_dim


def shard_factor(shape: Sequence[int],
                 axes: Sequence[Optional[str]],
                 mesh_shape: dict[str, int],
                 rules: Optional[dict] = None,
                 extra: Sequence[str] = ()) -> int:
    """Total shard count implied by the resolved axis assignment (usable
    without a live mesh)."""
    rules = rules if rules is not None else dict(DEFAULT_RULES)
    per_dim = assign_axes(shape, axes, mesh_shape, rules, extra)
    return math.prod(mesh_shape[a] for d in per_dim for a in d)

