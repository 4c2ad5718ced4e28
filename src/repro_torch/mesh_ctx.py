"""Logical-axis sharding arithmetic.

Models are described against *logical* axis names (see core.spec).  A single
rule table maps logical axes to physical mesh axes; divisibility is checked
against the concrete shape so non-divisible dims gracefully replicate (e.g.
smollm's 15 heads on a 16-way model axis).

This is the arithmetic half of the resolution logic: the memory predictor
turns the per-dim axis assignment into shard factors.  ``extra`` axes
implement FSDP/ZeRO: they are greedily assigned to the first divisible,
still-free dimension (params for FSDP, optimizer states for ZeRO).

``mesh_context`` activates a mesh and a rule table for model code.  The
mesh is either a ``torch.distributed.device_mesh.DeviceMesh`` (the
runtime's: one process per device, tensors placed on it as ``DTensor``s)
or a mesh *shape* alone (axis name -> size, no devices), which the
one-device paths use: the model code reads it where the reference reads
whether a mesh is live (the MoE FFN picks its expert-parallel path by it).

The sharding half maps the reference's ``PartitionSpec`` onto DTensor
placements.  :func:`resolve_pspec` returns the reference's spec as a tuple
(one entry per dim: None, an axis name, or a tuple of axis names, major to
minor; trailing Nones dropped).  :class:`Sharding` is the counterpart of
``NamedSharding``: a ``DeviceMesh`` and one placement per mesh dimension.
Where one tensor dim carries several mesh axes, the reference orders its
blocks by the spec's tuple (the first axis major) while DTensor splits by
the mesh's dimension order; an axis that the spec puts ahead of an axis
that comes later in the mesh is therefore a ``_StridedShard`` whose split
factor is the product of those later axes' sizes, so every device holds
the reference's elements, not only as many.
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Optional, Sequence

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
        self.mesh = None                    # the live DeviceMesh, if any
        self.rules: dict[str, tuple[str, ...]] = dict(DEFAULT_RULES)


_CTX = _Ctx()


def _is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names")


def _device_mesh_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@contextlib.contextmanager
def mesh_context(mesh, rules: Optional[dict] = None):
    """Activate a mesh — a ``DeviceMesh`` with named dimensions, or a mesh
    shape (``{"data": 1, "model": 1}``) — or None (no mesh), and a logical
    rule table (overrides on top of the defaults)."""
    old = _CTX.mesh_shape, _CTX.mesh, _CTX.rules
    if mesh is None:
        _CTX.mesh_shape, _CTX.mesh = None, None
    elif _is_device_mesh(mesh):
        _CTX.mesh_shape, _CTX.mesh = _device_mesh_sizes(mesh), mesh
    else:
        _CTX.mesh_shape, _CTX.mesh = dict(mesh), None
    _CTX.rules = {**DEFAULT_RULES, **(rules or {})}
    try:
        yield
    finally:
        _CTX.mesh_shape, _CTX.mesh, _CTX.rules = old


def current_mesh():
    """The live ``DeviceMesh``, or None (no mesh, or a shape alone)."""
    return _CTX.mesh


def current_mesh_shape() -> Optional[dict]:
    """The active mesh shape, or None outside any ``mesh_context``."""
    return None if _CTX.mesh_shape is None else dict(_CTX.mesh_shape)


def mesh_axis_sizes(mesh=None) -> dict[str, int]:
    """Axis name -> size of ``mesh`` (a ``DeviceMesh`` or a shape dict;
    default: the active one; {} when there is none)."""
    if mesh is None:
        return dict(_CTX.mesh_shape) if _CTX.mesh_shape else {}
    return _device_mesh_sizes(mesh) if _is_device_mesh(mesh) else dict(mesh)


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



def _to_pspec(per_dim: list[list[str]]) -> tuple:
    entries: list = [tuple(d) if len(d) > 1 else (d[0] if d else None)
                     for d in per_dim]
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def resolve_pspec(shape: Sequence[int],
                  axes: Sequence[Optional[str]],
                  mesh=None,
                  rules: Optional[dict] = None,
                  extra: Sequence[str] = ()) -> tuple:
    """The reference's ``PartitionSpec`` of a tensor as a tuple: per dim
    None, a mesh axis, or a tuple of mesh axes (major to minor), trailing
    Nones dropped.  ``mesh`` is a ``DeviceMesh`` or a shape dict (default:
    the active mesh)."""
    return _to_pspec(assign_axes(shape, axes, mesh_axis_sizes(mesh), rules,
                                 extra))


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements (one per dimension of ``mesh``) that lay a tensor
    out as the reference's ``spec`` does on a mesh of the same axis names
    and order (see the module's note on strided shards)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    names = list(mesh.mesh_dim_names)
    sizes = _device_mesh_sizes(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        for i, a in enumerate(axes):
            m = names.index(a)
            split = math.prod(sizes[b] for b in axes[:i]
                              if names.index(b) > m)
            out[m] = Shard(d) if split == 1 else \
                _StridedShard(d, split_factor=split)
    return tuple(out)


def place(t, mesh, placements):
    """The ``DTensor`` of ``t`` (the whole tensor, present on every rank)
    on ``placements`` of ``mesh``: each rank keeps its own elements, with
    no communication."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(
        mesh, tuple(placements))


@dataclass(frozen=True)
class Sharding:
    """The counterpart of the reference's ``NamedSharding``: a
    ``DeviceMesh`` and the reference's spec on it (:func:`resolve_pspec`),
    which give one DTensor placement per mesh dimension."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def place(self, t):
        """The ``DTensor`` of ``t`` (the whole tensor, present on every
        rank) on this sharding."""
        return place(t, self.mesh, self.placements)

    def local_shape(self, shape: Sequence[int]) -> tuple:
        """This rank's shape of a tensor of global ``shape``."""
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        return tuple(compute_local_shape_and_global_offset(
            tuple(shape), self.mesh, list(self.placements))[0])

    def unstacked(self) -> "Sharding":
        """The sharding of one layer of a stacked leaf (a leading
        ``layers`` dim, which the rules never shard)."""
        if self.spec and self.spec[0] is not None:
            raise ValueError(f"a stacked leaf sharded on its layers dim: "
                             f"{self.spec}")
        return Sharding(self.mesh, self.spec[1:])


def named_sharding(shape: Sequence[int],
                   axes: Sequence[Optional[str]],
                   mesh=None,
                   extra: Sequence[str] = ()) -> Optional[Sharding]:
    """The :class:`Sharding` of a tensor on ``mesh`` (default: the live
    ``DeviceMesh``); None when there is none."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return None
    return Sharding(mesh, resolve_pspec(shape, axes, mesh, extra=extra))


def shard(x, *axes: Optional[str]):
    """Lay ``x`` out by logical axes: a ``DTensor`` is redistributed to the
    resolved placements on its mesh; a plain tensor is returned unchanged
    (the reference's ``with_sharding_constraint``, a no-op without a
    mesh)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(
        resolve_pspec(x.shape, axes, mesh), mesh))
