"""Parameters of a spec tree, held in ``nn.Module``s.

The reference keeps parameters as nested dicts mirroring the ModuleSpec
tree, with every leaf of a scanned module stacked on a leading ``layers``
axis.  Here the same tree is a tree of modules:

* :class:`LayerParams` — one layer's tensors as ``nn.Parameter``s, named
  as in the spec (``params.language_model.blocks[3].attn.wq``);
* :class:`ModuleParams` — a spec module: its layers and child modules by
  name; a scanned (stacked) module is a :class:`StackParams` (an
  ``nn.ModuleList``) of per-layer :class:`ModuleParams`, so every block
  owns its own tensors.

Both also answer ``p["name"]`` and ``"name" in p``, the reference's dict
idiom, so each apply reads like its counterpart.  Parameters are created
with ``requires_grad=False`` (serving records no graph); training turns on
the trainable ones:

* :func:`set_trainable` — the counterpart of the reference's
  ``trainable_mask`` + ``partition_params``: sets ``requires_grad`` on
  every leaf by ``TrainPolicy.is_trainable`` of its module path;
* :func:`trainable_params` — the ``(name, Parameter)`` pairs that train
  (``merge_params`` has no counterpart: the tree is never split);
* :func:`trainable_leaves` — the same tensors grouped by the reference's
  leaf (:class:`Leaf`): one leaf of a scanned module is the stack of its
  layers' tensors, which the reference's optimizers update as one array.

* :func:`init_params` follows the reference's ``_init_leaf`` rules
  (normal scaled by 1/sqrt(fan-in), ``embed`` x 0.02, zeros, ones, the
  SSM's ``ssm_a`` = log U[1, 16) and ``dt_bias`` = softplus^-1 of a
  log-uniform dt in [1e-3, 1e-1]) in the spec's dtype, drawing from an
  explicit ``torch.Generator`` on the target device.  The generator is
  not JAX's, so the values differ from the reference's for the same
  seed; tests carry the reference's values across with
  :func:`params_from_numpy`.
* :func:`params_from_numpy` takes the reference's parameter tree as numpy
  arrays (stacked leaves included) and returns the port's tree with every
  value bit-equal.

The sharding helpers speak the reference's layout: :func:`param_specs`
(shape and dtype per leaf, no allocation) and :func:`param_axes` (logical
axes per leaf) are the reference's nested dicts, a scanned module's
leaves stacked on a leading ``layers`` axis, and :func:`trainable_mask` /
:func:`partition_params` split such a tree by a policy.  A tree of
:class:`~repro_torch.mesh_ctx.Sharding`s in that layout reaches the
port's per-layer tensors through :func:`sharding_of` (one layer of a
stacked leaf takes the stack's sharding without its ``layers`` dim), and
:func:`place_params` puts every parameter onto its sharding as a
``DTensor``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.core.spec import (AXIS_LAYERS, ModuleSpec, ParamSpec,
                                   TrainPolicy)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# a leaf of at least this many elements is scaled in place at init; a
# smaller one keeps the out-of-place program, whose allocator footprint
# the card's measured cells were taken with (the caching allocator's free
# blocks after init move later peaks by up to a few MB)
IN_PLACE_ELEMENTS = 1 << 30


class _Named:
    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class LayerParams(_Named, nn.Module):
    """One layer's parameter tensors, by the spec's names."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))


class ModuleParams(_Named, nn.Module):
    """A spec module: layers and child modules by name."""

    def __init__(self, children: dict):
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)


class StackParams(nn.ModuleList):
    """A scanned module of the spec: one :class:`ModuleParams` per layer.
    The reference stacks each of its leaves on a leading layers axis."""


def _stacked(mod: ModuleSpec) -> bool:
    return mod.repeat > 1 or mod.scanned


def _build(spec: ModuleSpec, make_leaf) -> ModuleParams:
    """The module tree of ``spec``; ``make_leaf(path, param_spec, layer)``
    returns one tensor (``layer`` is ``(index, stack depth)`` inside a
    stack, else None)."""

    def module(mod: ModuleSpec, path: tuple, layer) -> ModuleParams:
        out = {}
        for ls in mod.layers:
            out[ls.name] = LayerParams({
                name: make_leaf(path + (ls.name, name), p, layer)
                for name, p in ls.params.items()})
        for child in mod.children:
            if _stacked(child):
                if layer is not None:
                    raise NotImplementedError(
                        f"{child.name}: a stacked module inside a stacked "
                        f"module is not ported yet")
                out[child.name] = StackParams(
                    [module(child, path + (child.name,), (i, child.repeat))
                     for i in range(child.repeat)])
            else:
                out[child.name] = module(child, path + (child.name,), layer)
        return ModuleParams(out)

    if _stacked(spec):
        raise NotImplementedError("a stacked root module is not ported yet")
    return ModuleParams({spec.name: module(spec, (spec.name,), None)})


def _init_leaf(p: ParamSpec, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    dtype = TORCH_DTYPES[p.dtype]
    shape = tuple(p.shape)
    if p.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if p.init == "ssm_a":
        # Mamba A_log: log of uniform [1, 16)
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=device) * 15.0 + 1.0
        return torch.log(u).to(dtype)
    if p.init == "dt_bias":
        # softplus^-1 of a log-uniform dt in [1e-3, 1e-1]
        lo, hi = math.log(1e-3), math.log(0.1)
        dt = torch.exp(torch.rand(shape, generator=generator,
                                  dtype=torch.float32, device=device)
                       * (hi - lo) + lo)
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if p.init not in ("normal", "embed"):
        raise ValueError(f"unknown init {p.init!r}")
    fan_in = p.shape[0] if len(p.shape) >= 2 else max(
        p.shape[-1] if p.shape else 1, 1)
    scale = p.init_scale / math.sqrt(max(fan_in, 1))
    if p.init == "embed":
        scale = p.init_scale * 0.02
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    if x.numel() >= IN_PLACE_ELEMENTS:
        # the same values, scaled in place: the transient is one fp32 draw
        # and its cast, not two fp32 tensors (an arctic-480b expert stack
        # is 17.9 GB in fp32, and the second copy would not fit the card)
        return x.mul_(scale).to(dtype)
    return (x * scale).to(dtype)


def init_params(spec: ModuleSpec, generator: torch.Generator,
                device) -> ModuleParams:
    """Allocate every parameter of ``spec`` on ``device`` (the generator
    must live on the same device)."""
    device = torch.device(device)
    return _build(spec, lambda path, p, layer: _init_leaf(p, generator,
                                                          device))


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 included) as a tensor on
    ``device``, bit for bit."""
    a = np.array(a, order="C")              # a writable copy
    if a.dtype.name == "bfloat16":          # ml_dtypes: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: dict, device, spec: ModuleSpec) -> ModuleParams:
    """The reference's parameter tree (numpy leaves, scanned modules
    stacked on a leading axis) as the port's :class:`ModuleParams`, every
    value bit-equal.  ``spec`` says which modules are stacked."""
    device = torch.device(device)

    def leaf(path, p: ParamSpec, layer):
        node = tree
        for key in path:
            node = node[key]
        a = np.asarray(node)
        want = tuple(p.shape) if layer is None \
            else (layer[1],) + tuple(p.shape)
        if a.shape != want:
            raise ValueError(f"{'/'.join(path)}: shape {a.shape}, spec "
                             f"says {want}")
        return tensor_from_numpy(a if layer is None else a[layer[0]],
                                 device)

    return _build(spec, leaf)


def count_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def module_path(name: str) -> str:
    """The reference's module path (``vlm/language_model/blocks``) of a
    parameter named ``vlm.language_model.blocks.3.attn.wq``: the layer and
    leaf names and the index into a stack dropped."""
    parts = name.split(".")[:-2]
    return "/".join(p for p in parts if not p.isdigit())


def set_trainable(params: ModuleParams, policy: TrainPolicy) -> ModuleParams:
    """Mark each leaf trainable (``requires_grad``) or frozen by the
    policy, in place; returns ``params``."""
    for name, t in params.named_parameters():
        t.requires_grad_(policy.is_trainable(module_path(name)))
    return params


def trainable_params(params: ModuleParams) -> list:
    """The ``(name, Parameter)`` pairs that train, in the tree's order."""
    return [(name, t) for name, t in params.named_parameters()
            if t.requires_grad]


@dataclass(frozen=True)
class Leaf:
    """One leaf of the reference's parameter tree over the port's tensors.

    A leaf of a scanned module stacks its layers' tensors on a leading
    axis of ``len(params)``; every other leaf is one tensor.  ``name`` is
    the reference's path with dots (``vlm.language_model.blocks.attn.wq``),
    ``params`` the port's ``(name, tensor)`` pairs in layer order."""

    name: str
    params: tuple
    stacked: bool

    @property
    def shape(self) -> tuple:
        """The reference's shape of the leaf (stacked: layers first)."""
        t = self.params[0][1]
        return ((len(self.params),) if self.stacked else ()) \
            + tuple(t.shape)


def group_leaves(params: ModuleParams, named: list) -> list:
    """``named`` (``(name, tensor)`` pairs of ``params``, e.g.
    :func:`trainable_params`) grouped into :class:`Leaf`s, in order of
    first appearance.  Which tensors form a stack is read from the tree's
    :class:`StackParams`, which ``_build`` makes exactly for the spec's
    scanned modules; a stack must come whole."""
    stacks = {name: len(m) for name, m in params.named_modules()
              if isinstance(m, StackParams)}
    groups: dict = {}
    for name, t in named:
        stack = next((s for s in stacks if name.startswith(s + ".")), None)
        if stack is None:
            groups[name] = (None, [(0, name, t)])
            continue
        layer, rest = name[len(stack) + 1:].split(".", 1)
        groups.setdefault(f"{stack}.{rest}", (stack, []))[1].append(
            (int(layer), name, t))
    out = []
    for leaf, (stack, items) in groups.items():
        items.sort(key=lambda it: it[0])
        if stack is not None and [i for i, _, _ in items] \
                != list(range(stacks[stack])):
            raise ValueError(f"{leaf}: {len(items)} of the stack's "
                             f"{stacks[stack]} layers given; a stacked "
                             f"leaf is updated whole")
        out.append(Leaf(leaf, tuple((n, t) for _, n, t in items),
                        stack is not None))
    return out


def trainable_leaves(params: ModuleParams) -> list:
    """The trainable tensors grouped by the reference's leaf."""
    return group_leaves(params, trainable_params(params))


# ---------------------------------------------------------------------------
# the reference's nested-dict layout: specs, axes, masks, shardings
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one leaf (no tensor behind it)."""

    shape: tuple
    dtype: torch.dtype


def _spec_tree(spec: ModuleSpec, leaf) -> dict:
    """The reference's nested dict over ``spec``: ``leaf(param_spec,
    stack, path)`` per parameter, ``stack`` the leading layers count (0
    outside a scanned module)."""

    def module(mod: ModuleSpec, stack: int, path: str) -> dict:
        out: dict = {}
        if _stacked(mod):
            stack = max(stack, 1) * mod.repeat
        for ls in mod.layers:
            out[ls.name] = {name: leaf(p, stack, path)
                            for name, p in ls.params.items()}
        for child in mod.children:
            out[child.name] = module(child, stack, f"{path}/{child.name}")
        return out

    return {spec.name: module(spec, 0, spec.name)}


def param_specs(spec: ModuleSpec) -> dict:
    """:class:`TensorSpec` per leaf, as the reference's ``param_specs``."""
    return _spec_tree(spec, lambda p, stack, path: TensorSpec(
        ((stack,) if stack else ()) + tuple(p.shape), TORCH_DTYPES[p.dtype]))


def param_axes(spec: ModuleSpec) -> dict:
    """Logical-axis tuple per leaf (``layers`` first on a stacked leaf)."""
    return _spec_tree(spec, lambda p, stack, path: (
        (AXIS_LAYERS,) if stack else ()) + (
        tuple(p.axes) if p.axes else (None,) * len(p.shape)))


def trainable_mask(spec: ModuleSpec, policy: TrainPolicy) -> dict:
    """Whether each leaf trains under ``policy`` (the reference's mask)."""
    return _spec_tree(spec, lambda p, stack, path: policy.is_trainable(path))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (a leaf: anything else),
    with the matching nodes of ``rest`` (which may stop at ``tree``'s
    leaves, as a state dict per leaf does)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def partition_params(tree: dict, mask: dict) -> tuple:
    """(trainable, frozen) of a tree in the reference's layout, the leaves
    of the other part ``None``."""
    return (tree_map(lambda x, m: x if m else None, tree, mask),
            tree_map(lambda x, m: None if m else x, tree, mask))


def leaf_keys(name: str) -> tuple:
    """The reference's keys of a port parameter name and whether it is one
    layer of a stacked leaf: ``lm.blocks.3.attn.wq`` ->
    ``(("lm", "blocks", "attn", "wq"), True)``."""
    parts = name.split(".")
    keys = tuple(k for k in parts if not k.isdigit())
    return keys, len(keys) != len(parts)


def sharding_of(shardings: dict, name: str):
    """The :class:`~repro_torch.mesh_ctx.Sharding` of a port tensor (a
    parameter name, or a :class:`Leaf` name) in a tree of the reference's
    layout; a layer of a stacked leaf gets its per-layer sharding."""
    keys, layer = leaf_keys(name)
    node = shardings
    for k in keys:
        node = node[k]
    return node.unstacked() if layer and node is not None else node


def map_params(params: ModuleParams, fn) -> ModuleParams:
    """A new tree of ``params``' structure holding ``fn(tensor)`` for each
    parameter, ``requires_grad`` kept."""

    def rebuild(m: nn.Module) -> nn.Module:
        if isinstance(m, LayerParams):
            out = LayerParams({})
            for name, t in m._parameters.items():
                out._parameters[name] = nn.Parameter(
                    fn(t.detach()), requires_grad=t.requires_grad)
            return out
        if isinstance(m, StackParams):
            return StackParams([rebuild(c) for c in m])
        return ModuleParams({n: rebuild(c) for n, c in m._modules.items()})

    return rebuild(params)


def place_params(params: ModuleParams, shardings: dict) -> ModuleParams:
    """Put every parameter onto its sharding (a tree in the reference's
    layout, from ``launch.mesh.param_shardings``) as a ``DTensor``, in
    place; ``requires_grad`` is kept.  Returns ``params``."""
    for mod_name, mod in params.named_modules():
        if not isinstance(mod, LayerParams):
            continue
        for name, t in list(mod._parameters.items()):
            sh = sharding_of(shardings, f"{mod_name}.{name}")
            mod._parameters[name] = nn.Parameter(
                sh.place(t.detach()), requires_grad=t.requires_grad)
    return params
