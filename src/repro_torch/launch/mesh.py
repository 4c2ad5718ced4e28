"""Production meshes and the sharding policy.

The pure helpers of the launch layer: every way to lay ``n_chips`` out over
named mesh axes, the parallel degrees of a mesh-shape dict, and the
per-arch logical->physical rule overrides the memory predictor resolves
shard factors through.

The device half: ``make_production_mesh`` builds the reference's meshes —
(16, 16) ``data, model`` on one pod (256 devices) and (2, 16, 16) ``pod,
data, model`` on two — and ``make_smoke_mesh`` a small one, each an
``init_device_mesh`` with the reference's axis names in the reference's
order over the ``torch.distributed`` world (one process per device).
``param_shardings`` / ``opt_shardings`` / ``zero_grad_shardings`` /
``batch_shardings`` / ``cache_shardings`` derive
:class:`~repro_torch.mesh_ctx.Sharding`s from the spec tree's logical axes
through ``mesh_ctx.resolve_pspec`` — the resolution the memory predictor
uses arithmetically — in the reference's nested layout.  Importing this
module touches no device and no process group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.mesh_ctx import (CONTEXT_AXIS, DEFAULT_RULES, EXPERT_AXIS,
                                  PIPE_AXIS, Sharding, resolve_pspec)
from repro_torch.models import param as PM
from repro_torch.models.param import tree_map


def _device_mesh(device_type: str, shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh over the current world (256 or 512
    ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(device_type, shape, axes)


def make_smoke_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A small ``data, model`` mesh (a world of ``data * model`` ranks)."""
    return _device_mesh(device_type, (data, model), ("data", "model"))


def divisors(n: int) -> list[int]:
    """Positive divisors of ``n``, ascending."""
    small, large = [], []
    d = 1
    while d * d <= n:
        if n % d == 0:
            small.append(d)
            if d != n // d:
                large.append(n // d)
        d += 1
    return small + large[::-1]


def factorizations(n: int, k: int) -> list[tuple[int, ...]]:
    """All ordered ``k``-tuples of positive ints whose product is ``n``.

    Ordered means (2, 8) and (8, 2) are distinct — mesh axes are named, so
    data=2/model=8 and data=8/model=2 are different parallelism plans.
    """
    if n < 1 or k < 1:
        raise ValueError(f"need n >= 1, k >= 1; got n={n}, k={k}")
    if k == 1:
        return [(n,)]
    out = []
    for d in divisors(n):
        for rest in factorizations(n // d, k - 1):
            out.append((d,) + rest)
    return out


def enumerate_meshes(n_chips: int,
                     axes: tuple[str, ...] = ("data", "model"),
                     max_axis: Optional[dict] = None) -> list[dict]:
    """Every mesh shape that lays ``n_chips`` out over the named ``axes``.

    The capacity-planning sweep feeds each of these to the memory predictor
    to find which parallelism plans fit.  ``max_axis`` caps individual axes
    (e.g. ``{"model": 16}`` — an ICI-connected TP axis rarely exceeds a
    pod's torus dimension; ``{"pipe": 8}`` bounds pipeline depth).
    Results are deduplicated and sorted by descending data-parallel degree
    (the conventional preference: DP is the cheapest axis,
    collectives-wise).  Including :data:`~repro_torch.mesh_ctx.PIPE_AXIS` in
    ``axes`` enumerates pipeline-parallel plans: chips along ``pipe`` hold
    disjoint layer stages (core.stages) and never shard tensors.
    Including :data:`~repro_torch.mesh_ctx.EXPERT_AXIS` /
    :data:`~repro_torch.mesh_ctx.CONTEXT_AXIS` enumerates expert-parallel and
    context-parallel (ring-attention) plans, capped by
    ``{"expert": N}`` / ``{"context": N}`` (CLI ``--max-expert`` /
    ``--max-context``); the planner rejects plans that are invalid for
    the architecture or step kind (``planner.check_parallel``).
    """
    seen: set[tuple[int, ...]] = set()
    out: list[dict] = []
    for f in factorizations(n_chips, len(axes)):
        if f in seen:
            continue
        seen.add(f)
        if max_axis and any(f[i] > max_axis.get(a, f[i])
                            for i, a in enumerate(axes)):
            continue
        out.append(dict(zip(axes, f)))
    out.sort(key=lambda m: tuple(-m[a] for a in axes))
    return out


def mesh_chips(mesh_shape: dict) -> int:
    """Total chip count of a mesh-shape dict."""
    total = 1
    for v in mesh_shape.values():
        total *= v
    return total


def pp_degree(mesh_shape: dict) -> int:
    """Pipeline-stage count of a mesh shape (1 when it has no pipe axis)."""
    return int(mesh_shape.get(PIPE_AXIS, 1))


def ep_degree(mesh_shape: dict) -> int:
    """Expert-parallel degree of a mesh shape (1 without an expert axis)."""
    return int(mesh_shape.get(EXPERT_AXIS, 1))


def cp_degree(mesh_shape: dict) -> int:
    """Context-parallel degree of a mesh shape (1 without a context axis)."""
    return int(mesh_shape.get(CONTEXT_AXIS, 1))


# ---------------------------------------------------------------------------
# sharding policy
# ---------------------------------------------------------------------------


def arch_rules(cfg, kind: str = "train") -> dict:
    """Per-arch logical->physical rule overrides."""
    rules = dict(DEFAULT_RULES)
    if kind in ("train", "prefill") and cfg.seq_parallel:
        # Sequence parallelism: the residual stream (and therefore the
        # per-layer saved scan carry — the dominant training activation)
        # is sharded over `model` as well as `data`.  Attention math stays
        # global; the byte model follows the reference runtime, where
        # the partitioner inserts the gather/scatter collectives.
        rules["seq"] = ("model",)
    if kind in ("train", "prefill"):
        # Context parallelism (ring attention): the seq dim of every
        # activation shards over `context` FIRST, SP's `model` split on
        # what stays divisible.  Decode is token-at-a-time — no seq dim
        # to split — so cp is rejected there (planner.check_parallel)
        # and the decode `cache_seq` rule below never names `context`.
        rules["seq"] = (CONTEXT_AXIS,) + rules["seq"]
    if kind == "prefill":
        # prefill caches derive from the seq-sharded residual stream, so
        # they are laid out seq-sharded over `model` (matches SP) — and,
        # under ring attention, over `context` first: each cp rank
        # computes and holds only its sequence block's KV.  (Decode
        # below is different: cp is rejected there, and its caches
        # shard over `model` only.)
        rules["cache_seq"] = (CONTEXT_AXIS, "model")
    elif kind == "decode":
        # Decode caches shard their sequence dim over `model`: none of the
        # zoo's GQA head counts fill a 16-way axis (8, 5, 16...), so
        # head-sharding strands memory, while seq-sharding divides the one
        # buffer that dominates serving.  MLA latents have no head dim at
        # all.  The per-step attention becomes a sharded partial softmax +
        # cross-shard reduce.
        rules["cache_seq"] = ("model",)
    return rules


def _sharding(mesh, shape, axes, **kw) -> Sharding:
    return Sharding(mesh, resolve_pspec(shape, axes, mesh, **kw))


def param_shardings(model, mesh) -> dict:
    """Each parameter's sharding (the ``data`` axis added under
    ``cfg.fsdp``), in the reference's layout."""
    extra = ("data",) if model.cfg.fsdp else ()
    return tree_map(lambda ax, sd: _sharding(mesh, sd.shape, ax, extra=extra),
                model.param_axes(), model.param_specs())


def opt_shardings(model, mesh, trainable_specs: dict, opt_cfg,
                  trainable_axes: dict) -> dict:
    """ZeRO sharding: optimizer-state leaves inherit the param's logical
    axes where shapes line up, plus an extra ``data`` shard."""
    from repro_torch.train.optimizer import opt_state_specs
    state_specs = opt_state_specs(trainable_specs, opt_cfg)

    def leaf_state(pspec_axes, sd, st):
        if st is None:
            return None
        pshape = tuple(sd.shape)
        out = {}
        for name, s in st.items():
            if tuple(s.shape) == pshape:
                ax = pspec_axes
            elif len(s.shape) == len(pshape) - 1 \
                    and tuple(s.shape) == pshape[:-1]:
                ax = pspec_axes[:-1]                 # adafactor v_row
            elif len(s.shape) == len(pshape) - 1 \
                    and tuple(s.shape) == pshape[:-2] + pshape[-1:]:
                ax = pspec_axes[:-2] + pspec_axes[-1:]  # adafactor v_col
            else:
                ax = (None,) * len(s.shape)          # 8-bit blocks etc.
            out[name] = _sharding(mesh, s.shape, ax, extra=("data",))
        return out

    return tree_map(leaf_state, trainable_axes, trainable_specs, state_specs)


def zero_grad_shardings(mesh, trainable_specs: dict,
                        trainable_axes: dict) -> dict:
    """Reduce-scatter target sharding for gradients (param axes + data)."""
    return tree_map(lambda ax, sd: None if sd is None
                else _sharding(mesh, sd.shape, ax, extra=("data",)),
                trainable_axes, trainable_specs)


def batch_shardings(mesh, batch_spec: dict) -> dict:
    return {k: _sharding(mesh, v.shape,
                         ("batch",) + (None,) * (len(v.shape) - 1))
            for k, v in batch_spec.items()}


def cache_shardings(mesh, cache_spec: Any, cfg) -> Any:
    """KV/SSM cache shardings: (layers, batch, seq, heads...) with batch
    over data and heads (or cache_seq) over model.  ``cache_spec``: nested
    dicts of anything with a ``shape`` (``init_cache(..., device="meta")``
    gives one)."""
    rules = arch_rules(cfg, kind="decode")

    def leaf(sd):
        if sd is None:
            return None
        shape = tuple(sd.shape)
        if len(shape) <= 1:                       # e.g. cache["len"]
            return Sharding(mesh, ())
        axes: list = [None] * len(shape)
        axes[0] = "layers"
        axes[1] = "batch"
        if len(shape) == 5:                       # (L, B, S, Hkv, hd)
            axes[2] = "cache_seq"
            axes[3] = "kv_heads"
        elif len(shape) == 4:                     # (L, B, S, r) or ssm
            axes[2] = "cache_seq"
            axes[3] = "ssm"
        elif len(shape) == 3:
            axes[2] = "ffn"
        return _sharding(mesh, shape, axes, rules=rules)

    return tree_map(leaf, cache_spec)


def train_state_shardings(state, param_sh: dict, opt_sh: dict):
    """The shardings of a train state's structure: ``param_sh`` for its
    parameters (the reference's layout, as a module takes it) and each
    optimizer leaf's entry of ``opt_sh`` under the port's leaf name — the
    ``shardings`` a checkpoint restore of ``state`` takes."""
    return dataclasses.replace(
        state, params=param_sh, step=None,
        opt={name: PM.sharding_of(opt_sh, name) for name in state.opt})


def place_train_state(state, param_sh: dict, opt_sh: dict):
    """Put a train state's parameters onto ``param_sh`` and its optimizer
    state onto ``opt_sh`` (trees of ``param_shardings`` / ``opt_shardings``)
    as ``DTensor``s, in place; returns ``state``."""
    PM.place_params(state.params, param_sh)
    shs = train_state_shardings(state, param_sh, opt_sh).opt
    state.opt = {name: {k: shs[name][k].place(v) for k, v in st.items()}
                 for name, st in state.opt.items()}
    return state
