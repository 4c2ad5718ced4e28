"""Mesh enumeration and the per-arch sharding rule policy.

The pure helpers of the launch layer: every way to lay ``n_chips`` out over
named mesh axes, the parallel degrees of a mesh-shape dict, and the
per-arch logical->physical rule overrides the memory predictor resolves
shard factors through.  Device-mesh constructors arrive with the runnable
model zoo.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.mesh_ctx import (CONTEXT_AXIS, DEFAULT_RULES, EXPERT_AXIS,
                                  PIPE_AXIS)


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
