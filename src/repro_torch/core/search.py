"""Monotone branch-and-bound searches over the Eq.1 knob lattice.

Pareto queries (``plan_min_chips``, ``plan_max_concurrency``, the
chips -> max-batch frontier) can be answered by brute-force enumeration:
sweep the full knob cross-product, then reduce.  The byte terms have
exploitable structure —

* **statics floor**: every param / grad / optimizer-state byte lives in
  exactly one pipeline stage and is sharded by at most ``N / pp``
  within it, so the peak stage of ANY cell on ``N`` chips satisfies
  ``peak >= total_static_bytes // N`` (max >= mean over stages).  A chip
  count whose floor already exceeds the budget cannot contain a fitting
  cell and its whole slice is pruned without evaluation;
* **aligned-ladder monotonicity**: at a fixed mesh, every
  global-batch-bearing term is ``(gb-monotone numerator) // denom``
  where the denominator depends on gb only through divisibility.  At
  ``gb`` aligned to ``L`` = the product of the mesh's non-pipe axis
  sizes, every divisibility check a gb-derived dim can ever pass
  passes, so denominators are maximal and
  ``peak(gb) >= peak(L * (gb // L))`` for all gb, while peak is
  monotone *along* the multiples of L.  Binary search over the ladder
  brackets the answer into one L-window, which a descending scan
  resolves exactly — O(log(cap) + L) evaluations instead of O(cap),
  and exact for sharded-batch meshes where a naive binary search over
  raw integers is NOT sound.

Both bounds are invariants, not heuristics: the searches return answers
*identical* to exhaustive enumeration (same cell, same tie-breaking),
cross-checked by the ``oracle=True`` mode which runs the brute-force
reduction next to the pruned one and asserts equality
(tests/test_torch_search.py holds every answer to the reference
package's too).

Both bounds survive the liveness assembly (``grid.assembly ==
"liveness"``) unchanged: its peak is the max running-sum prefix of the
alloc/free event program, and the FIRST prefix already holds the
stage's persistent base (params + grads + optimizer states), so
``liveness peak >= per-stage statics`` and the ``floor // n`` bound
still under-approximates every cell (out-copy bytes are excluded from
the floor, so the base alone covers it).  For the ladder, every prefix
is a sub-sum of gb-aligned-monotone terms and a max of monotone
functions is monotone, so ``monotone_max`` stays exact.

The sliced sweeps run on ``compute_engine="torch"`` (default; the
columnar engine of :mod:`repro_torch.core.batch_torch` on ``device``,
``"cuda"`` when None: every slice is one cold table build, one
``shard_factor`` launch per pipeline stage, and a read-back) or on
``compute_engine="numpy"``, the host columnar path.  Calibration
profiles, under which the reference disables the floor, are not ported
yet (the sweep rejects them).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace

__all__ = [
    "SearchStats", "static_floor_bytes", "min_chips_search",
    "frontier_search", "monotone_max", "batch_align",
]


@dataclass
class SearchStats:
    """Work accounting for one pruned search (aggregated across queries
    when shared).  ``cells_evaluated + cells_pruned`` equals the cell
    count exhaustive enumeration would have paid for the same query."""

    cells_evaluated: int = 0     # cells actually swept
    cells_pruned: int = 0        # cells skipped via bounds / early exit
    probes: int = 0              # scalar report() evaluations
    bound_evals: int = 0         # statics-floor bound computations
    notes: list = field(default_factory=list)

    @property
    def total_cells(self) -> int:
        return self.cells_evaluated + self.cells_pruned

    @property
    def reduction(self) -> float:
        """Exhaustive-cells / evaluated-cells ratio (inf when the whole
        domain was pruned)."""
        work = self.cells_evaluated + self.probes
        if work == 0:
            return float("inf")
        return self.total_cells / work

    def merge(self, other: "SearchStats") -> None:
        self.cells_evaluated += other.cells_evaluated
        self.cells_pruned += other.cells_pruned
        self.probes += other.probes
        self.bound_evals += other.bound_evals
        self.notes.extend(other.notes)


# ---------------------------------------------------------------------------
# statics floor
# ---------------------------------------------------------------------------


#: lower bound on ``PredictContext.eff_grad_bytes``: bf16 grads when no
#: accumulation splits the step, fp32 accumulators otherwise — min(2, 4)
_GRAD_FLOOR_BYTES = 2


@functools.lru_cache(maxsize=None)
def _parsed_rows(arch: str, policy) -> tuple:
    from repro_torch.configs import get_config
    from repro_torch.core.parser import parse_model
    from repro_torch.core.sweep import normalize_arch
    from repro_torch.models import build_model

    return tuple(parse_model(
        build_model(get_config(normalize_arch(arch))).spec, policy))


@functools.lru_cache(maxsize=None)
def static_floor_bytes(arch: str, policy, kind: str = "train",
                       optimizer: str = None,
                       include_opt: bool = True) -> int:
    """Model-total static residency (params + grads + optimizer states)
    under ``policy`` dtypes — a sound lower bound on the summed
    per-stage statics of ANY cell: activations/transients only add,
    sharding divides the sum by at most the chip count (each byte lives
    on exactly one pipeline stage's shards; replication only grows the
    per-chip share), so peak-stage >= mean-stage gives
    ``peak >= this // n_chips`` (tested against full sweeps in
    tests/test_torch_search.py).

    Per factor:

    * params — exact (``factors.param_factor`` numerator);
    * grads  — ``_GRAD_FLOOR_BYTES`` per trainable element, the min of
      the two ``eff_grad_bytes`` branches (train kinds only);
    * opt    — exact ``factors.opt_bytes_for`` under the resolved
      optimizer (``None`` -> the arch default) and the deterministic
      ``master_fp32 = opt != "adafactor"`` rule from
      ``planner.make_context``; dropped when ``include_opt`` is False
      (grids whose offload axis can move these states off-device).
    """
    from repro_torch.configs import get_config
    from repro_torch.core.factors import _stacked, opt_bytes_for
    from repro_torch.core.sweep import normalize_arch

    rows = _parsed_rows(arch, policy)
    total = sum(p.nbytes * row.repeat
                for row in rows for p in row.layer.params.values())
    if kind != "train":
        return total                      # serve kinds: params only
    opt = optimizer or get_config(normalize_arch(arch)).optimizer
    for row in rows:
        if not row.trainable:
            continue
        rep = 1 if row.scanned else row.repeat
        for p in row.layer.params.values():
            total += p.size * row.repeat * _GRAD_FLOOR_BYTES
            if include_opt:
                total += opt_bytes_for(p, _stacked(p, row)[0], opt,
                                       opt != "adafactor") * rep
    return total


def _floor_for(grid) -> int:
    """The statics floor valid for EVERY cell of the grid: the min over
    its arch / kind / optimizer axes.  Optimizer states are included only
    when no cell can offload them to the host tier.  (Under a calibration
    profile the reference returns 0 — no pruning — since fitted
    coefficients could scale raw bytes down; the port's sweeps reject
    profiles until calibration is ported.)"""
    from repro_torch.core.sweep import _seq

    include_opt = True not in grid.offloads()
    opts = tuple(_seq(grid.optimizers)) or (None,)
    return min(static_floor_bytes(a, grid.policy, kind=k, optimizer=o,
                                  include_opt=include_opt)
               for a in _seq(grid.arch)
               for k in _seq(grid.kind)
               for o in opts)


def _budgets(grid) -> dict:
    from repro_torch.core import planner as PL
    from repro_torch.core.sweep import _seq

    return {c: int(PL.chip_hbm(c) * grid.headroom) for c in _seq(grid.chip)}


def _by_count(grid) -> dict:
    """Grid meshes grouped by chip count, insertion order preserved
    within each count (the tie-break order of the flat grid)."""
    from repro_torch.launch.mesh import mesh_chips

    by_n: dict[int, list] = {}
    for m in grid.meshes():
        by_n.setdefault(mesh_chips(m), []).append(m)
    return by_n


def _slice(grid, meshes, **over):
    return replace(grid, chips=None, mesh_shapes=list(meshes), **over)


# ---------------------------------------------------------------------------
# min-chips search
# ---------------------------------------------------------------------------


def min_chips_search(grid, engine=None, stats: SearchStats = None,
                     oracle: bool = False, compute_engine: str = "torch",
                     device=None):
    """Pruned twin of ``engine.sweep(grid).min_chips()``.

    Chip counts ascend; a count is swept only if the statics floor fits
    at least one chip type's budget (chip types it exceeds are dropped
    from the slice — their cells are provably non-fitting), and the
    search stops at the first count with a fitting cell.  The winning
    cell — including the (peak, index-order) tie-break — is identical
    to the exhaustive reduction: within one count the slice preserves
    the flat grid's relative cell order, and across counts the
    exhaustive primary key IS the chip count.
    """
    from repro_torch.core import sweep as SW

    engine = engine or SW.SweepEngine()
    stats = stats if stats is not None else SearchStats()
    floor = _floor_for(grid)
    budgets = _budgets(grid)
    by_n = _by_count(grid)
    stats.bound_evals += len(by_n)
    best = None
    for n in sorted(by_n):
        meshes = by_n[n]
        chips_ok = tuple(c for c, b in budgets.items()
                         if floor // n <= b) or ()
        full = _slice(grid, meshes).size()
        if best is not None or not chips_ok:
            stats.cells_pruned += full
            continue
        sl = _slice(grid, meshes, chip=chips_ok)
        res = engine.sweep(sl, engine=compute_engine, device=device)
        stats.cells_evaluated += len(res)
        stats.cells_pruned += full - len(res)
        best = res.min_chips()
        # keep looping only to account remaining pruned cells
    if oracle:
        ref = engine.sweep(grid, engine=compute_engine,
                           device=device).min_chips()
        _assert_same_cell(best, ref, "min_chips")
    return best


def _assert_same_cell(got, ref, what: str) -> None:
    if (got is None) != (ref is None):
        raise AssertionError(f"{what}: pruned={got!r} exhaustive={ref!r}")
    if got is None:
        return
    for f in ("arch", "chip", "n_chips", "mesh_shape", "optimizer",
              "remat", "schedule", "microbatches", "grad_accum",
              "global_batch", "seq_len", "peak_bytes", "fits"):
        g, r = getattr(got, f, None), getattr(ref, f, None)
        if g != r:
            raise AssertionError(
                f"{what}: pruned.{f}={g!r} != exhaustive.{f}={r!r}")


# ---------------------------------------------------------------------------
# frontier search
# ---------------------------------------------------------------------------


def frontier_search(grid, engine=None, stats: SearchStats = None,
                    oracle: bool = False, compute_engine: str = "torch",
                    device=None) -> list:
    """Pruned twin of ``engine.sweep(grid).frontier()``: per chip count,
    scan the global-batch axis DESCENDING and stop at the first batch
    with a fitting cell — exact regardless of batch monotonicity (the
    scan only skips batches *below* a found maximum), with
    statics-floor pruning of hopeless chip counts."""
    from repro_torch.core import sweep as SW
    from repro_torch.core.sweep import _seq

    engine = engine or SW.SweepEngine()
    stats = stats if stats is not None else SearchStats()
    floor = _floor_for(grid)
    budgets = _budgets(grid)
    by_n = _by_count(grid)
    stats.bound_evals += len(by_n)
    gbs = sorted(set(int(g) for g in _seq(grid.global_batches)),
                 reverse=True)
    out = []
    for n in sorted(by_n):
        meshes = by_n[n]
        chips_ok = tuple(c for c, b in budgets.items() if floor // n <= b)
        if not chips_ok:
            stats.cells_pruned += _slice(grid, meshes).size()
            continue
        found = False
        for gb in gbs:
            full = _slice(grid, meshes, global_batches=(gb,)).size()
            if found:
                stats.cells_pruned += full
                continue
            sl = _slice(grid, meshes, chip=chips_ok,
                        global_batches=(gb,))
            res = engine.sweep(sl, engine=compute_engine, device=device)
            stats.cells_evaluated += len(res)
            stats.cells_pruned += full - len(res)
            if res.fit_count:
                out.append((n, gb))
                found = True
        # chip types dropped by the floor hold no fitting cells, so the
        # per-count max over the kept types equals the full grid's
    if oracle:
        ref = engine.sweep(grid, engine=compute_engine,
                           device=device).frontier()
        if out != ref:
            raise AssertionError(
                f"frontier: pruned={out!r} != exhaustive={ref!r}")
    return out


# ---------------------------------------------------------------------------
# aligned-ladder concurrency search
# ---------------------------------------------------------------------------


def batch_align(mesh_shape: dict) -> int:
    """The batch-ladder alignment of a mesh: the product of its non-pipe
    axis sizes.  At global batches that are multiples of this, every
    divisibility check a batch-derived dim can ever pass passes (each
    mesh axis is used at most once per dim, so any applied shard
    product divides it), making the denominators maximal and the peak
    monotone along the ladder."""
    from repro_torch.mesh_ctx import PIPE_AXIS

    out = 1
    for a, v in (mesh_shape or {}).items():
        if a != PIPE_AXIS:
            out *= max(int(v), 1)
    return out


def monotone_max(fits, cap: int, align: int = 1,
                 stats: SearchStats = None) -> int:
    """Largest ``x`` in [1, cap] with ``fits(x)``, where ``fits`` is
    monotone non-increasing along multiples of ``align`` and bounded by
    its aligned floor (``fits(x)`` implies ``fits(align * (x //
    align))``) — the aligned-ladder structure of the Eq.1 batch terms.
    With ``align == 1`` this is plain galloping + binary search.
    Returns 0 when nothing fits."""
    if cap < 1:
        return 0
    stats = stats if stats is not None else SearchStats()
    L = max(int(align), 1)

    def probe(x: int) -> bool:
        stats.probes += 1
        return bool(fits(x))

    def scan_desc(hi: int, lo: int) -> int:
        """First fitting value scanning hi..lo+1, else 0."""
        for x in range(hi, lo, -1):
            if probe(x):
                return x
        return 0

    if L > cap or not probe(L):
        # no aligned point fits => nothing >= L fits (aligned-floor
        # bound); resolve [1, min(L, cap+1)) exhaustively
        return scan_desc(min(L - 1, cap), 0)
    kmax = cap // L
    k = 1
    while 2 * k <= kmax and probe(2 * k * L):
        k *= 2
    lo_k, hi_k = k, min(2 * k, kmax)
    while lo_k < hi_k:                       # max fitting multiple
        mid = (lo_k + hi_k + 1) // 2
        if probe(mid * L):
            lo_k = mid
        else:
            hi_k = mid - 1
    base = lo_k * L
    # anything >= (lo_k+1)*L is ruled out (its aligned floor failed, or
    # it is beyond cap); the window (base, min((lo_k+1)*L - 1, cap)]
    # is scanned exhaustively
    top = min((lo_k + 1) * L - 1, cap)
    hit = scan_desc(top, base)
    return hit or base


def max_concurrency_search(peak, budget: int, cap: int,
                           mesh_shape: dict = None,
                           stats: SearchStats = None) -> int:
    """Largest concurrency whose ``peak(gb) <= budget`` — the engine of
    :func:`repro_torch.core.planner.plan_max_concurrency`, exact for
    batch-sharded meshes via the aligned ladder."""
    return monotone_max(lambda gb: peak(gb) <= budget, cap,
                        align=batch_align(mesh_shape or {}), stats=stats)
