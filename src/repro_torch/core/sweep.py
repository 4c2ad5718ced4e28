"""Capacity-planning sweep engine: the full knob space at once.

The paper's estimator answers "will this config OOM?" for ONE cell;
capacity planning (xMem-style scheduler admission, cluster sizing) needs
that answer for 10^5-10^6 candidate configurations at once: every mesh
factorization of a chip count (including the ``pipe`` pipeline axis) x
optimizer x remat policy x pipeline schedule x microbatch count x
grad-accum x global batch x sequence length x chip type.
``sweep(SweepGrid(...))`` evaluates such a grid through a
:class:`SweepEngine`:

* ``mode="columnar"`` (default) lowers the whole grid to structure-of-
  arrays form — the Eq.1 terms are factored into cell-independent
  coefficient tables contracted against int64 knob columns.  Two compute
  engines share the host table build of :mod:`repro_torch.core.batch`:
  ``engine="torch"`` (default) composes the tables on a CUDA device in
  :mod:`repro_torch.core.batch_torch`, with the shard denominators and the
  liveness prefix-max going through the hand-written CUDA kernels in
  :mod:`repro_torch.kernels`; ``engine="numpy"`` is the host columnar path;
* ``mode="cell"`` is the per-cell reference: parses/builds each
  architecture once, memoizes the three ``core.predictor`` component
  groups by exactly the context fields each reads, and composes cells
  through the same ``assemble`` a cell-by-cell ``planner.check`` uses.

All paths are byte-identical — every verdict and every peak-bytes value
(asserted against the reference package in tests/test_torch_sweep.py).

The torch engine runs on ``device="cuda"`` unless the caller asks for
``device="cpu"``, and raises when no CUDA device is present rather than
quietly computing on the host.

Results are wrapped in a :class:`SweepResults` container with
Pareto-frontier queries ("max global batch that fits on N chips", "min
chips for this shape") and markdown/CSV report writers built on
:mod:`repro_torch.core.report`; columnar sweeps answer the queries on arrays
and materialize :class:`SweepResult` rows lazily.

Every registered architecture sweeps, over any of the ``data``, ``model``,
``expert``, ``context`` and ``pipe`` mesh axes; an illegal expert/context
layout is rejected up front by ``planner.check_parallel``.  Grids with
``keep_predictions=True`` take the per-cell path of the numpy engine, which
keeps each cell's ``PredictedMemory``; the torch engine refuses them.

A :class:`~repro_torch.calibrate.profile.CalibrationProfile` scales every
cell on every path (the torch engine folds it into its tables on the host,
in float64, and adds the per-chip offset after the stage max).  A learned
residual model (:mod:`repro_torch.calibrate.learned`) is applied per cell,
so its grids take the cell path of the numpy engine; the torch engine
refuses them.  Serving grids sweep request mixes
(:class:`repro_torch.serve.fleet.RequestMix`) and speculative-decode draft
arches.

CLI::

    PYTHONPATH=src python -m repro_torch.core.sweep --arch llava15_7b --chips 8 \
        --chip h100 --batch 16,32,64,128 --accum 1,2,4 --seq-len 2048
    PYTHONPATH=src python -m repro_torch.core.sweep --arch llama3_1_8b \
        --chips 64 --mesh-axes data,model,pipe --max-pipe 4 \
        --schedule 1f1b,gpipe --microbatches 1,4,8 --batch 64 --seq-len 4096
    PYTHONPATH=src python -m repro_torch.core.sweep \
        --arch deepseek_v2_lite_16b --chips 64 \
        --mesh-axes data,model,expert,context,pipe \
        --max-expert 8 --max-context 4 --max-pipe 4 --batch 64 \
        --seq-len 4096

``--device cpu`` runs the torch engine on the host; ``--engine numpy``
selects the host columnar path; ``--dry-run`` prints the per-knob
cardinality table and the estimated runtime (a rate measured into
``BENCH_sweep.json``, else a planning estimate) and touches no device;
``--mode cell`` selects the reference path; an
empty grid exits with status 2 and a "0 cells matched" explanation.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Union

from repro_torch.core import planner as PL
from repro_torch.core import predictor as PR
from repro_torch.core import report as RPT
from repro_torch.core.parser import parse_model
from repro_torch.core.spec import (FULL_TRAIN, LLAVA_STAGE1, LLAVA_STAGE2,
                                   TrainPolicy)

GiB = 1024 ** 3

POLICIES: dict[str, TrainPolicy] = {
    "full": FULL_TRAIN,
    "llava_stage1": LLAVA_STAGE1,
    "llava_stage2": LLAVA_STAGE2,
}


def normalize_arch(name: str) -> str:
    """Accept module-ish spellings ("llava15_7b") for registered archs."""
    from repro_torch.configs import registered_archs
    known = registered_archs()
    if name in known:
        return name
    canon = lambda s: re.sub(r"[^a-z0-9]", "", s.lower())
    matches = [a for a in known if canon(a) == canon(name)]
    if len(matches) == 1:
        return matches[0]
    raise KeyError(f"unknown arch {name!r}; known: {known}")


# ---------------------------------------------------------------------------
# grid + result data model
# ---------------------------------------------------------------------------


def _seq(x) -> tuple:
    if x is None:
        return (None,)
    if isinstance(x, (str, int, float, dict)):
        return (x,)
    return tuple(x)


@dataclass
class SweepGrid:
    """The knob space of one sweep.  Every list-valued field is a grid
    axis; ``None`` entries mean "the architecture's default"."""

    arch: Union[str, Sequence[str]] = "llava15-7b"
    # mesh axes: either explicit mesh_shapes, or a chip count (chips) whose
    # factorizations over mesh_axes are enumerated via launch.mesh
    chips: Union[int, Sequence[int], None] = None
    mesh_axes: tuple[str, ...] = ("data", "model")
    mesh_shapes: Optional[Sequence[dict]] = None
    max_axis: Optional[dict] = None        # e.g. {"model": 16} ICI cap
    chip: Union[str, Sequence[str]] = "v5e"
    optimizers: Sequence[Optional[str]] = (None,)
    remats: Sequence[Optional[str]] = (None,)
    # pipeline-parallel knobs: the pipeline DEGREE comes from each mesh's
    # `pipe` axis (put "pipe" in mesh_axes or in explicit mesh_shapes);
    # these set how the batch fills it.  Inert on pipe-less meshes.
    schedules: Sequence[str] = ("1f1b",)
    microbatches: Sequence[int] = (1,)
    grad_accums: Sequence[int] = (1,)
    global_batches: Sequence[int] = (256,)
    seq_lens: Sequence[int] = (4096,)
    kind: str = "train"
    policy: TrainPolicy = FULL_TRAIN
    backend: str = "tpu"
    headroom: float = PL.HEADROOM
    keep_predictions: bool = False
    # measurement-fitted CalibrationProfile (repro_torch.calibrate) applied
    # to every cell; its hash participates in the engine's memo keys
    profile: object = None
    # learned per-family ResidualModel (repro_torch.calibrate.learned)
    # applied on top of the profile; its model_hash joins the memo keys the
    # same way.  None keeps every cell bit-identical to the profile-only
    # path.
    residual_model: object = None
    # serving-fleet knobs (serve kinds only; the all-neutral combo is
    # normalized to serve=None so it stays bit-identical to a pre-serve
    # cell): paged-KV block sizes (0 = contiguous), pool utilizations,
    # prefix-cache hit rates over a shared prefix_len-token prefix,
    # request mixes (repro_torch.serve.fleet.RequestMix or None), and
    # speculative-decode draft arches ("" = none).
    block_sizes: Sequence[int] = (0,)
    utilizations: Sequence[float] = (1.0,)
    prefix_hit_rates: Sequence[float] = (0.0,)
    prefix_len: int = 0
    mixes: Sequence = (None,)
    draft_archs: Sequence[str] = ("",)
    # Eq.1 offload-tier knob (train kinds only): False = optimizer states
    # resident in HBM, True = host-offloaded with only the
    # factors.offload_staged_bytes streaming window on device.
    offload_optimizer: Sequence[bool] = (False,)
    # peak assembly mode (core.liveness): "legacy" = Eq.1 sum-of-maxima
    # (default, bit-identical to every golden); "liveness" = the
    # interval-overlap peak from the alloc/free event program.  Not a
    # grid axis — one mode per sweep, and it joins the engine memo keys.
    assembly: str = "legacy"

    def offloads(self) -> tuple:
        """The offload axis, normalized to a bool tuple."""
        return tuple(bool(o) for o in _seq(self.offload_optimizer))

    def meshes(self) -> list[dict]:
        from repro_torch.launch.mesh import enumerate_meshes
        if self.mesh_shapes is not None:
            return [dict(m) for m in self.mesh_shapes]
        if self.chips is None:
            raise ValueError("SweepGrid needs `chips` or `mesh_shapes`")
        out = []
        for n in _seq(self.chips):
            out.extend(enumerate_meshes(int(n), self.mesh_axes,
                                        self.max_axis))
        return out

    def serve_specs(self) -> tuple:
        """The serve axis: one Optional[ServeSpec] per combination of the
        serving-fleet knob lists, in deterministic cross-product order.
        The all-neutral combination maps to ``None`` (no serve spec), so
        a default grid has a single-element ``(None,)`` axis and every
        cell is bit-identical to a pre-serve sweep."""
        from repro_torch.serve.fleet import RequestMix
        from repro_torch.serve.pool import ServeSpec
        mixes = self.mixes if isinstance(self.mixes, (tuple, list)) \
            else (self.mixes,)
        mixes = tuple(mixes) or (None,)
        out = []
        for b in _seq(self.block_sizes):
            for u in _seq(self.utilizations):
                for h in _seq(self.prefix_hit_rates):
                    for m in mixes:
                        if m is not None and not isinstance(m, RequestMix):
                            raise ValueError(
                                f"mixes entries must be RequestMix or "
                                f"None, got {m!r}")
                        for d in _seq(self.draft_archs):
                            spec = ServeSpec.make(
                                block_size=int(b or 0),
                                utilization=float(u),
                                prefix_hit_rate=float(h),
                                prefix_len=int(self.prefix_len),
                                mix=m, draft_arch=str(d or ""))
                            out.append(None if spec.is_neutral else spec)
        return tuple(out)

    def size(self) -> int:
        """Cheap cell cardinality: exactly ``sum(1 for _ in cells())``
        without yielding a single cell object — guard rails for CLI users
        about to launch a million-cell sweep (see ``--dry-run``)."""
        pairs = sum(1 for a in _seq(self.grad_accums)
                    for g in _seq(self.global_batches) if not g % a)
        return (len(_seq(self.arch)) * len(_seq(self.chip))
                * len(self.meshes()) * len(_seq(self.optimizers))
                * len(self.offloads())
                * len(_seq(self.remats)) * len(_seq(self.schedules))
                * len(_seq(self.microbatches)) * len(self.serve_specs())
                * pairs * len(_seq(self.seq_lens)))

    def check_schedules(self) -> tuple:
        """Validate the schedule axis up front — the columnar path never
        builds per-cell PredictContexts, so it would otherwise treat an
        unknown schedule as 1F1B silently."""
        from repro_torch.core.stages import SCHEDULES
        scheds = _seq(self.schedules)
        bad = [s for s in scheds if s not in SCHEDULES]
        if bad:
            raise ValueError(
                f"unknown schedule(s) {bad}; known: {SCHEDULES}")
        return scheds

    def check_parallel(self) -> None:
        """Validate the expert/context mesh axes against every
        (arch, mesh, seq) combo up front, through the SAME
        ``planner.check_parallel`` gate the per-cell path hits in
        ``make_context`` — so both sweep modes and the CLI reject an
        invalid grid with one clean ValueError instead of a traceback
        (or, columnar-side, a silent misprediction)."""
        from repro_torch.configs import get_config
        meshes = self.meshes()
        if not any(m.get("expert", 1) > 1 or m.get("context", 1) > 1
                   for m in meshes):
            return
        for arch in _seq(self.arch):
            cfg = get_config(normalize_arch(arch))
            for mesh in meshes:
                for seq in _seq(self.seq_lens):
                    PL.check_parallel(cfg, mesh, self.kind, int(seq))

    def check_serve(self) -> None:
        """Validate the serving-fleet knob axes up front through the SAME
        ``planner.check_serve`` gate the per-cell path hits in
        ``make_context`` — both sweep modes and the CLI reject an
        invalid serve grid with one clean ValueError.  Range errors
        (hit rate outside [0,1] etc.) surface from ServeSpec
        construction inside ``serve_specs()`` itself."""
        from repro_torch.configs import get_config
        specs = self.serve_specs()
        if all(s is None for s in specs):
            return
        for arch in _seq(self.arch):
            cfg = get_config(normalize_arch(arch))
            for spec in specs:
                PL.check_serve(cfg, spec, self.kind)

    def check_offload(self) -> None:
        """Validate the optimizer-offload axis up front through the SAME
        ``planner.check_offload`` gate the per-cell path hits in
        ``make_context`` — both sweep modes and the CLI reject offload
        on a serve kind with one clean ValueError."""
        for off in self.offloads():
            PL.check_offload(self.kind, off)

    def check_assembly(self) -> None:
        """Validate the assembly mode up front (the columnar path would
        otherwise fall back to legacy composition silently)."""
        from repro_torch.core.liveness import ASSEMBLIES
        if self.assembly not in ASSEMBLIES:
            raise ValueError(f"unknown assembly {self.assembly!r}; "
                             f"known: {ASSEMBLIES}")

    def cells(self) -> Iterator["SweepCell"]:
        """Deterministic cell enumeration (first-fit order: cheap knobs
        vary fastest)."""
        self.check_schedules()
        self.check_parallel()
        self.check_serve()
        self.check_offload()
        self.check_assembly()
        meshes = self.meshes()
        serves = self.serve_specs()
        offs = self.offloads()
        for arch in _seq(self.arch):
            arch = normalize_arch(arch)
            for chip in _seq(self.chip):
                for mesh in meshes:
                    for opt in _seq(self.optimizers):
                        for off in offs:
                            for remat in _seq(self.remats):
                                for sched in _seq(self.schedules):
                                    for mb in _seq(self.microbatches):
                                        for srv in serves:
                                            yield from self._inner_cells(
                                                arch, chip, mesh, opt,
                                                off, remat, sched,
                                                int(mb), srv)

    def _inner_cells(self, arch, chip, mesh, opt, off, remat, sched,
                     mb, srv=None) -> Iterator["SweepCell"]:
        for accum in _seq(self.grad_accums):
            for gb in _seq(self.global_batches):
                if gb % accum:
                    continue
                for seq in _seq(self.seq_lens):
                    yield SweepCell(
                        arch=arch, chip=chip,
                        mesh=tuple(sorted(mesh.items())),
                        optimizer=opt, remat=remat,
                        schedule=sched, microbatches=mb,
                        grad_accum=int(accum), global_batch=int(gb),
                        seq_len=int(seq), kind=self.kind,
                        backend=self.backend, serve=srv,
                        offload=bool(off))


@dataclass(frozen=True)
class SweepCell:
    """One point of the grid (hashable; mesh stored as sorted items)."""

    arch: str
    chip: str
    mesh: tuple                    # (("data", 8), ("model", 2))
    optimizer: Optional[str]
    remat: Optional[str]
    grad_accum: int
    global_batch: int
    seq_len: int
    kind: str
    backend: str
    schedule: str = "1f1b"
    microbatches: int = 1
    # Optional repro_torch.serve.pool.ServeSpec (frozen/hashable); None when
    # every serving-fleet knob is neutral
    serve: Optional[object] = None
    # Eq.1 offload-tier knob: host-offloaded optimizer states
    offload: bool = False

    @property
    def mesh_shape(self) -> dict:
        return dict(self.mesh)

    @property
    def n_chips(self) -> int:
        from repro_torch.launch.mesh import mesh_chips
        return mesh_chips(self.mesh_shape)


@dataclass
class SweepResult:
    """Verdict for one cell: the knobs, the predicted peak, fit/OOM."""

    arch: str
    chip: str
    mesh_shape: dict
    n_chips: int
    optimizer: str                 # resolved (never None)
    remat: str                     # resolved
    grad_accum: int
    global_batch: int
    seq_len: int
    kind: str
    backend: str
    peak_bytes: int
    budget_bytes: int
    fits: bool
    schedule: str = "1f1b"
    microbatches: int = 1
    # serving-fleet provenance: the cell's ServeSpec (None when neutral)
    # and the peak stage's pool / draft / hit-savings bytes (all 0 when
    # serve is None)
    serve: Optional[object] = None
    pool_bytes: int = 0
    draft_bytes: int = 0
    hit_saved_bytes: int = 0
    # Eq.1 offload tier: knob + the peak stage's host-DRAM residency
    # (informational, outside the device peak)
    offload: bool = False
    offload_bytes: int = 0
    # liveness assembly: how much the legacy sum-of-maxima overstated the
    # winning stage's peak (0 on the legacy path; peak_bytes above is
    # already net of it)
    overlap_slack_bytes: int = 0
    prediction: Optional[PR.PredictedMemory] = None

    @property
    def micro_batch(self) -> int:
        return max(self.global_batch // max(self.grad_accum, 1), 1)

    @property
    def pp(self) -> int:
        from repro_torch.launch.mesh import pp_degree
        return pp_degree(self.mesh_shape)

    @property
    def ep(self) -> int:
        from repro_torch.launch.mesh import ep_degree
        return ep_degree(self.mesh_shape)

    @property
    def cp(self) -> int:
        from repro_torch.launch.mesh import cp_degree
        return cp_degree(self.mesh_shape)

    @property
    def mesh_str(self) -> str:
        return "x".join(f"{k}={v}" for k, v in sorted(
            self.mesh_shape.items()))

    def __str__(self) -> str:
        verdict = "FITS" if self.fits else "OOM "
        pipe = (f" sched {self.schedule} micro {self.microbatches}"
                if self.pp > 1 else "")
        return (f"[{verdict}] {self.arch} {self.kind} on {self.n_chips}x"
                f"{self.chip} ({self.mesh_str}): batch {self.global_batch}"
                f" seq {self.seq_len} opt {self.optimizer} remat "
                f"{self.remat} accum {self.grad_accum}{pipe} -> peak "
                f"{self.peak_bytes / GiB:.2f} GiB vs "
                f"{self.budget_bytes / GiB:.2f} GiB")


_COLUMNS = ("arch", "chip", "mesh", "optimizer", "remat", "sched",
            "micro", "accum", "batch", "seq", "peak_gib", "budget_gib",
            "fits")

# serve columns appended when the grid has any active serving-fleet knob
# (the writers would otherwise silently drop the new SweepResult fields):
# per-sequence block count, pool/prefix-savings/draft bytes in GiB.
_SERVE_COLUMNS = ("block", "blocks_per_seq", "hit", "pool_gib",
                  "hit_saved_gib", "draft_gib")

# offload columns appended when the grid sweeps the offload knob: the
# per-cell knob value + the host-DRAM optimizer residency in GiB.
_OFFLOAD_COLUMNS = ("offload", "host_opt_gib")

# liveness column appended when the grid's assembly is "liveness": the
# legacy-minus-liveness overestimate of the winning stage, in GiB.
_LIVENESS_COLUMNS = ("ovl_slack_gib",)


def _row_of(r: SweepResult) -> tuple:
    return (r.arch, r.chip, r.mesh_str, r.optimizer, r.remat,
            r.schedule, r.microbatches,
            r.grad_accum, r.global_batch, r.seq_len,
            f"{r.peak_bytes / GiB:.3f}", f"{r.budget_bytes / GiB:.3f}",
            "yes" if r.fits else "NO")


def _serve_row_of(r: SweepResult) -> tuple:
    from repro_torch.serve.pool import pool_blocks
    s = r.serve
    return (s.block_size if s else 0,
            pool_blocks(r.seq_len, s),
            f"{(s.hit_bp if s else 0) / 10000:.2f}",
            f"{r.pool_bytes / GiB:.3f}",
            f"{r.hit_saved_bytes / GiB:.3f}",
            f"{r.draft_bytes / GiB:.3f}")


def _offload_row_of(r: SweepResult) -> tuple:
    return ("yes" if r.offload else "no",
            f"{r.offload_bytes / GiB:.3f}")


def _liveness_row_of(r: SweepResult) -> tuple:
    return (f"{r.overlap_slack_bytes / GiB:.3f}",)


class SweepResults:
    """Structured sweep output + Pareto-frontier queries.

    Two backing stores, one API:

    * cell mode hands in a materialized ``results`` list;
    * columnar mode (``core.batch``) hands in ``columns`` — int64 arrays
      for the whole grid.  Rows are then materialized LAZILY: Pareto
      queries (``fitting`` counts, ``max_global_batch``, ``min_chips``,
      ``frontier``) and the report sort run on the arrays and only the
      rows actually returned become :class:`SweepResult` objects, so a
      500k-cell sweep answers "max batch on 256 chips" without building
      500k Python objects.  Query results are identical between the two
      stores (including tie-breaking order); asserted in tests.
    """

    def __init__(self, grid: SweepGrid, results: Optional[list] = None,
                 elapsed_s: float = 0.0, columns=None):
        self.grid = grid
        self.elapsed_s = elapsed_s
        self.columns = columns
        self._results: Optional[list[SweepResult]] = \
            list(results) if results is not None else None
        if self._results is None and columns is None:
            self._results = []

    @property
    def results(self) -> list[SweepResult]:
        """All rows, materializing (and caching) them when columnar."""
        if self._results is None:
            c = self.columns
            self._results = [c.result(i) for i in range(c.n)]
        return self._results

    def __len__(self) -> int:
        if self._results is None:
            return self.columns.n
        return len(self._results)

    def __iter__(self) -> Iterator[SweepResult]:
        return iter(self.results)

    @property
    def cells_per_sec(self) -> float:
        return len(self) / self.elapsed_s if self.elapsed_s else 0.0

    # -- fit queries ---------------------------------------------------------
    @property
    def fit_count(self) -> int:
        """Number of fitting cells (no row materialization)."""
        if self._results is None:
            return int(self.columns.fits.sum())
        return sum(1 for r in self._results if r.fits)

    def fitting(self) -> list[SweepResult]:
        if self._results is None:
            import numpy as np
            c = self.columns
            return [c.result(int(i)) for i in np.flatnonzero(c.fits)]
        return [r for r in self._results if r.fits]

    def _fit_mask(self, n_chips=None, chip=None, global_batch=None):
        import numpy as np
        c = self.columns
        mask = c.fits.copy()
        if n_chips is not None:
            mask &= c.n_chips == n_chips
        if global_batch is not None:
            mask &= c.global_batch == global_batch
        if chip is not None:
            if chip not in c.chip_names:
                return np.zeros(c.n, bool)
            mask &= c.chip_c == c.chip_names.index(chip)
        return mask

    # -- Pareto queries ------------------------------------------------------
    def max_global_batch(self, n_chips: Optional[int] = None,
                         chip: Optional[str] = None
                         ) -> Optional[SweepResult]:
        """Largest global batch that fits (optionally on exactly N chips /
        a given chip type); ties broken by smallest peak."""
        if self._results is None:
            import numpy as np
            c = self.columns
            idx = np.flatnonzero(self._fit_mask(n_chips=n_chips, chip=chip))
            if not len(idx):
                return None
            order = np.lexsort((c.peak_bytes[idx], -c.global_batch[idx]))
            return c.result(int(idx[order[0]]))
        cand = [r for r in self.fitting()
                if (n_chips is None or r.n_chips == n_chips)
                and (chip is None or r.chip == chip)]
        if not cand:
            return None
        return max(cand, key=lambda r: (r.global_batch, -r.peak_bytes))

    def min_chips(self, global_batch: Optional[int] = None,
                  chip: Optional[str] = None) -> Optional[SweepResult]:
        """Smallest chip count with a fitting config (optionally at a given
        global batch / chip type); ties broken by smallest peak."""
        if self._results is None:
            import numpy as np
            c = self.columns
            idx = np.flatnonzero(self._fit_mask(global_batch=global_batch,
                                                chip=chip))
            if not len(idx):
                return None
            order = np.lexsort((c.peak_bytes[idx], c.n_chips[idx]))
            return c.result(int(idx[order[0]]))
        cand = [r for r in self.fitting()
                if (global_batch is None or r.global_batch == global_batch)
                and (chip is None or r.chip == chip)]
        if not cand:
            return None
        return min(cand, key=lambda r: (r.n_chips, r.peak_bytes))

    def frontier(self) -> list[tuple[int, int]]:
        """(n_chips, max fitting global batch) pairs, ascending chips."""
        if self._results is None:
            import numpy as np
            c = self.columns
            mask = c.fits
            nc, gb = c.n_chips[mask], c.global_batch[mask]
            return [(int(u), int(gb[nc == u].max())) for u in np.unique(nc)]
        best: dict[int, int] = {}
        for r in self._results:
            if r.fits:
                best[r.n_chips] = max(best.get(r.n_chips, 0),
                                      r.global_batch)
        return sorted(best.items())

    # -- report writers ------------------------------------------------------
    def _sorted_indices(self):
        import numpy as np
        c = self.columns
        return np.lexsort((c.peak_bytes, -c.global_batch, ~c.fits))

    def sorted_results(self) -> list[SweepResult]:
        if self._results is None:
            c = self.columns
            return [c.result(int(i)) for i in self._sorted_indices()]
        return sorted(self._results,
                      key=lambda r: (not r.fits, -r.global_batch,
                                     r.peak_bytes))

    def _top_rows(self, limit: Optional[int]) -> tuple[list, int]:
        """Best ``limit`` rows (report order) + count of dropped rows,
        materializing only the returned rows when columnar."""
        if self._results is None:
            order = self._sorted_indices()
            keep = order if limit is None else order[:limit]
            rows = [self.columns.result(int(i)) for i in keep]
            return rows, len(order) - len(rows)
        rows = self.sorted_results()
        if limit is not None and len(rows) > limit:
            return rows[:limit], len(rows) - limit
        return rows, 0

    def _serve_active(self) -> bool:
        """True when the grid swept any non-neutral serving-fleet knob —
        the report then carries the serve columns instead of silently
        dropping the pool/draft fields."""
        try:
            return any(s is not None for s in self.grid.serve_specs())
        except (AttributeError, ValueError):
            return False

    def _offload_active(self) -> bool:
        """True when the grid swept the optimizer-offload knob — the
        report then carries the offload columns."""
        try:
            return any(self.grid.offloads())
        except (AttributeError, ValueError):
            return False

    def _liveness_active(self) -> bool:
        """True when the sweep ran under the liveness assembly — the
        report then carries the overlap-slack column."""
        return getattr(self.grid, "assembly", "legacy") == "liveness"

    def _report_columns(self):
        cols, extras = _COLUMNS, []
        if self._serve_active():
            cols, extras = cols + _SERVE_COLUMNS, extras + [_serve_row_of]
        if self._offload_active():
            cols, extras = (cols + _OFFLOAD_COLUMNS,
                            extras + [_offload_row_of])
        if self._liveness_active():
            cols, extras = (cols + _LIVENESS_COLUMNS,
                            extras + [_liveness_row_of])
        if not extras:
            return _COLUMNS, _row_of

        def row(r):
            out = _row_of(r)
            for extra in extras:
                out = out + extra(r)
            return out
        return cols, row

    def to_markdown(self, limit: Optional[int] = None,
                    title: str = "") -> str:
        rows, dropped = self._top_rows(limit)
        cols, row_of = self._report_columns()
        out = RPT.markdown_table(cols, [row_of(r) for r in rows],
                                 title=title)
        if dropped:
            out += f"\n\n_... {dropped} more cells (use to_csv() for all)_"
        return out

    def to_csv(self) -> str:
        cols, row_of = self._report_columns()
        return RPT.csv_table(cols,
                             [row_of(r) for r in self.sorted_results()])


# ---------------------------------------------------------------------------
# the memoized engine
# ---------------------------------------------------------------------------


class SweepEngine:
    """Memoized cell evaluator.

    Caches, per (arch, policy): the built model + parse table; and the
    three predictor component groups keyed by exactly the context fields
    each group reads (see core.predictor docstrings).  Composition goes
    through :func:`repro_torch.core.predictor.assemble` — the same function the
    un-memoized path uses — so cached and fresh cells are byte-identical.
    """

    def __init__(self):
        self._arch: dict = {}        # (arch, policy) -> (cfg, model, rows)
        self._stages: dict = {}      # (arch, policy, pp) -> StagePlan
        self._static: dict = {}
        self._acts: dict = {}
        self._over: dict = {}
        self._pred: dict = {}        # assembled cells, keyed + profile hash

    # -- caches --------------------------------------------------------------
    def _arch_state(self, arch: str, policy: TrainPolicy):
        key = (arch, policy)
        hit = self._arch.get(key)
        if hit is None:
            from repro_torch.configs import get_config
            from repro_torch.models import build_model
            cfg = get_config(arch)
            model = build_model(cfg)
            rows = parse_model(model.spec, policy)
            hit = self._arch[key] = (cfg, model, rows)
        return hit

    def _stage_plan(self, arch: str, policy: TrainPolicy, pp: int):
        key = (arch, policy, pp)
        hit = self._stages.get(key)
        if hit is None:
            from repro_torch.core import stages as ST
            _, _, rows = self._arch_state(arch, policy)
            hit = self._stages[key] = ST.partition(rows, pp)
        return hit

    def predict_cell(self, arch: str, policy: TrainPolicy,
                     ctx, profile=None,
                     chip: Optional[str] = None,
                     assembly: str = "legacy",
                     residual=None) -> PR.PredictedMemory:
        """Memoized twin of ``PR.predict(model, policy, ctx)``.

        The component caches are keyed WITHOUT the profile and the
        assembly mode — the cached StaticTerms/ActTermsAgg/OverheadTerms
        are raw Eq.1 values a profile never touches, shared between raw
        and calibrated evaluations and between legacy and liveness, which
        is exactly the single-source-of-truth property the liveness event
        program relies on.  The profile is applied at assemble time and
        its hash keys the assembled-cell cache, as does the mode, so a
        cell assembled under one profile is never served under another.
        A learned ``residual`` model corrects the assembled prediction;
        the corrected cell caches under the base key plus ``model_hash``,
        and ``residual=None`` shares the exact base objects.  Cached
        predictions are shared objects — treat them as read-only, as all
        callers do."""
        pred, pkey = self._predict_base(arch, policy, ctx, profile, chip,
                                        assembly)
        if residual is None:
            return pred
        rkey = (pkey, "residual", residual.model_hash)
        hit = self._pred.get(rkey)
        if hit is None:
            from repro_torch.calibrate.learned import apply_residual
            cfg, _, _ = self._arch_state(arch, policy)
            hit = self._pred[rkey] = apply_residual(
                pred, residual, cfg.family, ctx, profile=profile)
        return hit

    def _predict_base(self, arch: str, policy: TrainPolicy, ctx,
                      profile=None, chip: Optional[str] = None,
                      assembly: str = "legacy"):
        """(prediction, assembled-cell memo key) — predict_cell's body,
        before any residual correction."""
        cfg, model, rows = self._arch_state(arch, policy)
        mkey = tuple(sorted(ctx.mesh_shape.items()))
        base = (arch, policy, ctx.kind, mkey, ctx.backend)
        if ctx.pp > 1:
            return self._predict_pipelined(model, base, ctx, arch, policy,
                                           profile, chip, assembly)

        skey = base + (ctx.optimizer, ctx.eff_grad_bytes, ctx.offload_opt)
        static = self._static.get(skey)
        if static is None:
            static = self._static[skey] = PR.compute_static(rows, ctx)

        akey = base + (ctx.remat, ctx.micro_batch, ctx.seq_len, ctx.enc_seq)
        if ctx.kind != "train":
            akey += (ctx.global_batch, ctx.max_len)
        acts = self._acts.get(akey)
        if acts is None:
            acts = self._acts[akey] = PR.compute_acts(rows, ctx, ctx.kind)

        okey = base + (ctx.global_batch, ctx.micro_batch, ctx.seq_len,
                       ctx.enc_seq, ctx.max_len, ctx.serve)
        over = self._over.get(okey)
        if over is None:
            over = self._over[okey] = PR.compute_overheads(
                model, rows, ctx, ctx.kind)

        # assemble() reads only the components + ctx.opt_transient_frac
        # (backend-derived, already in base); chip only matters once a
        # profile can add a chip constant
        phash = None if profile is None else profile.profile_hash
        pkey = (skey, akey, okey, phash,
                chip if phash is not None else None, assembly)
        pred = self._pred.get(pkey)
        if pred is None:
            pred = self._pred[pkey] = PR.assemble(
                static, acts, over, ctx, profile=profile, chip=chip,
                assembly=assembly)
        return pred, pkey

    def _predict_pipelined(self, model, base, ctx, arch, policy,
                           profile, chip, assembly="legacy"):
        """Memoized per-stage twin of ``PR.predict`` for ``ctx.pp > 1``:
        each stage's component groups cache independently (the stage
        identity joins the exact fields each group reads), and the
        worst-stage composition caches like a plain cell."""
        from repro_torch.core import stages as ST
        pp, m = ctx.pp, ctx.eff_microbatches
        phash = None if profile is None else profile.profile_hash
        pkey = (base, "pipelined", ctx.optimizer, ctx.eff_grad_bytes,
                ctx.offload_opt,
                ctx.remat, ctx.pp_micro_batch, ctx.global_batch,
                ctx.seq_len, ctx.enc_seq, ctx.max_len, m, ctx.schedule,
                ctx.serve, phash, chip if phash is not None else None,
                assembly)
        pred = self._pred.get(pkey)
        if pred is not None:
            return pred, pkey
        plan = self._stage_plan(arch, policy, pp)
        best = None
        for s, srows in enumerate(plan.stages):
            sbase = base + (("stage", s, pp),)
            skey = sbase + (ctx.optimizer, ctx.eff_grad_bytes,
                            ctx.offload_opt)
            static = self._static.get(skey)
            if static is None:
                static = self._static[skey] = PR.compute_static(
                    list(srows), ctx)
            stash = ST.stash_count(s, pp, m, ctx.schedule)
            akey = sbase + (ctx.remat, ctx.pp_micro_batch, ctx.seq_len,
                            ctx.enc_seq, stash)
            if ctx.kind != "train":
                akey += (ctx.global_batch, ctx.max_len)
            acts = self._acts.get(akey)
            if acts is None:
                acts = self._acts[akey] = PR.compute_acts(
                    list(srows), ctx, ctx.kind, stash=stash)
            okey = sbase + (ctx.global_batch, ctx.pp_micro_batch,
                            ctx.seq_len, ctx.enc_seq, ctx.max_len, m,
                            ctx.serve)
            over = self._over.get(okey)
            if over is None:
                over = self._over[okey] = PR.compute_overheads(
                    model, list(srows), ctx, ctx.kind, stage=s,
                    n_stages=pp)
            sp = PR.assemble(static, acts, over, ctx, profile=profile,
                             chip=chip, stage=s, n_stages=pp,
                             assembly=assembly)
            if best is None or sp.peak_bytes > best.peak_bytes:
                best = sp
        self._pred[pkey] = best
        return best, pkey

    # -- cell evaluation -----------------------------------------------------
    def evaluate(self, cell: SweepCell, policy: TrainPolicy = FULL_TRAIN,
                 headroom: float = PL.HEADROOM,
                 keep_prediction: bool = False,
                 profile=None, assembly: str = "legacy",
                 residual=None) -> SweepResult:
        cfg, _, _ = self._arch_state(cell.arch, policy)
        ctx = PL.make_context(cfg, cell.mesh_shape, kind=cell.kind,
                              global_batch=cell.global_batch,
                              seq_len=cell.seq_len, backend=cell.backend,
                              grad_accum=cell.grad_accum, remat=cell.remat,
                              optimizer=cell.optimizer,
                              microbatches=cell.microbatches,
                              schedule=cell.schedule, serve=cell.serve,
                              offload_opt=cell.offload)
        pred = self.predict_cell(cell.arch, policy, ctx, profile=profile,
                                 chip=cell.chip, assembly=assembly,
                                 residual=residual)
        budget = int(PL.chip_hbm(cell.chip) * headroom)
        return SweepResult(
            arch=cell.arch, chip=cell.chip, mesh_shape=cell.mesh_shape,
            n_chips=cell.n_chips,
            optimizer=cell.optimizer or cfg.optimizer,
            remat=cell.remat or cfg.remat, grad_accum=cell.grad_accum,
            global_batch=cell.global_batch, seq_len=cell.seq_len,
            kind=cell.kind, backend=cell.backend,
            schedule=cell.schedule, microbatches=cell.microbatches,
            serve=cell.serve, pool_bytes=pred.pool_bytes,
            draft_bytes=pred.draft_bytes,
            hit_saved_bytes=pred.hit_saved_bytes,
            offload=cell.offload, offload_bytes=pred.offload_bytes,
            overlap_slack_bytes=pred.overlap_slack_bytes,
            peak_bytes=pred.peak_bytes, budget_bytes=budget,
            fits=pred.peak_bytes <= budget,
            prediction=pred if keep_prediction else None)

    def report(self, arch: str, shape, mesh_shape: dict, *,
               policy: TrainPolicy = FULL_TRAIN, backend: str = "tpu",
               budget_bytes: int, grad_accum: int = 1,
               remat: Optional[str] = None,
               optimizer: Optional[str] = None, chip: str = "v5e",
               profile=None, microbatches: int = 1,
               schedule: str = "1f1b", serve=None,
               offload_opt: bool = False,
               assembly: str = "legacy",
               residual=None) -> PL.PlanReport:
        """PlanReport-shaped single-cell evaluation (planner.plan's
        memoized backend); byte-identical to ``planner.check``."""
        shape = PL._resolve_shape(shape)
        cfg, _, _ = self._arch_state(arch, policy)
        ctx = PL.make_context(cfg, mesh_shape, kind=shape.kind,
                              global_batch=shape.global_batch,
                              seq_len=shape.seq_len, backend=backend,
                              grad_accum=grad_accum, remat=remat,
                              optimizer=optimizer,
                              microbatches=microbatches,
                              schedule=schedule, serve=serve,
                              offload_opt=offload_opt)
        pred = self.predict_cell(arch, policy, ctx, profile=profile,
                                 chip=chip, assembly=assembly,
                                 residual=residual)
        return PL.PlanReport(arch=arch, shape=shape.name,
                             fits=pred.peak_bytes <= budget_bytes,
                             peak_bytes=pred.peak_bytes,
                             budget_bytes=budget_bytes,
                             grad_accum=grad_accum,
                             remat=remat or cfg.remat, prediction=pred)

    def sweep(self, grid: SweepGrid, mode: str = "columnar",
              jobs: int = 1, engine: str = "torch",
              device: Optional[str] = None) -> SweepResults:
        """Evaluate every grid cell.

        ``mode="columnar"`` (default) lowers the whole grid to
        structure-of-arrays tables; ``mode="cell"`` is the per-cell
        reference path (``engine="numpy"`` only).  ``engine`` selects the
        columnar compute engine: ``"torch"`` (default) — host table
        build, then the per-cell composition as int64 tensor ops on
        ``device`` (:mod:`repro_torch.core.batch_torch`) — or ``"numpy"``,
        the host columnar path of :mod:`repro_torch.core.batch`.  Results
        are byte-identical, with or without a calibration profile.  Grids
        with ``keep_predictions=True`` take the per-cell path of the numpy
        engine (columnar mode does not materialize PredictedMemory
        breakdowns), as do grids with a learned ``residual_model`` (the
        correction is applied per cell in ``predict_cell``); the torch
        engine refuses both.

        ``device`` is the torch engine's device, ``"cuda"`` when None.
        On a CUDA device the shard denominators and the liveness
        prefix-max run in the hand-written CUDA kernels; with no CUDA
        device present the default raises — the host is used only when
        the caller passes ``device="cpu"``.  ``jobs`` > 1 splits the
        host table build over worker threads (mesh-chunked; results are
        order-identical).
        """
        if mode not in ("columnar", "cell"):
            raise ValueError(
                f"unknown sweep mode {mode!r}; use 'columnar' or 'cell'")
        if engine not in ("torch", "numpy"):
            raise ValueError(
                f"unknown sweep engine {engine!r}; use 'torch' or 'numpy'")
        if engine == "torch":
            if mode == "cell":
                raise ValueError(
                    "engine='torch' lowers the columnar path; it cannot "
                    "drive mode='cell' (use engine='numpy')")
            if grid.keep_predictions:
                raise ValueError(
                    "engine='torch' does not materialize PredictedMemory "
                    "breakdowns; use engine='numpy' with "
                    "keep_predictions=True")
            from repro_torch.core import batch_torch as BT
            return BT.sweep_columnar_torch(self, grid, jobs=jobs,
                                           device=device)
        if device is not None:
            raise ValueError(
                "device applies to engine='torch' only; engine='numpy' "
                "always runs on the host")
        if mode == "columnar" and not grid.keep_predictions \
                and grid.residual_model is None:
            from repro_torch.core import batch as B
            return B.sweep_columnar(self, grid, jobs=jobs)
        t0 = time.perf_counter()
        results = [self.evaluate(cell, grid.policy, grid.headroom,
                                 grid.keep_predictions,
                                 profile=grid.profile,
                                 assembly=grid.assembly,
                                 residual=grid.residual_model)
                   for cell in grid.cells()]
        return SweepResults(grid=grid, results=results,
                            elapsed_s=time.perf_counter() - t0)


def sweep(grid: SweepGrid, engine=None, mode: str = "columnar",
          jobs: int = 1, device: Optional[str] = None) -> SweepResults:
    """Run a capacity-planning sweep (fresh engine unless one is passed).

    ``engine`` accepts either a :class:`SweepEngine` instance or a
    compute-engine name (``"torch"`` / ``"numpy"``) — the string form is
    shorthand for a fresh SweepEngine driving that columnar engine."""
    if isinstance(engine, str):
        return SweepEngine().sweep(grid, mode=mode, jobs=jobs,
                                   engine=engine, device=device)
    return (engine or SweepEngine()).sweep(grid, mode=mode, jobs=jobs,
                                           device=device)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _int_list(s: str) -> tuple[int, ...]:
    return tuple(int(x) for x in s.split(",") if x)


def _float_list(s: str) -> tuple[float, ...]:
    return tuple(float(x) for x in s.split(",") if x)


def _str_list(s: Optional[str]) -> tuple:
    if not s:
        return (None,)
    return tuple(None if x in ("default", "arch") else x
                 for x in s.split(",") if x)


# order-of-magnitude planning rates for --dry-run's runtime estimate —
# the FALLBACK when BENCH_sweep.json has no measured rate for the (mode,
# engine, device, assembly) key on this machine.  The numpy keys are the
# reference's (its numpy engine is the port's).  The torch engine on the
# card: the smaller of the two cold rates measured on an H100 80GB HBM3 at
# 700 W by chip_smoke.py's sweeps (124,416 cells in 123.3 ms legacy,
# 1,959,552 in 244.2 ms under liveness), since a dry run is
# followed by a cold run.  Its other keys (the liveness assembly; the
# host, not measured) take the mode's planning rate.
EST_CELLS_PER_SEC = {"columnar": 1_000_000, "cell": 15_000,
                     "columnar_liveness": 1_000_000,
                     "cell_liveness": 10_000,
                     "columnar_torch": 1_000_000}
_CARD_ESTIMATE = "planning estimate (H100 80GB HBM3, 700 W)"
_HOST_ESTIMATE = "planning estimate (the host, not measured)"


def _rate_key(mode: str, engine: str = "numpy", assembly: str = "legacy",
              device: Optional[str] = None) -> str:
    """BENCH_sweep.json ``modes`` key for a (mode, engine, assembly)
    triple — the numpy engine keeps the bare mode name and the legacy
    assembly adds no suffix, as the reference's keys; the torch engine
    also names its device (``columnar_torch`` on the card,
    ``columnar_torch_cpu`` on the host)."""
    key = mode if (mode == "cell" or engine in (None, "numpy")) \
        else f"{mode}_{engine}"
    if engine == "torch" and mode != "cell" and device == "cpu":
        key = f"{key}_cpu"
    if assembly not in (None, "legacy"):
        key = f"{key}_{assembly}"
    return key


def _planning_rate(mode: str, engine: str = "numpy",
                   assembly: str = "legacy",
                   device: Optional[str] = None) -> tuple[float, str]:
    """(cells/sec, source) for --dry-run's runtime estimate: the last
    measured throughput for this exact key from BENCH_sweep.json when
    present, else the planning rate.  A measured rate for a DIFFERENT
    assembly or device never substitutes."""
    import json
    import os
    key = _rate_key(mode, engine, assembly, device)
    try:
        from repro_torch.calibrate.paths import repo_root
        path = os.path.join(str(repo_root()), "BENCH_sweep.json")
        with open(path) as f:
            rate = float(json.load(f)["modes"][key]["cells_per_sec"])
        if rate > 0:
            return rate, f"measured, {os.path.basename(path)}"
    except (ImportError, OSError, KeyError, ValueError, TypeError):
        pass
    if key.startswith("columnar_torch"):
        source = _HOST_ESTIMATE if "_cpu" in key else _CARD_ESTIMATE
    else:
        source = ("planning estimate; run benchmarks/sweep_throughput.py "
                  "to measure")
    return float(EST_CELLS_PER_SEC.get(key, EST_CELLS_PER_SEC[mode])), \
        source


def _preview(values, limit: int = 6) -> str:
    vals = [str(v) if v is not None else "default" for v in values]
    if len(vals) > limit:
        vals = vals[:limit] + ["..."]
    return ",".join(vals)


def _cardinality_table(grid: SweepGrid) -> str:
    """Per-knob cardinality breakdown of a grid — what ``size()``
    multiplies — so ``--dry-run`` users see where a cell explosion comes
    from before paying for it."""
    from repro_torch.launch.mesh import cp_degree, ep_degree, pp_degree
    meshes = grid.meshes()
    pps = sorted({pp_degree(m) for m in meshes})
    eps = sorted({ep_degree(m) for m in meshes})
    cps = sorted({cp_degree(m) for m in meshes})
    degrees = [f"{k} degrees {_preview(v)}"
               for k, v in (("pp", pps), ("ep", eps), ("cp", cps))
               if len(v) > 1 or v != [1]]
    pairs = [(a, g) for a in _seq(grid.grad_accums)
             for g in _seq(grid.global_batches) if not g % a]
    rows = [
        ("arch", len(_seq(grid.arch)), _preview(_seq(grid.arch))),
        ("chip type", len(_seq(grid.chip)), _preview(_seq(grid.chip))),
        ("mesh", len(meshes),
         ", ".join(degrees) if degrees else "2-axis factorizations"),
        ("optimizer", len(_seq(grid.optimizers)),
         _preview(_seq(grid.optimizers))),
        ("remat", len(_seq(grid.remats)), _preview(_seq(grid.remats))),
        ("schedule", len(_seq(grid.schedules)),
         _preview(_seq(grid.schedules))),
        ("microbatches", len(_seq(grid.microbatches)),
         _preview(_seq(grid.microbatches))),
        ("accum x batch", len(pairs),
         _preview([f"{a}/{g}" for a, g in pairs])),
        ("seq len", len(_seq(grid.seq_lens)),
         _preview(_seq(grid.seq_lens))),
    ]
    serves = grid.serve_specs()
    if any(s is not None for s in serves):
        rows.insert(-2, ("serve", len(serves), _preview(
            ["neutral" if s is None else
             f"b{s.block_size}/u{s.util_bp / 10000:g}/h{s.hit_bp / 10000:g}"
             + (f"/d:{s.draft_arch}" if s.draft_arch else "")
             for s in serves])))
    offs = grid.offloads()
    if any(offs):
        rows.insert(-2, ("offload", len(offs),
                         _preview(["on" if o else "off" for o in offs])))
    out = [f"  {'knob':<14s} {'count':>5s}  values"]
    for name, count, vals in rows:
        out.append(f"  {name:<14s} {count:>5d}  {vals}")
    out.append(f"  {'total':<14s} {grid.size():>5d}  (product, after "
               f"divisibility filter)")
    return "\n".join(out)


def _empty_grid_msg() -> str:
    return ("0 cells matched: the grid produced no evaluable cells.  "
            "Common causes: no --batch value is divisible by any --accum "
            "value (cells with batch % accum != 0 are skipped), or "
            "--max-model filtered out every mesh factorization of "
            "--chips.  Relax one of those axes and re-run.")


def _parse_mesh(s: str) -> dict:
    out = {}
    for part in s.split(","):
        k, _, v = part.partition("=")
        if not k.strip() or not v.isdigit():
            raise ValueError(
                f"bad --mesh entry {part!r}: expected axis=int "
                f"(e.g. data=8,model=2)")
        out[k.strip()] = int(v)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.core.sweep",
        description="Capacity-planning sweep: mesh x optimizer x remat x "
                    "accum x batch x seq_len grids, memoized Eq.1 "
                    "arithmetic per cell.")
    p.add_argument("--arch", required=True,
                   help="architecture (e.g. llava15_7b / llava15-7b)")
    p.add_argument("--chips", type=_int_list, default=None,
                   help="chip count(s); all mesh factorizations are swept")
    p.add_argument("--mesh", action="append", metavar="data=8,model=2",
                   help="explicit mesh shape (repeatable; overrides "
                        "--chips enumeration)")
    p.add_argument("--mesh-axes", default="data,model",
                   help="axes used for --chips factorization (add `pipe` "
                        "to enumerate pipeline-parallel plans)")
    p.add_argument("--max-model", type=int, default=None,
                   help="cap the model (TP) axis size")
    p.add_argument("--max-pipe", type=int, default=None,
                   help="cap the pipe (PP) axis size")
    p.add_argument("--max-expert", type=int, default=None,
                   help="cap the expert (EP) axis size")
    p.add_argument("--max-context", type=int, default=None,
                   help="cap the context (CP) axis size")
    p.add_argument("--schedule", default="1f1b",
                   help="comma list of pipeline schedules (1f1b,gpipe)")
    p.add_argument("--microbatches", type=_int_list, default=(1,),
                   help="pipeline microbatch counts (inert without a "
                        "pipe mesh axis)")
    p.add_argument("--chip", default="v5e",
                   help=f"chip type(s), comma list of {sorted(PL.CHIPS)}")
    p.add_argument("--optimizer", default=None,
                   help="comma list (adamw,adafactor,adamw8bit); "
                        "default: arch optimizer")
    p.add_argument("--remat", default=None,
                   help="comma list (none,block,dots); default: arch remat")
    p.add_argument("--accum", type=_int_list, default=(1, 2, 4, 8),
                   help="gradient-accumulation factors")
    p.add_argument("--batch", type=_int_list, default=(256,),
                   help="global batch sizes")
    p.add_argument("--seq-len", type=_int_list, default=(4096,),
                   help="sequence lengths")
    p.add_argument("--kind", default="train",
                   choices=("train", "prefill", "decode"))
    p.add_argument("--block-size", type=_int_list, default=(0,),
                   metavar="B,B,...",
                   help="paged-KV block sizes in tokens (0 = contiguous; "
                        "positive values must be multiples of 8); serve "
                        "kinds only")
    p.add_argument("--utilization", type=_float_list, default=(1.0,),
                   metavar="U,U,...",
                   help="KV-pool utilizations in (0,1]; allocated pool "
                        "bytes are inflated by 1/U (fragmentation slack)")
    p.add_argument("--prefix-hit-rate", type=_float_list, default=(0.0,),
                   metavar="H,H,...",
                   help="prefix-cache hit rates in [0,1] over the shared "
                        "--prefix-len token prefix")
    p.add_argument("--prefix-len", type=int, default=0,
                   help="shared-prefix token count the hit rate discounts")
    p.add_argument("--mix", action="append", default=None,
                   metavar="P[:LxW,...]",
                   help="in-flight request mix: prefill fraction P plus "
                        "an optional final-context histogram, e.g. "
                        "0.3:512x1,2048x3 (repeatable)")
    p.add_argument("--draft-arch", default="",
                   help="comma list of speculative-decode draft arches "
                        "('' = none); decode kind only")
    p.add_argument("--offload-optimizer", default="off",
                   choices=("off", "on", "both"),
                   help="optimizer-state host offload (Eq.1 offload "
                        "tier): off (default), on, or both to sweep the "
                        "knob; train kind only")
    p.add_argument("--policy", default="full", choices=sorted(POLICIES))
    p.add_argument("--backend", default="tpu", choices=("tpu", "cpu"))
    p.add_argument("--headroom", type=float, default=PL.HEADROOM)
    p.add_argument("--profile", metavar="PATH", default=None,
                   help="CalibrationProfile JSON (python -m "
                        "repro_torch.calibrate fit) applied to every "
                        "cell's prediction")
    p.add_argument("--residual-model", metavar="PATH", default=None,
                   help="learned ResidualModel JSON (python -m "
                        "repro_torch.calibrate fit-residual) applied on top "
                        "of --profile; needs --engine numpy (the cell "
                        "path)")
    p.add_argument("--mode", choices=("columnar", "cell"),
                   default="columnar",
                   help="columnar: vectorized batch evaluation (default); "
                        "cell: per-cell reference path (byte-identical, "
                        "much slower on large grids)")
    p.add_argument("--engine", choices=("torch", "numpy"), default="torch",
                   help="columnar compute engine: torch (default; host "
                        "table build + device composition through the "
                        "CUDA kernels) or numpy (host columnar path, "
                        "byte-identical)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="device of the torch engine (default cuda; "
                        "raises when no CUDA device is present)")
    p.add_argument("--assembly", choices=("legacy", "liveness"),
                   default="legacy",
                   help="peak assembly: legacy Eq.1 sum-of-maxima "
                        "(default) or liveness interval-overlap peak "
                        "from the alloc/free event program "
                        "(docs/memory_model.md)")
    p.add_argument("--jobs", type=int, default=1,
                   help="worker threads for the columnar component stage "
                        "(mesh-chunked; identical results)")
    p.add_argument("--dry-run", action="store_true",
                   help="print the cell count + estimated runtime and "
                        "exit without evaluating anything")
    p.add_argument("--top", type=int, default=20,
                   help="rows to print (full grid goes to --csv/--md)")
    p.add_argument("--csv", metavar="PATH", help="write full CSV report")
    p.add_argument("--md", metavar="PATH", help="write markdown report")
    args = p.parse_args(argv)

    if args.chips is None and not args.mesh:
        p.error("need --chips N or at least one --mesh")

    try:
        arch = normalize_arch(args.arch)
        for c in args.chip.split(","):
            PL.chip_hbm(c)
        from repro_torch.core.stages import SCHEDULES
        for s in args.schedule.split(","):
            if s not in SCHEDULES:
                raise ValueError(
                    f"unknown schedule {s!r}; known: {SCHEDULES}")
        meshes = [_parse_mesh(m) for m in args.mesh] if args.mesh else None
        from repro_torch.serve.fleet import parse_mix
        mixes = tuple(parse_mix(m) for m in args.mix) if args.mix \
            else (None,)
    except (KeyError, ValueError) as e:
        p.error(str(e))
    profile = None
    if args.profile:
        from repro_torch.calibrate.profile import CalibrationProfile
        try:
            profile = CalibrationProfile.load(args.profile)
        except (OSError, ValueError) as e:
            p.error(f"--profile: {e}")
    residual = None
    if args.residual_model:
        from repro_torch.calibrate.learned import ResidualModel
        try:
            residual = ResidualModel.load(args.residual_model)
        except (OSError, ValueError) as e:
            p.error(f"--residual-model: {e}")
        if residual.base_profile_hash != (profile.profile_hash
                                          if profile else None):
            p.error(f"--residual-model was fitted over profile "
                    f"{residual.base_profile_hash or 'raw'}; pass the "
                    f"matching --profile")
        if args.engine != "numpy":
            p.error("--residual-model routes through the cell path; "
                    "use --engine numpy")
    if args.engine == "numpy" and args.device is not None:
        p.error("--device applies to --engine torch only")
    max_axis = {}
    if args.max_model:
        max_axis["model"] = args.max_model
    if args.max_pipe:
        max_axis["pipe"] = args.max_pipe
    if args.max_expert:
        max_axis["expert"] = args.max_expert
    if args.max_context:
        max_axis["context"] = args.max_context
    grid = SweepGrid(
        arch=arch,
        chips=args.chips,
        mesh_axes=tuple(args.mesh_axes.split(",")),
        mesh_shapes=meshes,
        max_axis=max_axis or None,
        chip=tuple(args.chip.split(",")),
        optimizers=_str_list(args.optimizer),
        remats=_str_list(args.remat),
        schedules=tuple(args.schedule.split(",")),
        microbatches=args.microbatches,
        grad_accums=args.accum, global_batches=args.batch,
        seq_lens=args.seq_len, kind=args.kind,
        policy=POLICIES[args.policy], backend=args.backend,
        headroom=args.headroom, profile=profile,
        residual_model=residual,
        block_sizes=args.block_size, utilizations=args.utilization,
        prefix_hit_rates=args.prefix_hit_rate,
        prefix_len=args.prefix_len, mixes=mixes,
        draft_archs=tuple(args.draft_arch.split(","))
        if args.draft_arch else ("",),
        offload_optimizer={"off": (False,), "on": (True,),
                           "both": (False, True)}[args.offload_optimizer],
        assembly=args.assembly)
    try:
        # reject illegal expert/context layouts, serve knobs on train
        # kinds / bad block alignment / out-of-range rates / unknown draft
        # arches and optimizer offload on serve kinds — with a clean
        # argparse error, before any evaluation
        grid.check_parallel()
        grid.check_serve()
        grid.check_offload()
    except ValueError as e:
        p.error(str(e))

    if args.mode == "cell" and args.engine != "numpy":
        p.error("--mode cell is the per-cell reference path; it needs "
                "--engine numpy")
    device = args.device or "cuda"
    if args.engine == "torch" and device == "cuda" and not args.dry_run:
        import torch
        if not torch.cuda.is_available():
            p.error("--engine torch runs on a CUDA device and none is "
                    "present; pass --device cpu to run on the host")

    if args.dry_run:
        n = grid.size()
        rate, source = _planning_rate(
            args.mode, args.engine, args.assembly,
            device if args.engine == "torch" else None)
        print(f"dry run: {n:,} cells")
        print(_cardinality_table(grid))
        print(f"estimated runtime in --mode {args.mode} --engine "
              f"{args.engine} --assembly {args.assembly}: ~{n / rate:.1f}s "
              f"({rate:,.0f} cells/s — {source})")
        if n == 0:
            print(_empty_grid_msg())
            return 2
        return 0

    res = sweep(grid, mode=args.mode, jobs=args.jobs, engine=args.engine,
                device=device if args.engine == "torch" else None)
    if len(res) == 0:
        print(_empty_grid_msg())
        return 2
    n_fit = res.fit_count
    title = (f"capacity sweep: {arch} {args.kind} on {args.chip} "
             f"({args.backend} prediction)"
             + (" [liveness]" if args.assembly == "liveness" else "")
             + (f" [profile {profile.profile_hash}]" if profile else "")
             + (f" [residual {residual.model_hash}]" if residual else ""))
    print(f"# {title}")
    print(f"{len(res)} cells in {res.elapsed_s:.3f}s "
          f"({res.cells_per_sec:,.0f} cells/s, mode={args.mode}, "
          f"engine={args.engine}"
          + (f", device={device}" if args.engine == "torch" else "")
          + f"); {n_fit} fit")
    if res.frontier():
        print("\nPareto frontier (chips -> max fitting global batch):")
        for chips, batch in res.frontier():
            print(f"  {chips:>6d} chips : batch {batch}")
    best = res.max_global_batch()
    if best is not None:
        print(f"\nbest: {best}")
    print()
    print(res.to_markdown(limit=args.top))
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(res.to_csv() + "\n")
        print(f"\nwrote {args.csv}")
    if args.md:
        with open(args.md, "w") as f:
            f.write(res.to_markdown(title=title) + "\n")
        print(f"wrote {args.md}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
