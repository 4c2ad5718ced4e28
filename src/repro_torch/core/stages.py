"""Pipeline-stage partitioner: ParsedLayer rows -> balanced contiguous
stages.

Pipeline parallelism slices the model's layer sequence into ``pp``
contiguous stages, each resident on a disjoint set of chips (the ``pipe``
mesh axis).  The memory question per stage is exactly Eq.1 restricted to
that stage's rows, plus schedule-dependent terms (the in-flight microbatch
activation stash, stage-boundary send/recv buffers) — so the partition
itself must be a deterministic, pure function of the parse table that the
scalar predictor (``core.predictor``) and the columnar engine
(``core.batch``) share.  This module is that function.

Partition rules (property-tested in tests/test_stages.py):

* **Contiguity** — every stage holds a contiguous run of the row sequence;
  scan-stacked blocks split by repeat count (32 layers -> e.g. 8+8+8+8).
* **Exact cover** — each row's repeat units land in exactly one stage;
  summing any per-repeat quantity over stages reproduces the whole model.
* **Pinning** — everything before the first splittable segment (token
  embedding, vision tower, audio encoder, projector) is pinned to stage 0;
  everything after the last splittable segment (final norm, LM head) is
  pinned to the last stage.  Non-text towers are never split: a frozen (or
  trainable) vision/audio encoder rides with stage 0, the paper's
  multimodal front-end placement.
* **Balance** — the splittable middle (block stacks, unit = one block
  instance) is partitioned by a linear-partition DP minimizing the max
  stage weight, where a unit's weight is its parameter bytes (x4 when
  trainable, approximating the grad+opt states that ride along); the
  pinned front/tail weights load stages 0/pp-1 in the DP cost.  The
  optimum is never worse than the greedy bound
  ``total/pp + max_unit_weight``.

Schedule model (``stash_count``): under 1F1B stage *i* holds
``min(pp - i, microbatches)`` in-flight microbatch activation sets; GPipe
holds all ``microbatches`` on every stage.  With ``pp == 1`` there is no
pipeline and the stash is 1 regardless of schedule.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core.parser import ParsedLayer

SCHEDULES = ("1f1b", "gpipe")

#: balance-weight multiplier for trainable units: grads + optimizer states
#: scale with trainable parameter bytes, frozen rows carry params only.
TRAINABLE_WEIGHT = 4


@dataclass(frozen=True)
class _Segment:
    """A maximal run of rows sharing one owning module."""

    rows: tuple                 # ParsedLayer rows (same module_path/repeat)
    splittable: bool            # scan stack that may split across stages

    @property
    def repeat(self) -> int:
        return self.rows[0].repeat

    def unit_weight(self) -> int:
        """Balance weight of ONE repeat instance."""
        w = 0
        for r in self.rows:
            per = sum(p.nbytes for p in r.layer.params.values())
            w += per * (TRAINABLE_WEIGHT if r.trainable else 1)
        return w

    def total_weight(self) -> int:
        return self.unit_weight() * self.repeat


@dataclass(frozen=True)
class StagePlan:
    """The partition of one parse table into ``pp`` stages."""

    pp: int
    stages: tuple               # tuple[tuple[ParsedLayer, ...], ...]
    weights: tuple              # per-stage balance weight (ints)

    def rows_of(self, stage: int) -> list:
        return list(self.stages[stage])


def _segments(rows: list) -> list[_Segment]:
    groups: list[list[ParsedLayer]] = []
    for r in rows:
        if groups and groups[-1][0].module_path == r.module_path:
            groups[-1].append(r)
        else:
            groups.append([r])
    segs = []
    for g in groups:
        splittable = (
            g[0].scanned and g[0].repeat > 1
            # only the text backbone's stacks split; vision/audio towers
            # stay whole (pinned with the front of the pipeline)
            and all(r.modality == "text" for r in g)
            # weight-tied python-unrolled blocks (zamba2 shared attention)
            # are invoked throughout the depth — they cannot live on one
            # contiguous slice, so they stay atomic
            and not any("invocation_repeat" in r.layer.meta
                        or "cache_repeat" in r.layer.meta for r in g))
        segs.append(_Segment(rows=tuple(g), splittable=splittable))
    return segs


def _linear_partition(weights: list[int], pp: int,
                      front: int, tail: int) -> list[int]:
    """Contiguous partition of ``weights`` into ``pp`` chunk sizes
    minimizing the max stage load, with ``front``/``tail`` preloaded onto
    the first/last stage.  Returns per-stage unit counts (sum == len)."""
    n = len(weights)
    prefix = [0]
    for w in weights:
        prefix.append(prefix[-1] + w)

    def span(i: int, j: int) -> int:               # sum of units [i, j)
        return prefix[j] - prefix[i]

    INF = float("inf")
    # best[s][j] = minimal max-load splitting units [0, j) into s+1 stages
    best = [[INF] * (n + 1) for _ in range(pp)]
    cut = [[0] * (n + 1) for _ in range(pp)]
    for j in range(n + 1):
        load = span(0, j) + front + (tail if pp == 1 else 0)
        best[0][j] = load
    for s in range(1, pp):
        extra = tail if s == pp - 1 else 0
        for j in range(n + 1):
            for i in range(j + 1):
                if best[s - 1][i] == INF:
                    continue
                cand = max(best[s - 1][i], span(i, j) + extra)
                if cand < best[s][j]:
                    best[s][j] = cand
                    cut[s][j] = i
    counts = [0] * pp
    j = n
    for s in range(pp - 1, 0, -1):
        i = cut[s][j]
        counts[s] = j - i
        j = i
    counts[0] = j
    return counts


def partition(rows: list, pp: int) -> StagePlan:
    """Assign the parse table to ``pp`` balanced contiguous stages.

    Deterministic in (rows, pp); ``pp == 1`` returns the whole table as
    one stage (the predictor's non-pipelined path is bit-equal by
    construction).  Stages may be empty when ``pp`` exceeds the number of
    splittable units.
    """
    if pp < 1:
        raise ValueError(f"pp must be >= 1, got {pp}")
    if pp == 1:
        total = sum(s.total_weight() for s in _segments(rows))
        return StagePlan(pp=1, stages=(tuple(rows),), weights=(total,))

    segs = _segments(rows)
    split_ids = [i for i, s in enumerate(segs) if s.splittable]
    if not split_ids:
        # nothing to distribute: everything is pinned to stage 0
        stages = [tuple(rows)] + [()] * (pp - 1)
        w = sum(s.total_weight() for s in segs)
        return StagePlan(pp=pp, stages=tuple(stages),
                         weights=(w,) + (0,) * (pp - 1))
    first, last = split_ids[0], split_ids[-1]
    front = segs[:first]                 # pinned to stage 0
    middle = segs[first:last + 1]        # distributed (may hold atomics)
    tail = segs[last + 1:]               # pinned to stage pp-1

    # expand the middle to units: one per repeat of a splittable segment,
    # one per whole atomic segment
    units: list[tuple[int, int]] = []    # (segment index in middle, weight)
    for mi, seg in enumerate(middle):
        if seg.splittable:
            units.extend((mi, seg.unit_weight())
                         for _ in range(seg.repeat))
        else:
            units.append((mi, seg.total_weight()))
    front_w = sum(s.total_weight() for s in front)
    tail_w = sum(s.total_weight() for s in tail)
    counts = _linear_partition([w for _, w in units], pp, front_w, tail_w)

    stage_rows: list[list[ParsedLayer]] = [[] for _ in range(pp)]
    weights = [0] * pp
    stage_rows[0].extend(r for s in front for r in s.rows)
    weights[0] += front_w
    pos = 0
    for s in range(pp):
        take = units[pos:pos + counts[s]]
        pos += counts[s]
        if not take:
            continue
        # contiguous unit run -> per-segment repeat chunks, in order
        chunk: dict[int, int] = {}
        for mi, _ in take:
            chunk[mi] = chunk.get(mi, 0) + 1
        for mi in sorted(chunk):
            seg = middle[mi]
            if seg.splittable:
                rep = chunk[mi]
                stage_rows[s].extend(replace(r, repeat=rep)
                                     for r in seg.rows)
                weights[s] += seg.unit_weight() * rep
            else:
                stage_rows[s].extend(seg.rows)
                weights[s] += seg.total_weight()
    stage_rows[pp - 1].extend(r for s in tail for r in s.rows)
    weights[pp - 1] += tail_w
    return StagePlan(pp=pp, stages=tuple(tuple(r) for r in stage_rows),
                     weights=tuple(weights))


def stash_count(stage: int, pp: int, microbatches: int,
                schedule: str = "1f1b") -> int:
    """In-flight microbatch activation sets held by ``stage`` during the
    steady state of the schedule (1 with no pipeline)."""
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown schedule {schedule!r}; known: {SCHEDULES}")
    if pp <= 1:
        return 1
    m = max(microbatches, 1)
    if schedule == "gpipe":
        return m
    return max(min(pp - stage, m), 1)


def boundary_edges(stage: int, pp: int) -> int:
    """Pipeline edges touching ``stage``: recv-from-previous +
    send-to-next (0 with no pipeline)."""
    if pp <= 1:
        return 0
    return (1 if stage > 0 else 0) + (1 if stage < pp - 1 else 0)
