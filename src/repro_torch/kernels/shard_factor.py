"""Shard factor: the greedy mesh-axis assignment behind every shard
denominator of the columnar table build.

Every TermSpec of the sweep resolves its shard denominator through the
greedy pass of ``mesh_ctx.assign_axes`` (divisibility masks,
one-use-per-axis, the FSDP/ZeRO ``extra`` sweep), a few hundred times per
table build.  The numpy transliteration in ``core.batch.batch_shard_factor``
stays the host path; this module *packs* the greedy program — the
(dim, axis, pass) step sequence the host loops walk — into (dim, axis,
flag) step triples, and packs every request of one table build into one
set of buffers, so that the build costs one upload, one launch and one
read-back:

* :class:`ShardFactorBatch` — records requests (deduplicated by content),
  packs them (:class:`Packed`) and resolves them all at once;
* :func:`resolve_batched` — runs a table build twice around one
  :meth:`ShardFactorBatch.resolve`: first recording its requests (answered
  with placeholder ones), then answering each from the one launch;
* :func:`shard_factor_batch` — the wrapper: on CUDA tensors it launches
  the hand-written kernel ``csrc/shard_factor.cu`` (which replaces the TPU
  kernel ``repro/kernels/shard_factor.py::_pallas_kernel``); on CPU
  tensors it takes :func:`shard_factor_batch_plain`.  It never falls
  back: what the kernel does not take raises;
* :func:`shard_factor_plain` — one request's step program as masked
  ``torch.where`` / ``%`` / ``//`` int64 ops on the quotients of the dims
  (the kernel's form, computed plainly); :func:`shard_factor_tensors` — one
  request of ``(n_dims, n)`` / ``(n_axes, n)`` tensors through the batch
  wrapper;
* :func:`shard_factor` — the drop-in twin of
  ``core.batch.batch_shard_factor`` (numpy / ints in, numpy out) for one
  request;
* ``launches`` — how many times the kernel was launched.

The packed form.  A request's operands broadcast to a shape of at most 2
dims ``(R, C)`` (a larger rank is flattened to ``(1, R*C)`` with its
operands expanded); each operand row is stored once, compact, in
``operands`` (equal rows of different requests share one copy) and read
through a descriptor ``(offset, stride over R, stride over C)`` with
stride 0 where it broadcasts.  ``requests`` holds per request ``REQ_*``:
its cell count, ``C``, first output cell, first row descriptor, dim and
axis counts, first step and step count.  A :class:`Packed` is made from
those four buffers and derives the rest itself: ``inverses``, at the same
index as ``operands``, the inverse mod 2^64 of each value's odd part
(:func:`size_constants`), so the kernel tests divisibility without a
divide; ``wide``, per request 1 where an operand it reads is 2^32 or
more; ``tiles``, per ``TILE`` cells ``(request, first cell, its row, its
column)`` and the request's program place (:func:`_tiles`).  Everything
is int64.

The kernel (``csrc/shard_factor.cu``, which replaces the TPU kernel
``repro/kernels/shard_factor.py::_pallas_kernel``, ``pallas_call`` at
``:162``) keeps per cell the quotient ``q[d] = dims[d] / (the sizes
applied to d)`` and tests a size ``s = 2^k o`` (o odd) by a shift, a
multiply by o's inverse and a multiply-high: no division; in 32-bit words
where ``wide`` is 0.  Persistent blocks walk the tiles in order and stage
each request's program once; a thread takes ``CELLS`` consecutive cells
(one in a tile of at most ``THREADS`` cells).  Bound on an H100: bytes —
the operands and the programs read once and ``8 * n_out`` bytes written
(6.2 MB, 1.85 us, at the sweeps' largest build of 97 requests and 771,420
cells); on an H100 80GB HBM3 at 700 W it takes ~11 us there (the per-cell
kernel it replaced, 35.4 us) and ~3.7 us on a search's build of 50 small
requests; PERF.md § 6 row 1 (``chip_smoke.py``'s ``kernels`` line) has
the current times.

Limits: dims in ``[0, DIM_LIMIT]`` (2^62), sizes >= 1, ``MAX_DIMS`` dims,
``MAX_AXES`` axes and ``MAX_STEPS`` steps a request, fewer than
``OPERAND_LIMIT`` packed operand values; a :class:`Packed` beyond them
raises ``ValueError`` naming the limit (so does the plain version).  The
sweeps' operands lie far inside: the largest operand of their largest
build is 102,400, and a size is a mesh axis of at most a few hundred.

Exactness: the packed form drops the host path's ``live`` size-1 axis
skip per cell — a size-1 axis multiplies every factor by 1 and marking it
used only ever blocks another x1 attempt, so including such steps is
value-identical per element.  Axes that are 1 in EVERY cell are still
dropped host-side as a pure optimisation.  The quotient form is the
scalar reference ``mesh_ctx.shard_factor`` exactly; the numpy path's test
``dims % (totals * s)`` agrees wherever its running product stays below
2^63, which every sweep's does.  Parity with the reference package's
numpy and scalar paths is asserted on randomized programs in
tests/test_torch_shard_factor.py, kernel-vs-plain equality on the device
by ``chip_smoke.py``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.mesh_ctx import PIPE_AXIS

I64 = np.int64

# fixed limits and shape of the kernel (csrc/shard_factor.cu: SF_MAX_*,
# SF_THREADS, SF_CELLS, SF_TILE)
MAX_DIMS = 8
MAX_AXES = 8
MAX_STEPS = 128
THREADS = 128
CELLS = 4                       # consecutive cells a thread
TILE = THREADS * CELLS
DIM_LIMIT = 2 ** 62             # dims in [0, DIM_LIMIT]
OPERAND_LIMIT = 2 ** 31 - 1     # packed operand values (32-bit indices)

# fields of a packed request (csrc/shard_factor.cu: REQ_*)
REQ_N, REQ_C, REQ_OUT, REQ_ROW, REQ_DIMS, REQ_AXES, REQ_STEP, REQ_STEPS = \
    range(8)
REQ_FIELDS = 8
TILE_FIELDS = 8                 # csrc/shard_factor.cu: SF_TILE_FIELDS

launches = 0


# ---------------------------------------------------------------------------
# program packing
# ---------------------------------------------------------------------------

# step flags: 0 = rules pass; 1 = extra pass; 2 = extra pass, first step
# of a new extra axis (resets the per-axis `assigned` latch)
_RULES, _EXTRA, _EXTRA_FIRST = 0, 1, 2


def pack_program(axes, rules: dict, extra=(), axis_names=()):
    """Flatten the greedy assignment into (dim, axis, flag) step triples.

    ``axis_names`` lists the mesh axes that participate (order defines
    the axis ids of the packed program); axes not in it are skipped,
    mirroring the host path's ``live`` filter.  Returns
    ``(steps, names)`` where ``steps`` is a tuple of int triples and
    ``names`` the axis-id -> name order actually referenced.
    """
    ids: dict[str, int] = {}
    steps: list[tuple[int, int, int]] = []
    allowed = set(axis_names)
    for i, ax in enumerate(axes):
        if not ax:
            continue
        for a in rules.get(ax, ()):
            if a == PIPE_AXIS or a not in allowed:
                continue
            steps.append((i, ids.setdefault(a, len(ids)), _RULES))
    for a in extra:
        if a == PIPE_AXIS or a not in allowed:
            continue
        first = True
        for i in range(len(axes)):
            if axes[i] == "layers":     # never FSDP/ZeRO-shard the stack dim
                continue
            steps.append((i, ids.setdefault(a, len(ids)),
                          _EXTRA_FIRST if first else _EXTRA))
            first = False
    names = [a for a, _ in sorted(ids.items(), key=lambda kv: kv[1])]
    return tuple(steps), names


def _operand_rows(a: np.ndarray, shape: tuple) -> tuple:
    """One operand broadcast to ``shape``: its compact values and its
    strides over the packed ``(R, C)`` cells."""
    if len(shape) > 2:                  # flattened to (1, R*C)
        if a.size == 1:
            return a.reshape(1), 0, 0
        return np.broadcast_to(a, shape).reshape(-1), 0, 1
    a2 = a.reshape((1,) * (2 - a.ndim) + a.shape)
    s0 = a2.shape[1] if a2.shape[0] > 1 else 0
    s1 = 1 if a2.shape[1] > 1 else 0
    return np.ascontiguousarray(a2).reshape(-1), s0, s1


def _cells(shape: tuple) -> tuple:
    """``(n, C)`` of the packed ``(R, C)`` view of a broadcast shape."""
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    c = int(shape[-1]) if 0 < len(shape) <= 2 else n
    return n, max(c, 1)


def _odd_parts(values) -> tuple:
    """``(v, o)``: ``values`` as int64 with 1 where a value is < 1, and
    their odd parts ``o = v / (v's lowest set bit)`` as uint64."""
    v = np.asarray(values, I64)
    v = np.where(v >= 1, v, 1)
    return v, (v // (v & -v)).astype(np.uint64)


def size_constants(values) -> tuple:
    """``(k, o, inv)`` of int64 ``values`` as uint64 arrays: each value
    ``>= 1`` is ``2^k * o`` with ``o`` odd, and ``o * inv == 1 (mod
    2^64)`` (Newton's iteration, wrapping in uint64, from ``(3 o) ^ 2``,
    right in the low 5 bits: each round doubles them, to 80 in four);
    zeros where a value is < 1.  The kernel's divisibility test reads
    ``inv`` and finds ``k`` itself."""
    bad = np.asarray(values, I64) < 1
    v, o = _odd_parts(values)
    k = (np.frexp((v & -v).astype(np.float64))[1] - 1).astype(np.uint64)
    zero = np.uint64(0)
    return (np.where(bad, zero, k), np.where(bad, zero, o),
            _inverses(values).view(np.uint64))


def _inverses(operands) -> np.ndarray:
    """The packed ``inverses`` of ``operands``: ``inv`` of
    :func:`size_constants` (0 where a value is < 1) as the int64 of the
    same bits."""
    _, o = _odd_parts(operands)
    u2 = np.uint64(2)
    with np.errstate(over="ignore"):       # in place: a round is 3 passes
        inv = o * np.uint64(3)
        inv ^= u2
        t = np.empty_like(o)
        for _ in range(4):
            np.multiply(o, inv, out=t)
            np.subtract(u2, t, out=t)
            inv *= t
    inv = inv.view(I64)
    inv[np.asarray(operands, I64) < 1] = 0
    return inv


def _operand_ranges(rows: np.ndarray, requests: np.ndarray) -> tuple:
    """Per row descriptor of every request: its index in ``rows``, its
    request, and the float64 index of the last operand it reads (float,
    so that a stride past int64 cannot wrap into range)."""
    r = requests
    idx, owner = _expand(r[:, REQ_ROW], r[:, REQ_DIMS] + r[:, REQ_AXES])
    rw = rows[idx]
    n, c = r[owner, REQ_N], r[owner, REQ_C]
    last = rw[:, 0] + np.maximum(n // c - 1, 0).astype(np.float64) \
        * rw[:, 1] + (c - 1).astype(np.float64) * rw[:, 2]
    return idx, owner, last


def _any_in_ranges(flag: np.ndarray, lo: np.ndarray,
                   hi: np.ndarray) -> np.ndarray:
    """Per range ``[lo, hi)`` of ``flag``'s indices, whether any is set
    (prefix sums, one pass over ``flag``; none where no flag is set, the
    usual case)."""
    if not flag.any():
        return np.zeros(len(lo), bool)
    count = np.concatenate([[0], np.cumsum(flag)])
    return count[hi] - count[lo] > 0


def _wide(operands: np.ndarray, rows: np.ndarray, requests: np.ndarray,
          ranges: tuple) -> np.ndarray:
    """``wide`` of each request: 1 where an operand it reads is 2^32 or
    more (the kernel then keeps 64-bit quotients), else 0 (32-bit ones:
    exact, as the quotient form has no running product); ``ranges`` are
    :func:`_operand_ranges`'."""
    idx, owner, last = ranges
    live = requests[owner, REQ_N] > 0
    hit = _any_in_ranges(operands >= 1 << 32, rows[idx[live], 0],
                         last[live].astype(I64) + 1)
    wide = np.zeros(len(requests), bool)
    np.logical_or.at(wide, owner[live], hit)
    return wide.astype(I64)


# ---------------------------------------------------------------------------
# packed requests
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Packed:
    """Requests packed for one launch (host arrays, int64): ``operands``
    ``(n_operands,)``, ``rows`` ``(n_rows, 3)`` descriptors, ``requests``
    ``(n_req, REQ_FIELDS)`` (``REQ_*``) and ``steps`` ``(n_steps, 3)``.
    Constructing one checks them — a request out of the kernel's limits, an
    operand out of its range, a step or a descriptor out of range raises
    ``ValueError`` — and derives the kernel's own buffers: ``inverses``
    ``(n_operands,)`` (:func:`_inverses`), ``wide`` ``(n_req,)``
    (:func:`_wide`) and ``tiles`` ``(n_tiles, TILE_FIELDS)``
    (:func:`_tiles`)."""

    operands: np.ndarray
    rows: np.ndarray
    requests: np.ndarray
    steps: np.ndarray
    inverses: np.ndarray = field(init=False, repr=False)
    wide: np.ndarray = field(init=False, repr=False)
    tiles: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        ranges = _check_packed(self)
        for name, value in (
                ("inverses", _inverses(self.operands)),
                ("wide", _wide(self.operands, self.rows, self.requests,
                               ranges)),
                ("tiles", _tiles(self.requests))):
            object.__setattr__(self, name, value)

    @property
    def n_out(self) -> int:
        r = self.requests
        return int((r[:, REQ_OUT] + r[:, REQ_N]).max()) if len(r) else 0

    def to(self, device) -> "DevicePacked":
        """The buffers on ``device`` in one copy (from pinned memory for
        a CUDA device)."""
        device = torch.device(device)
        parts = (self.operands, self.inverses, self.rows, self.requests,
                 self.wide, self.steps, self.tiles)
        flat = torch.from_numpy(np.concatenate([p.reshape(-1)
                                                for p in parts]))
        if device.type == "cuda":
            pinned = torch.empty(flat.shape, dtype=torch.int64,
                                 pin_memory=True)
            flat = pinned.copy_(flat).to(device, non_blocking=True)
        else:
            flat = flat.to(device)
        views, at = [], 0
        for p in parts:
            views.append(flat[at:at + p.size].view(p.shape))
            at += p.size
        return DevicePacked(self, *views)


@dataclass(frozen=True)
class DevicePacked:
    """A :class:`Packed` and its buffers on one device."""

    host: Packed
    operands: torch.Tensor
    inverses: torch.Tensor
    rows: torch.Tensor
    requests: torch.Tensor
    wide: torch.Tensor
    steps: torch.Tensor
    tiles: torch.Tensor


def _expand(starts: np.ndarray, counts: np.ndarray) -> tuple:
    """Per request the indices ``starts[j] + range(counts[j])``, flat, and
    the request of each."""
    owner = np.repeat(np.arange(len(starts)), counts)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    return np.repeat(starts, counts) + np.arange(len(owner)) - first, owner


def _check_packed(p: Packed) -> tuple:
    """Raises ``ValueError`` where ``p``'s buffers are malformed or out of
    the kernel's limits; else returns their :func:`_operand_ranges`."""
    shapes = {"operands": (p.operands, 1), "rows": (p.rows, 2),
              "requests": (p.requests, 2), "steps": (p.steps, 2)}
    for name, (a, nd) in shapes.items():
        if not isinstance(a, np.ndarray) or a.dtype != I64 or a.ndim != nd:
            raise ValueError(f"shard_factor packed {name}: int64 array of "
                             f"{nd} dims expected")
    for name, a, w in (("rows", p.rows, 3),
                       ("requests", p.requests, REQ_FIELDS),
                       ("steps", p.steps, 3)):
        if a.shape[1] != w:
            raise ValueError(f"shard_factor packed {name}: {w} columns "
                             f"expected, got {a.shape[1]}")
    if len(p.operands) > OPERAND_LIMIT:
        raise ValueError(f"shard_factor kernel limits exceeded: "
                         f"{len(p.operands)} packed operand values (max "
                         f"{OPERAND_LIMIT}, 32-bit indices)")
    r = p.requests
    n, c = r[:, REQ_N], r[:, REQ_C]
    nd, na, ns = r[:, REQ_DIMS], r[:, REQ_AXES], r[:, REQ_STEPS]
    if ((nd > MAX_DIMS) | (na > MAX_AXES) | (ns > MAX_STEPS)).any():
        j = int(np.flatnonzero((nd > MAX_DIMS) | (na > MAX_AXES)
                               | (ns > MAX_STEPS))[0])
        raise ValueError(
            f"shard_factor kernel limits exceeded by request {j}: "
            f"{nd[j]} dims (max {MAX_DIMS}), {na[j]} axes (max "
            f"{MAX_AXES}), {ns[j]} steps (max {MAX_STEPS})")
    if ((nd < 1) | (na < 1) | (ns < 1) | (n < 0) | (c < 1)).any() \
            or (n % c != 0).any() or (r[:, REQ_OUT] < 0).any():
        raise ValueError("shard_factor: a request needs at least one "
                         "step, one dim and one axis, and whole rows of "
                         "cells (the caller returns ones for an empty "
                         "program)")
    for lo, cnt, total, what in ((r[:, REQ_ROW], nd + na, len(p.rows),
                                  "row descriptors"),
                                 (r[:, REQ_STEP], ns, len(p.steps),
                                  "steps")):
        if (lo < 0).any() or (lo + cnt > total).any():
            raise ValueError(f"shard_factor: a request's {what} lie "
                             f"outside the packed array")
    # every step names a dim and an axis of its request
    idx, owner = _expand(r[:, REQ_STEP], ns)
    st = p.steps[idx]
    if ((st < 0).any() or (st[:, 0] >= nd[owner]).any()
            or (st[:, 1] >= na[owner]).any()
            or (st[:, 2] > _EXTRA_FIRST).any()):
        raise ValueError("shard_factor: step out of range for the operands")
    # every descriptor stays inside the operands
    ranges = idx, owner, last = _operand_ranges(p.rows, r)
    rw = p.rows[idx]
    live = n[owner] > 0
    if (rw < 0).any() or (live & (last >= len(p.operands))).any():
        raise ValueError("shard_factor: an operand descriptor reads "
                         "outside the operands")
    # the values each descriptor reads lie in the kernel's range: dims in
    # [0, DIM_LIMIT], sizes >= 1 (over [offset, last])
    is_dim = idx - r[owner, REQ_ROW] < nd[owner]
    lo = rw[live, 0]
    hi = last[live].astype(I64) + 1
    for mask, bad, what in (
            (is_dim[live], (p.operands < 0) | (p.operands > DIM_LIMIT),
             f"a dim outside [0, {DIM_LIMIT}] (DIM_LIMIT, 2^62)"),
            (~is_dim[live], p.operands < 1, "a size below 1")):
        if _any_in_ranges(bad, lo[mask], hi[mask]).any():
            raise ValueError(f"shard_factor kernel limits exceeded: "
                             f"{what}")
    # each output cell belongs to one request (no two threads write it)
    order = np.argsort(r[:, REQ_OUT], kind="stable")
    ends = (r[:, REQ_OUT] + n)[order]
    if (ends[:-1] > r[order[1:], REQ_OUT]).any():
        raise ValueError("shard_factor: two requests write the same output "
                         "cells")
    return ranges


def _tiles(requests: np.ndarray) -> np.ndarray:
    """Each ``TILE`` cells, request by request: ``(request, first cell,
    its row, its column, the request's first row descriptor, first step,
    n_dims + n_axes, n_steps)`` (``TILE_FIELDS``; the program's place
    rides with the tile so that the kernel loads it beside the request's
    header)."""
    r = requests
    per = -(-r[:, REQ_N] // TILE)
    tile, owner = _expand(np.zeros_like(per), per)
    if not len(owner):
        return np.zeros((0, TILE_FIELDS), I64)
    first = tile * TILE
    c = r[owner, REQ_C]
    return np.stack([owner, first, first // c, first % c,
                     r[owner, REQ_ROW], r[owner, REQ_STEP],
                     r[owner, REQ_DIMS] + r[owner, REQ_AXES],
                     r[owner, REQ_STEPS]], axis=1).astype(I64)


def _program(dims, axes, sizes: dict, rules: dict, extra):
    """``(shape, steps, operand arrays)`` of one request; ``steps`` empty
    for an empty program (the answer is ones)."""
    arrs = [np.asarray(d, I64) for d in dims]
    svals = {a: np.asarray(v, I64) for a, v in sizes.items()}
    shape = np.broadcast_shapes(*(a.shape for a in arrs),
                                *(v.shape for v in svals.values()))
    live = [a for a, v in svals.items() if np.any(v > 1)]
    steps, names = pack_program(axes, rules, extra, axis_names=live)
    if not arrs:
        steps = ()
    return shape, steps, arrs + [svals[a] for a in names]


def _call_key(dims, axes, sizes: dict, rules: dict, extra) -> tuple:
    """One ``batch_shard_factor`` call's arguments, by value."""
    def fp(x):
        a = np.asarray(x, I64)
        return a.shape, a.tobytes()
    return (tuple(fp(d) for d in dims), tuple(axes),
            tuple((k, fp(v)) for k, v in sizes.items()),
            tuple(rules.items()), tuple(extra))


class ShardFactorBatch:
    """The shard-factor requests of one table build: recorded (equal
    requests once), packed, resolved in one launch.  Thread-safe, so a
    build split over worker threads records into one batch."""

    def __init__(self):
        self._lock = threading.Lock()
        self._index: dict = {}          # request key -> position
        self._reqs: list = []           # (shape, steps, n_dims, operands)
        self._calls: dict = {}          # call key -> (request key, shape)

    def __len__(self) -> int:
        return len(self._reqs)

    @staticmethod
    def _key(shape, steps, ops) -> tuple:
        return (shape, steps) + tuple((a.shape, a.tobytes()) for a in ops)

    def _add(self, shape, steps, n_dims: int, ops: list) -> tuple:
        key = self._key(shape, steps, ops)
        with self._lock:
            if key not in self._index:
                self._index[key] = len(self._reqs)
                self._reqs.append((shape, steps, n_dims, ops))
        return key

    def add(self, dims, axes, sizes: dict, rules: dict, extra=()):
        """Record one request (``core.batch.batch_shard_factor``'s
        arguments); its key, or None for an empty program."""
        shape, steps, ops = _program(dims, axes, sizes, rules, extra)
        return self._add(shape, steps, len(dims), ops) if steps else None

    def record(self, dims, axes, sizes: dict, rules: dict, extra=()):
        """``batch_shard_factor``'s signature: records the request and
        answers with ones of its broadcast shape (a placeholder)."""
        call = _call_key(dims, axes, sizes, rules, extra)
        hit = self._calls.get(call)
        if hit is None:
            shape, steps, ops = _program(dims, axes, sizes, rules, extra)
            key = self._add(shape, steps, len(dims), ops) if steps else None
            hit = self._calls[call] = (key, shape)
        return np.broadcast_to(np.ones((), I64), hit[1])

    def pack(self) -> Packed:
        """Every recorded request in the kernel's packed form."""
        ops_at: dict = {}
        parts, n_ops = [], 0
        rows, reqs, steps = [], [], []
        out = 0
        for shape, st, n_dims, ops in self._reqs:
            n, c = _cells(shape)
            reqs.append((n, c, out, len(rows), n_dims, len(ops) - n_dims,
                         len(steps), len(st)))
            for a in ops:
                vals, s0, s1 = _operand_rows(a, shape)
                key = vals.tobytes()
                if key not in ops_at:
                    ops_at[key] = n_ops
                    parts.append(vals)
                    n_ops += vals.size
                rows.append((ops_at[key], s0, s1))
            steps.extend(st)
            out += n
        operands = np.concatenate(parts).astype(I64) if parts \
            else np.zeros(0, I64)
        return Packed(operands, np.array(rows, I64).reshape(-1, 3),
                      np.array(reqs, I64).reshape(-1, REQ_FIELDS),
                      np.array(steps, I64).reshape(-1, 3))

    def resolve(self, device) -> dict:
        """Every recorded request's answer (request key -> int64 array of
        its broadcast shape): one upload, one launch on ``device`` (the
        plain version on the CPU), one read-back.  No request: no launch."""
        if not self._reqs:
            return {}
        packed = self.pack()
        flat = shard_factor_batch(packed.to(device)).cpu().numpy()
        out = {}
        for key, j in self._index.items():
            shape = self._reqs[j][0]
            lo, n = packed.requests[j, REQ_OUT], packed.requests[j, REQ_N]
            ans = flat[lo:lo + n].reshape(shape)
            ans.flags.writeable = False
            out[key] = ans
        return out


def resolve_batched(build, device):
    """``build()`` — a table build that asks ``core.batch.
    batch_shard_factor`` for its shard denominators, and whose requests
    do not depend on the answers — run twice: first recording every
    request (answered with placeholder ones), then, after one
    :meth:`ShardFactorBatch.resolve` on ``device``, with each request
    answered from that launch.  Returns ``(result of the second run, the
    batch)``; a request of the second run the first did not make
    raises."""
    from repro_torch.core import batch as B

    batch = ShardFactorBatch()
    prev = B._shard_factor_impl
    B._shard_factor_impl = batch.record
    try:
        build()
    finally:
        B._shard_factor_impl = prev
    answers = batch.resolve(device)

    def answer(dims, axes, sizes, rules, extra=()):
        hit = batch._calls.get(_call_key(dims, axes, sizes, rules, extra))
        if hit is None:
            raise RuntimeError("shard_factor: the table build asked for a "
                               "denominator it did not ask for while its "
                               "requests were recorded")
        key, shape = hit
        return np.broadcast_to(np.ones((), I64), shape) if key is None \
            else answers[key]

    B._shard_factor_impl = answer
    try:
        return build(), batch
    finally:
        B._shard_factor_impl = prev


# ---------------------------------------------------------------------------
# plain version + kernel wrapper (tensors in, tensor out)
# ---------------------------------------------------------------------------


def _check_steps(dims: torch.Tensor, sizes: torch.Tensor, steps):
    for name, t in (("dims", dims), ("sizes", sizes)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"shard_factor {name}: torch.Tensor expected, "
                            f"got {type(t)}")
        if t.dtype != torch.int64:
            raise TypeError(f"shard_factor {name}: int64 expected, got "
                            f"{t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"shard_factor {name}: (rows, n_cells) "
                             f"expected, got shape {tuple(t.shape)}")
    if dims.shape[1] != sizes.shape[1]:
        raise ValueError(
            f"shard_factor: dims has {dims.shape[1]} cells, sizes "
            f"{sizes.shape[1]}")
    if dims.device != sizes.device:
        raise ValueError(
            f"shard_factor: dims on {dims.device}, sizes on {sizes.device}")
    st = np.asarray(steps, I64).reshape(-1, 3)
    if len(st) < 1 or dims.shape[0] < 1 or sizes.shape[0] < 1:
        raise ValueError(
            "shard_factor: needs at least one step, one dim and one axis "
            "(the caller returns ones for an empty program)")
    if (st.min() < 0 or st[:, 0].max() >= dims.shape[0]
            or st[:, 1].max() >= sizes.shape[0]
            or st[:, 2].max() > _EXTRA_FIRST):
        raise ValueError("shard_factor: step out of range for the operands")
    return st


def _check_values(dims: torch.Tensor, sizes: torch.Tensor) -> None:
    if bool((dims < 0).any()) or bool((dims > DIM_LIMIT).any()):
        raise ValueError(f"shard_factor kernel limits exceeded: a dim "
                         f"outside [0, {DIM_LIMIT}] (DIM_LIMIT, 2^62)")
    if bool((sizes < 1).any()):
        raise ValueError("shard_factor kernel limits exceeded: a size "
                         "below 1")


def shard_factor_plain(dims: torch.Tensor, sizes: torch.Tensor,
                       steps) -> torch.Tensor:
    """One request's step program as masked int64 tensor ops: ``dims`` is
    ``(n_dims, n)`` in ``[0, DIM_LIMIT]``, ``sizes`` is ``(n_axes, n)``,
    each >= 1, the result ``(n,)``."""
    st = _check_steps(dims, sizes, steps)
    _check_values(dims, sizes)
    return _plain(dims, sizes, st)


def _plain(dims: torch.Tensor, sizes: torch.Tensor,
           st: np.ndarray) -> torch.Tensor:
    """The program on checked operands: per dim the quotient ``q`` of the
    dim by the sizes applied to it; a step applies iff its size divides
    ``q`` (``%`` and ``//``, exact with no running product)."""
    n = dims.shape[1]
    one = torch.ones((n,), dtype=torch.int64, device=dims.device)
    q = list(dims)
    used = [torch.zeros((n,), dtype=torch.bool, device=dims.device)
            ] * sizes.shape[0]
    denom = one
    assigned = torch.zeros((n,), dtype=torch.bool, device=dims.device)
    for d, a, fl in st.tolist():
        if fl == _EXTRA_FIRST:
            assigned = torch.zeros_like(assigned)
        sv = sizes[a]
        ok = (q[d] % sv == 0) & ~used[a]
        if fl:
            ok = ok & ~assigned
        q[d] = torch.where(ok, q[d] // sv, q[d])
        denom = denom * torch.where(ok, sv, one)
        used[a] = used[a] | ok
        if fl:
            assigned = assigned | ok
    return denom


def shard_factor_batch_plain(b: DevicePacked) -> torch.Tensor:
    """The batched function in plain PyTorch on ``b``'s device: each
    request's operand rows read through their descriptors (stride-0
    views where they broadcast), :func:`shard_factor_plain`'s program per
    request (the operands were checked when ``b.host`` was made).
    Returns ``(n_out,)`` int64."""
    p = b.host
    out = torch.empty((p.n_out,), dtype=torch.int64,
                      device=b.operands.device)
    for req in p.requests.tolist():
        n, c = req[REQ_N], req[REQ_C]
        if n == 0:
            continue
        base = b.operands.storage_offset()
        rows = [torch.as_strided(b.operands, (n // c, c), (s0, s1),
                                 base + off).reshape(n)
                for off, s0, s1 in p.rows[req[REQ_ROW]:req[REQ_ROW]
                                          + req[REQ_DIMS]
                                          + req[REQ_AXES]].tolist()]
        steps = p.steps[req[REQ_STEP]:req[REQ_STEP] + req[REQ_STEPS]]
        out[req[REQ_OUT]:req[REQ_OUT] + n] = _plain(
            torch.stack(rows[:req[REQ_DIMS]]),
            torch.stack(rows[req[REQ_DIMS]:]), steps)
    return out


def shard_factor_batch(b: DevicePacked) -> torch.Tensor:
    """Every packed request of ``b`` (checked when its :class:`Packed`
    was made) -> ``(n_out,)`` int64 on ``b``'s device: one launch of the
    kernel on CUDA, the plain version on the CPU."""
    global launches
    if not isinstance(b, DevicePacked):
        raise TypeError(f"shard_factor_batch: DevicePacked expected, got "
                        f"{type(b)}")
    names = ("operands", "inverses", "rows", "requests", "wide", "steps",
             "tiles")
    tensors = [getattr(b, k) for k in names]
    host = [getattr(b.host, k) for k in names]
    device = b.operands.device
    if any(t.dtype != torch.int64 or t.device != device
           or not t.is_contiguous() or tuple(t.shape) != h.shape
           for t, h in zip(tensors, host)):
        raise ValueError("shard_factor_batch: contiguous int64 buffers of "
                         "the packed shapes on one device expected")
    if device.type == "cpu":
        return shard_factor_batch_plain(b)
    if device.type != "cuda":
        raise ValueError(
            f"shard_factor runs on cuda or cpu tensors, got {device}")
    out = torch.empty((b.host.n_out,), dtype=torch.int64, device=device)
    n_tiles = len(b.host.tiles)
    if n_tiles == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.shard_factor_batch_launch(
            *(t.data_ptr() for t in tensors), out.data_ptr(), n_tiles,
            stream)
    if rc != 0:
        raise RuntimeError(
            f"shard_factor kernel launch failed (cuda error {rc}) for "
            f"{len(b.host.requests)} requests in {n_tiles} tiles")
    launches += 1
    return out


def shard_factor_tensors(dims: torch.Tensor, sizes: torch.Tensor,
                         steps) -> torch.Tensor:
    """Shard denominators of ``n`` cells as one packed request: ``dims``
    ``(n_dims, n)`` and ``sizes`` ``(n_axes, n)`` int64 on one device,
    ``steps`` the packed (dim, axis, flag) program.  Returns ``(n,)``
    int64 on that device (through :func:`shard_factor_batch`)."""
    st = _check_steps(dims, sizes, steps)
    n_dims, n = dims.shape
    n_axes = sizes.shape[0]
    rows = np.array([(k * n, 0, 1) for k in range(n_dims + n_axes)],
                    I64).reshape(-1, 3)
    ops = torch.cat([dims.reshape(-1), sizes.reshape(-1)]).cpu().numpy()
    req = np.array([(n, max(n, 1), 0, 0, n_dims, n_axes, 0, len(st))], I64)
    return shard_factor_batch(Packed(ops, rows, req, st).to(dims.device))


# ---------------------------------------------------------------------------
# drop-in twin of core.batch.batch_shard_factor
# ---------------------------------------------------------------------------


def shard_factor(dims, axes, sizes: dict, rules: dict, extra=(),
                 device="cuda") -> np.ndarray:
    """Drop-in twin of :func:`repro_torch.core.batch.batch_shard_factor`
    for one request: ``dims`` entries and ``sizes`` values are ints or
    broadcastable int64 arrays, the result a numpy array of the full
    broadcast shape — resolved by one :meth:`ShardFactorBatch.resolve` on
    ``device`` (byte-identical int64)."""
    batch = ShardFactorBatch()
    key = batch.add(dims, axes, sizes, rules, extra)
    if key is None:
        shape = np.broadcast_shapes(
            *(np.shape(d) for d in dims), *(np.shape(v)
                                            for v in sizes.values()))
        return np.broadcast_to(np.ones((), I64), shape)
    return batch.resolve(device)[key]
