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
  ``torch.where`` / ``%`` int64 ops; :func:`shard_factor_tensors` — one
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
axis counts, first step and step count; ``tiles`` lists ``(request, first
cell)`` per block of ``TILE`` cells.  Everything is int64.

Bound on an H100: bytes, the compact operands, descriptors and the
``8 * n_out`` output bytes; for a table build (a few hundred requests of
a few thousand cells) that is well under a microsecond, so a build costs
one launch plus the upload and the read-back.

Exactness: the packed form drops the host path's ``live`` size-1 axis
skip per cell — a size-1 axis multiplies every factor by 1 and marking it
used only ever blocks another x1 attempt, so including such steps is
value-identical per element.  Axes that are 1 in EVERY cell are still
dropped host-side as a pure optimisation.  Everything is int64 with
floor division; parity with the reference package's numpy and scalar
paths is asserted on randomized programs in
tests/test_torch_shard_factor.py, kernel-vs-plain equality on the device
by ``chip_smoke.py``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.mesh_ctx import PIPE_AXIS

I64 = np.int64

# fixed limits of the kernel (csrc/shard_factor.cu: SF_MAX_*, SF_TILE)
MAX_DIMS = 8
MAX_AXES = 8
MAX_STEPS = 128
TILE = 256

# fields of a packed request (csrc/shard_factor.cu: REQ_*)
REQ_N, REQ_C, REQ_OUT, REQ_ROW, REQ_DIMS, REQ_AXES, REQ_STEP, REQ_STEPS = \
    range(8)

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


# ---------------------------------------------------------------------------
# packed requests
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Packed:
    """Requests packed for one launch (host arrays, int64): ``operands``
    ``(n_operands,)``, ``rows`` ``(n_rows, 3)`` descriptors, ``requests``
    ``(n_req, 8)`` (``REQ_*`` fields), ``steps`` ``(n_steps, 3)`` and
    ``tiles`` ``(n_tiles, 2)``.  Constructing one checks it: a request
    out of the kernel's limits, a step or a descriptor out of range
    raises ``ValueError``."""

    operands: np.ndarray
    rows: np.ndarray
    requests: np.ndarray
    steps: np.ndarray
    tiles: np.ndarray

    def __post_init__(self):
        _check_packed(self)

    @property
    def n_out(self) -> int:
        r = self.requests
        return int((r[:, REQ_OUT] + r[:, REQ_N]).max()) if len(r) else 0

    def to(self, device) -> "DevicePacked":
        """The buffers on ``device`` in one copy (from pinned memory for
        a CUDA device)."""
        device = torch.device(device)
        parts = (self.operands, self.rows, self.requests, self.steps,
                 self.tiles)
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
    rows: torch.Tensor
    requests: torch.Tensor
    steps: torch.Tensor
    tiles: torch.Tensor


def _expand(starts: np.ndarray, counts: np.ndarray) -> tuple:
    """Per request the indices ``starts[j] + range(counts[j])``, flat, and
    the request of each."""
    owner = np.repeat(np.arange(len(starts)), counts)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    return np.repeat(starts, counts) + np.arange(len(owner)) - first, owner


def _check_packed(p: Packed) -> None:
    shapes = {"operands": (p.operands, 1), "rows": (p.rows, 2),
              "requests": (p.requests, 2), "steps": (p.steps, 2),
              "tiles": (p.tiles, 2)}
    for name, (a, nd) in shapes.items():
        if not isinstance(a, np.ndarray) or a.dtype != I64 or a.ndim != nd:
            raise ValueError(f"shard_factor packed {name}: int64 array of "
                             f"{nd} dims expected")
    for name, a, w in (("rows", p.rows, 3), ("requests", p.requests, 8),
                       ("steps", p.steps, 3), ("tiles", p.tiles, 2)):
        if a.shape[1] != w:
            raise ValueError(f"shard_factor packed {name}: {w} columns "
                             f"expected, got {a.shape[1]}")
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
    idx, owner = _expand(r[:, REQ_ROW], nd + na)
    rw = p.rows[idx]
    rows_r = n[owner] // c[owner]
    last = rw[:, 0] + np.maximum(rows_r - 1, 0) * rw[:, 1] \
        + (c[owner] - 1) * rw[:, 2]
    if (rw < 0).any() or ((n[owner] > 0) & (last >= len(p.operands))).any():
        raise ValueError("shard_factor: an operand descriptor reads "
                         "outside the operands")
    # each output cell belongs to one request (no two threads write it)
    order = np.argsort(r[:, REQ_OUT], kind="stable")
    ends = (r[:, REQ_OUT] + n)[order]
    if (ends[:-1] > r[order[1:], REQ_OUT]).any():
        raise ValueError("shard_factor: two requests write the same output "
                         "cells")
    # the tiles cover every cell of every request once
    want = _tiles(r)
    if not np.array_equal(p.tiles, want):
        raise ValueError("shard_factor: tiles must cover each request's "
                         "cells once, in order")


def _tiles(requests: np.ndarray) -> np.ndarray:
    n = requests[:, REQ_N]
    per = -(-n // TILE)
    cell, owner = _expand(np.zeros_like(per), per)
    return np.stack([owner, cell * TILE], axis=1).astype(I64) \
        if len(owner) else np.zeros((0, 2), I64)


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
        requests = np.array(reqs, I64).reshape(-1, 8)
        return Packed(
            operands=np.concatenate(parts).astype(I64) if parts
            else np.zeros(0, I64),
            rows=np.array(rows, I64).reshape(-1, 3), requests=requests,
            steps=np.array(steps, I64).reshape(-1, 3),
            tiles=_tiles(requests))

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


def shard_factor_plain(dims: torch.Tensor, sizes: torch.Tensor,
                       steps) -> torch.Tensor:
    """One request's step program as masked int64 tensor ops: ``dims`` is
    ``(n_dims, n)``, ``sizes`` is ``(n_axes, n)``, the result ``(n,)``."""
    st = _check_steps(dims, sizes, steps)
    n = dims.shape[1]
    one = torch.ones((n,), dtype=torch.int64, device=dims.device)
    totals = [one] * dims.shape[0]
    used = [torch.zeros((n,), dtype=torch.bool, device=dims.device)
            ] * sizes.shape[0]
    denom = one
    assigned = torch.zeros((n,), dtype=torch.bool, device=dims.device)
    for d, a, fl in st.tolist():
        if fl == _EXTRA_FIRST:
            assigned = torch.zeros_like(assigned)
        sv = sizes[a]
        ok = (dims[d] % (totals[d] * sv) == 0) & ~used[a]
        if fl:
            ok = ok & ~assigned
        mul = torch.where(ok, sv, one)
        totals[d] = totals[d] * mul
        denom = denom * mul
        used[a] = used[a] | ok
        if fl:
            assigned = assigned | ok
    return denom


def shard_factor_batch_plain(b: DevicePacked) -> torch.Tensor:
    """The batched function in plain PyTorch on ``b``'s device: each
    request's operand rows read through their descriptors (stride-0
    views where they broadcast), :func:`shard_factor_plain` per request.
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
        out[req[REQ_OUT]:req[REQ_OUT] + n] = shard_factor_plain(
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
    tensors = (b.operands, b.rows, b.requests, b.steps, b.tiles)
    host = (b.host.operands, b.host.rows, b.host.requests, b.host.steps,
            b.host.tiles)
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
            b.operands.data_ptr(), b.rows.data_ptr(),
            b.requests.data_ptr(), b.steps.data_ptr(), b.tiles.data_ptr(),
            out.data_ptr(), n_tiles, stream)
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
    requests = np.array([[n, max(n, 1), 0, 0, n_dims, n_axes, 0, len(st)]],
                        I64)
    rows = np.array([(k * n, 0, 1) for k in range(n_dims + n_axes)],
                    I64).reshape(-1, 3)
    ops = torch.cat([dims.reshape(-1), sizes.reshape(-1)]).cpu().numpy()
    return shard_factor_batch(Packed(ops, rows, requests, st,
                                     _tiles(requests)).to(dims.device))


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
