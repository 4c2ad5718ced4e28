"""Shard factor: the greedy mesh-axis assignment behind every shard
denominator of the columnar table build.

Every TermSpec of the sweep resolves its shard denominator through the
greedy pass of ``mesh_ctx.assign_axes`` (divisibility masks,
one-use-per-axis, the FSDP/ZeRO ``extra`` sweep), a few hundred times per
grid.  The numpy transliteration in ``core.batch.batch_shard_factor``
stays the host path; this module *packs* the greedy program — the
(dim, axis, pass) step sequence the host loops walk — into flat int32
step triples and evaluates all cells of the broadcast domain in one pass:

* :func:`shard_factor_tensors` — the wrapper: on CUDA tensors it launches
  the hand-written kernel ``csrc/shard_factor.cu`` (which replaces the TPU
  kernel ``repro/kernels/shard_factor.py::_pallas_kernel``); on CPU
  tensors it takes the plain version.  It never falls back: CUDA tensors
  the kernel does not take raise.
* :func:`shard_factor_plain` — the same step program as masked
  ``torch.where`` / ``%`` int64 ops, the cross-check on the device and
  the CPU path.
* :func:`shard_factor` — the drop-in twin of
  ``core.batch.batch_shard_factor`` (numpy / ints in, numpy out) that the
  host table build calls: packs the program, stacks and uploads the
  broadcast operands, runs the wrapper on ``device``.
* ``launches`` — how many times the kernel was launched.

Bound on an H100: bytes, ``(n_dims + n_axes + 1) * 8 * n``; at the
sweep's sizes (a few thousand cells per call) that is far below a
microsecond, so a call costs its launch plus, on the host-callable path,
the upload and the read-back.  The kernel reads the step program as data
(one compilation serves every program).

Exactness: the packed form drops the host path's ``live`` size-1 axis
skip per cell — a size-1 axis multiplies every factor by 1 and marking it
used only ever blocks another x1 attempt, so including such steps is
value-identical per element.  Axes that are 1 in EVERY cell are still
dropped host-side as a pure optimisation.  Everything is int64 with
floor division; parity with the reference package's numpy and scalar
paths is asserted on randomized programs in
tests/test_torch_shard_factor.py, kernel-vs-plain equality on the device
by ``chip_smoke.py``.

``use_backend(device)`` installs :func:`shard_factor` as ``core.batch``'s
shard-factor implementation for the dynamic extent of the context, so a
columnar sweep's table build routes every denominator through the kernel.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from repro_torch.mesh_ctx import PIPE_AXIS

I64 = np.int64

# fixed limits of the kernel (csrc/shard_factor.cu: SF_MAX_*)
MAX_DIMS = 8
MAX_AXES = 8
MAX_STEPS = 128

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


# ---------------------------------------------------------------------------
# plain version + kernel wrapper (tensors in, tensor out)
# ---------------------------------------------------------------------------


def _check(dims: torch.Tensor, sizes: torch.Tensor, steps) -> np.ndarray:
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
    st = np.ascontiguousarray(np.asarray(steps, np.int32).reshape(-1, 3))
    n_dims, n_axes = dims.shape[0], sizes.shape[0]
    if len(st) < 1 or n_dims < 1 or n_axes < 1:
        raise ValueError(
            "shard_factor: needs at least one step, one dim and one axis "
            "(the caller returns ones for an empty program)")
    if (st[:, 0].min() < 0 or st[:, 0].max() >= n_dims
            or st[:, 1].min() < 0 or st[:, 1].max() >= n_axes
            or st[:, 2].min() < 0 or st[:, 2].max() > _EXTRA_FIRST):
        raise ValueError("shard_factor: step out of range for the operands")
    return st


def shard_factor_plain(dims: torch.Tensor, sizes: torch.Tensor,
                       steps) -> torch.Tensor:
    """The packed step program as masked int64 tensor ops: ``dims`` is
    ``(n_dims, n)``, ``sizes`` is ``(n_axes, n)``, the result ``(n,)``."""
    st = _check(dims, sizes, steps)
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


def shard_factor_tensors(dims: torch.Tensor, sizes: torch.Tensor,
                         steps) -> torch.Tensor:
    """Shard denominators of ``n`` cells: ``dims`` ``(n_dims, n)`` and
    ``sizes`` ``(n_axes, n)`` int64 on one device, ``steps`` the packed
    (dim, axis, flag) program.  Returns ``(n,)`` int64 on that device."""
    global launches
    st = _check(dims, sizes, steps)
    if dims.device.type == "cpu":
        return shard_factor_plain(dims, sizes, st)
    if dims.device.type != "cuda":
        raise ValueError(
            f"shard_factor runs on cuda or cpu tensors, got {dims.device}")
    if not (dims.is_contiguous() and sizes.is_contiguous()):
        raise ValueError(
            "shard_factor kernel takes contiguous (row-major) operands")
    n_dims, n = dims.shape
    n_axes = sizes.shape[0]
    if n_dims > MAX_DIMS or n_axes > MAX_AXES or len(st) > MAX_STEPS:
        raise ValueError(
            f"shard_factor kernel limits exceeded: {n_dims} dims (max "
            f"{MAX_DIMS}), {n_axes} axes (max {MAX_AXES}), {len(st)} "
            f"steps (max {MAX_STEPS})")
    out = torch.empty((n,), dtype=torch.int64, device=dims.device)
    if n == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(dims.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.shard_factor_launch(
            dims.data_ptr(), sizes.data_ptr(), st.ctypes.data,
            out.data_ptr(), n_dims, n_axes, len(st), n, stream)
    if rc != 0:
        raise RuntimeError(
            f"shard_factor kernel launch failed (cuda error {rc}) for "
            f"{n_dims} dims x {n_axes} axes x {len(st)} steps x {n} cells")
    launches += 1
    return out


# ---------------------------------------------------------------------------
# drop-in twin of core.batch.batch_shard_factor + backend switch
# ---------------------------------------------------------------------------


def shard_factor(dims, axes, sizes: dict, rules: dict, extra=(),
                 device="cuda") -> np.ndarray:
    """Drop-in twin of :func:`repro_torch.core.batch.batch_shard_factor`:
    ``dims`` entries and ``sizes`` values are ints or broadcastable int64
    arrays, the result a numpy array of the full broadcast shape — computed
    by :func:`shard_factor_tensors` on ``device`` (byte-identical int64)."""
    arrs = [np.asarray(d, I64) for d in dims]
    svals = {a: np.asarray(v, I64) for a, v in sizes.items()}
    shape = np.broadcast_shapes(*(a.shape for a in arrs),
                                *(v.shape for v in svals.values()))
    live = [a for a, v in svals.items() if np.any(v > 1)]
    steps, names = pack_program(axes, rules, extra, axis_names=live)
    if not steps or not arrs:
        return np.broadcast_to(np.ones((), I64), shape)

    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    a2 = np.stack([np.broadcast_to(a, shape).reshape(n) for a in arrs])
    s2 = np.stack([np.broadcast_to(svals[a], shape).reshape(n)
                   for a in names])
    device = torch.device(device)
    out = shard_factor_tensors(torch.from_numpy(a2).to(device),
                               torch.from_numpy(s2).to(device), steps)
    return out.cpu().numpy().reshape(shape)


@contextlib.contextmanager
def use_backend(device="cuda"):
    """Route ``core.batch.batch_shard_factor`` through :func:`shard_factor`
    on ``device`` for the dynamic extent of the context — the torch engine
    does this while it builds tables for a CUDA device, so every shard
    denominator of a sweep goes through the kernel.  The previous
    implementation is restored on exit, also after an exception."""
    from repro_torch.core import batch as B

    prev = B._shard_factor_impl
    B._shard_factor_impl = functools.partial(shard_factor, device=device)
    try:
        yield
    finally:
        B._shard_factor_impl = prev
