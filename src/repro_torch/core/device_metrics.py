"""Ground truth from the CUDA caching allocator around one real step.

The counterpart of the reference's ``core/xla_metrics.py``
``MemoryStats`` / ``memory_stats`` (``compiled.memory_analysis()`` of a
dry-run compile): the same four counters and ``total_bytes``, here read
from ``torch.cuda``'s allocator around one step on the card:

* ``baseline`` = ``memory_allocated()`` before the cell's parameters exist;
* ``start``    = allocated at the start of the step (parameters, optimizer
  state, inputs, cache: the step's arguments);
* ``end``      = allocated after it, following ``synchronize()``;
* ``peak``     = ``max_memory_allocated()`` after ``reset_peak_memory_stats()``
  at the start;

and ``argument = start - baseline``, ``output = end - baseline``, ``alias =
min(start, end) - baseline`` (what the step's outputs share with its
arguments: updated in place, or kept alive), ``temp = peak - baseline -
argument - output + alias``, so that ``total_bytes = peak - baseline``
exactly.

The allocator readings refuse a device that is not CUDA, and never
report a zero for a step they did not see.

The reference's other half (``cost_stats``, ``collective_stats``,
``loop_aware_stats``) parses a compiled XLA program's HLO text, which
PyTorch does not produce.  Its counterpart here is :class:`StepCounter`,
a ``TorchDispatchMode`` active while one step runs eagerly (the backward
and ``torch.utils.checkpoint``'s recompute run inside it too):

* **dot FLOPs** as the reference's ``loop_aware_stats`` counts them, 2 x
  output elements x contraction size, for ``aten.mm``, ``addmm``, ``bmm``,
  ``baddbmm`` and ``convolution`` (:func:`dot_flops`; einsum, ``matmul``
  and ``linear`` reach the dispatcher as these).  No model of the port
  runs a convolution; its backward (``convolution_backward``) is not
  counted.
* **bytes accessed**: each counted op's tensor operand and result bytes
  (views, allocations and the collectives' waits move none, and are not
  counted).  This is the port's own definition: XLA counts bytes per
  fusion, so no equality with the reference's number is meant.
* **collectives**: each ``c10d`` / ``_c10d_functional`` op (the MoE's
  ``torch.distributed`` calls; DTensor's ``redistribute`` / ``full_tensor``
  issue the functional ones) by kind, with its result bytes per device
  and the reference's ring estimate of its wire bytes
  (:func:`wire_bytes`).  A collective that DTensor issues inside another
  op's dispatch (an implicit redistribution) is not seen: the mode sees
  that op once, with its ``DTensor`` arguments, and counts it on their
  local shards.
* **the kernels**: a hand-written kernel launches through ``ctypes``,
  which the dispatcher does not see, so each wrapper calls
  :func:`report_kernel` where it launches, with the dot FLOPs its plain
  version performs and the bytes of the launch's operands and results.
  On the CPU the wrappers take their plain versions, whose aten ops are
  counted instead; nothing is counted twice.

An eager step hides no loop trip from the counter, so the record's
``loop_aware`` block equals ``cost`` and ``collectives`` under the
reference's key names (``launch.measure.record_for``); nothing is
counted twice for it.  The counter holds integers only, never a tensor:
holding one would move the allocator's readings.

Where the counters say how much, :func:`span` says where: the training
step, the model's blocks and loss chunks and the kernels' entry points
open named spans (every name starts with ``repro_torch.``).  Under
``torch.profiler`` each span is a ``record_function`` range, on the
profiler's clock, in the host's trace and beside the device operations
launched inside it.  The spans of a step's phases (its state, forward,
backward and optimizer) are also kept by an active :class:`SpanRecorder`:
host seconds and the allocator's readings at entry and exit.  With no
profiler and no recorder a span costs a flag check.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@dataclass
class MemoryStats:
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    alias_bytes: int

    @property
    def total_bytes(self) -> int:
        return (self.argument_bytes + self.temp_bytes
                + self.output_bytes - self.alias_bytes)


@dataclass
class StepMemory:
    """One step's allocator readings: the four counters and what they are
    built from, plus the caching allocator's own view (reserved bytes,
    retries after a failed ``cudaMalloc``)."""

    stats: MemoryStats
    baseline_bytes: int
    start_bytes: int
    end_bytes: int
    peak_bytes: int
    max_reserved_bytes: int
    alloc_retries: int

    @property
    def reserved_over_allocated(self) -> float:
        return self.max_reserved_bytes / self.peak_bytes


def _cuda(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"device_metrics reads the CUDA caching allocator; "
                         f"{dev} is not a CUDA device")
    if not torch.cuda.is_available():
        raise RuntimeError("device_metrics: no CUDA device is available")
    return dev


def allocated_bytes(device="cuda") -> int:
    """``memory_allocated()`` after the device's queued work is done."""
    dev = _cuda(device)
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev)


def memory_stats(step: Callable[[], Any], baseline: int,
                 device="cuda") -> tuple[StepMemory, Any]:
    """Run ``step()`` once on ``device`` between two allocator readings;
    ``baseline`` is :func:`allocated_bytes` from before the cell's
    parameters were made.  Returns the readings and what ``step``
    returned (kept alive, so ``end`` counts the step's outputs)."""
    dev = _cuda(device)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
    start = torch.cuda.memory_allocated(dev)
    out = step()
    torch.cuda.synchronize(dev)
    end = torch.cuda.memory_allocated(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    reserved = torch.cuda.max_memory_reserved(dev)
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries",
                                               0) - retries
    if not baseline <= min(start, end) <= peak:
        raise RuntimeError(f"allocator readings out of order: baseline "
                           f"{baseline}, start {start}, end {end}, peak "
                           f"{peak}")
    argument, output = start - baseline, end - baseline
    alias = min(start, end) - baseline
    stats = MemoryStats(argument_bytes=argument, output_bytes=output,
                        temp_bytes=peak - baseline - argument - output
                        + alias, alias_bytes=alias)
    if stats.temp_bytes < 0 or stats.total_bytes != peak - baseline:
        raise RuntimeError(f"allocator counters inconsistent: {stats}")
    return StepMemory(stats=stats, baseline_bytes=baseline,
                      start_bytes=start, end_bytes=end, peak_bytes=peak,
                      max_reserved_bytes=reserved,
                      alloc_retries=retries), out


# ---------------------------------------------------------------------------
# one step's work: dot FLOPs, bytes accessed, collectives
# ---------------------------------------------------------------------------


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=dict)         # op -> count
    operand_bytes: dict = field(default_factory=dict)  # op -> bytes (per dev)
    wire_bytes: dict = field(default_factory=dict)     # op -> est wire bytes

    @property
    def total_wire_bytes(self) -> int:
        return sum(self.wire_bytes.values())


def wire_bytes(op: str, nbytes: int, group: int) -> int:
    """The reference's ring estimate of one collective's wire bytes per
    device (``xla_metrics.collective_stats``): all-reduce 2(g-1)/g of its
    result, all-gather / reduce-scatter / all-to-all (g-1)/g, permute 1x."""
    if op == "all-reduce":
        return int(2 * nbytes * (group - 1) / max(group, 1))
    if op == "collective-permute":
        return nbytes
    return int(nbytes * (group - 1) / max(group, 1))


_aten = torch.ops.aten
_DOTS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm, _aten.convolution}
# ops that move no bytes: allocations and bookkeeping (views are found by
# their schema)
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided, _aten.detach,
         _aten.lift_fresh, _aten.set_, _aten.resize_,
         _aten._local_scalar_dense, _aten.record_stream}
_COLLECTIVE_KINDS = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                     ("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"))


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def dot_flops(packet, args, out) -> int:
    """2 x output elements x contraction size of one dot op (``packet`` an
    ``OpOverloadPacket`` of :data:`_DOTS`):

    * ``mm(a (M, K), b (K, N))``: 2 M N K;
    * ``addmm(c, a, b)``: the same of ``a @ b`` (the bias add is no dot);
    * ``bmm(a (B, M, K), b (B, K, N))``: 2 B M N K;
    * ``baddbmm(c, a, b)``: the same of ``a @ b``;
    * ``convolution(x, w, ...)``: 2 x output elements x (input channels
      per group x kernel elements), ``w`` (C_out, C_in / groups, k...);
      transposed, ``w`` (C_in, C_out / groups, k...), 2 x input elements x
      (output channels per group x kernel elements)."""
    if packet is _aten.mm:
        a, b = args[0], args[1]
        return 2 * a.shape[0] * b.shape[1] * a.shape[1]
    if packet is _aten.addmm:
        a, b = args[1], args[2]
        return 2 * a.shape[0] * b.shape[1] * a.shape[1]
    if packet is _aten.bmm:
        a, b = args[0], args[1]
        return 2 * a.shape[0] * a.shape[1] * b.shape[2] * a.shape[2]
    if packet is _aten.baddbmm:
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * b.shape[2] * a.shape[2]
    if packet is _aten.convolution:
        x, w, transposed = args[0], args[1], args[6]
        per = w.shape[1] * _numel(w.shape[2:])
        return 2 * (_numel(x.shape) if transposed
                    else _numel(out.shape)) * per
    raise ValueError(f"dot_flops: {packet} is not a dot op")


def _local(t):
    """A ``DTensor``'s local shard (the mode sees DTensor ops before the
    subclass unwraps them), a tensor as is."""
    inner = getattr(t, "_local_tensor", None)
    return inner if inner is not None else t


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        x = _local(x)
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(y) for y in x)
    return 0


def _local_args(args):
    return [_local(a) if isinstance(a, torch.Tensor) else a for a in args]


def _group_size(func, args, kwargs) -> int:
    """The size of the process group a collective op runs over: its
    ``group_size`` argument, its ``ProcessGroup`` argument or the group
    its ``group_name`` names."""
    import torch.distributed as dist
    bound = dict(kwargs)
    for arg, value in zip(func._schema.arguments, args):
        bound.setdefault(arg.name, value)
    if isinstance(bound.get("group_size"), int):
        return bound["group_size"]
    for arg in func._schema.arguments:
        value = bound.get(arg.name)
        if "ProcessGroup" in str(arg.type) and value is not None:
            # the dispatcher hands a c10d op its group boxed
            if not isinstance(value, dist.ProcessGroup):
                value = dist.ProcessGroup.unbox(value)
            return value.size()
    name = bound.get("group_name", bound.get("tag"))
    if isinstance(name, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(name).size()
    raise ValueError(f"{func}: no process group among its arguments")


_ACTIVE: list = []
# what each op is, looked up once per op: a collective, a composite op
# (implemented by other ops), one that moves no bytes, a dot, or another
_COLLECTIVE, _COMPOSITE_OP, _NO_BYTES, _DOT, _OTHER = range(5)
_KIND: dict = {}


def _kind(func) -> int:
    hit = _KIND.get(func)
    if hit is None:
        packet = func.overloadpacket
        if func.namespace in ("c10d", "_c10d_functional"):
            hit = _COLLECTIVE
        elif packet in _DOTS:
            hit = _DOT
        elif torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            hit = _COMPOSITE_OP
        elif packet in _FREE or func.is_view:
            hit = _NO_BYTES
        else:
            hit = _OTHER
        _KIND[func] = hit
    return hit


def report_kernel(tensors, flops: Optional[Callable[[], int]] = None
                  ) -> None:
    """Called by a kernel wrapper where it launches its kernel: the
    launch's operand and result ``tensors`` (their bytes) and ``flops()``,
    the dot FLOPs of its plain version (None: no dot), added to every
    active :class:`StepCounter`.  With no counter active it returns at
    once, before ``flops`` is called."""
    if not _ACTIVE:
        return
    nbytes = _tensor_bytes(tensors)
    n = 0 if flops is None else int(flops())
    for counter in _ACTIVE:
        counter.flops += n
        counter.bytes_accessed += nbytes
        counter.kernel_launches += 1


# ---------------------------------------------------------------------------
# spans: where in the step the work is
# ---------------------------------------------------------------------------

SPAN_PREFIX = "repro_torch."
_RECORDERS: list = []
_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


@dataclass
class SpanRecord:
    """One phase span a :class:`SpanRecorder` saw.  The allocator's
    readings (``memory_allocated()`` at entry and exit,
    ``max_memory_allocated()`` at exit) are None off CUDA."""

    name: str
    parent: Optional[str]
    seconds: float
    allocated_in: Optional[int]
    allocated_out: Optional[int]
    peak_out: Optional[int]


class SpanRecorder:
    """Keeps the phase spans entered while it is active (``with
    SpanRecorder(device) as rec:``) as :class:`SpanRecord` s in
    ``records``, in the order they close, each with its enclosing phase
    span.  Phase spans open on the thread that calls the step.  It reads
    the allocator without synchronising and holds no tensor."""

    def __init__(self, device="cuda"):
        dev = torch.device(device)
        self._cuda = dev if dev.type == "cuda" else None
        self.records: list = []
        self._open: list = []

    def __enter__(self):
        _RECORDERS.append(self)
        return self

    def __exit__(self, *exc):
        _RECORDERS.remove(self)
        return False

    def _allocated(self) -> Optional[int]:
        return None if self._cuda is None else \
            torch.cuda.memory_allocated(self._cuda)

    def _enter(self, name: str) -> None:
        self._open.append((name, time.perf_counter(), self._allocated()))

    def _exit(self) -> None:
        name, t0, allocated_in = self._open.pop()
        self.records.append(SpanRecord(
            name=name, parent=self._open[-1][0] if self._open else None,
            seconds=time.perf_counter() - t0, allocated_in=allocated_in,
            allocated_out=self._allocated(),
            peak_out=None if self._cuda is None else
            torch.cuda.max_memory_allocated(self._cuda)))


class _Span:
    __slots__ = ("_name", "_range", "_recorders")

    def __init__(self, name: str, recorders: tuple):
        self._name, self._recorders = name, recorders
        self._range = torch.profiler.record_function(name) \
            if _profiling() else None

    def __enter__(self):
        for r in self._recorders:
            r._enter(self._name)
        if self._range is not None:
            self._range.__enter__()

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        for r in self._recorders:
            r._exit()
        return False


def span(name: str, phase: bool = False):
    """A context manager around one region of the program named ``name``
    (``repro_torch.<layer>.<what>``): a ``record_function`` range while
    the torch profiler is on, and with ``phase`` a :class:`SpanRecord` in
    each active :class:`SpanRecorder`.  Otherwise a shared context that
    does nothing: no dispatcher call, no allocation."""
    recorders = tuple(_RECORDERS) if phase else ()
    if not recorders and not _profiling():
        return _OFF
    return _Span(name, recorders)


class StepCounter(TorchDispatchMode):
    """Counts what runs while it is active (``with StepCounter() as c:``):
    ``flops`` (dot FLOPs), ``bytes_accessed``, ``kernel_launches``
    (reports of the kernel wrappers) and the collectives per kind.
    Integers only."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.kernel_launches = 0
        self.collectives = CollectiveStats()
        self._depth = 0

    def __enter__(self):
        if not self._depth:
            _ACTIVE.append(self)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if not self._depth:
            _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _kind(func)
        if kind == _COMPOSITE_OP:
            # where autograd is off (inference mode) a composite op
            # (matmul, linear, einsum, ...) reaches the mode whole: count
            # the ops it is made of, as autograd's dispatch shows them
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if kind == _COLLECTIVE:
            self._collective(func, args, kwargs, out)
        elif kind != _NO_BYTES:
            if kind == _DOT:
                self.flops += dot_flops(func.overloadpacket,
                                        _local_args(args), _local(out))
            self.bytes_accessed += _tensor_bytes(args) + _tensor_bytes(out)
            if kwargs:
                self.bytes_accessed += _tensor_bytes(list(kwargs.values()))
        return out

    def _collective(self, func, args, kwargs, out) -> None:
        name = func._opname
        kind = next((k for key, k in _COLLECTIVE_KINDS if key in name), None)
        if kind is None:                     # waits, barriers, broadcasts
            return
        # the functional ops return their result; the c10d ops write it
        # into their first argument
        result = out if func.namespace == "_c10d_functional" else args[0]
        nbytes = _tensor_bytes(result)
        group = _group_size(func, args, kwargs)
        c = self.collectives
        c.counts[kind] = c.counts.get(kind, 0) + 1
        c.operand_bytes[kind] = c.operand_bytes.get(kind, 0) + nbytes
        c.wire_bytes[kind] = c.wire_bytes.get(kind, 0) \
            + wire_bytes(kind, nbytes, group)


def count_step(step: Callable[[], Any]) -> tuple[StepCounter, Any]:
    """Run ``step()`` once under a :class:`StepCounter` -> (the counter,
    what ``step`` returned).  On a CUDA device the counted work is
    enqueued, not finished, when this returns; the counts do not depend
    on it."""
    with StepCounter() as counter:
        out = step()
    return counter, out


def cost_blocks(counter: StepCounter) -> dict:
    """The record's ``cost``, ``collectives`` and ``loop_aware`` blocks
    under the reference's key names (``launch/dryrun.py``); an eager step
    has no loop the counter missed, so ``loop_aware`` repeats the other
    two."""
    c = counter.collectives
    return {
        "cost": {"flops_per_device": counter.flops,
                 "bytes_accessed_per_device": counter.bytes_accessed},
        "collectives": {
            "counts": dict(c.counts),
            "operand_bytes_per_device": dict(c.operand_bytes),
            "wire_bytes_per_device": dict(c.wire_bytes),
            "total_wire_bytes_per_device": c.total_wire_bytes,
        },
        "loop_aware": {
            "flops_per_device": counter.flops,
            "bytes_accessed_per_device": counter.bytes_accessed,
            "collective_counts": dict(c.counts),
            "collective_wire_bytes": dict(c.wire_bytes),
            "total_wire_bytes_per_device": c.total_wire_bytes,
        },
    }
