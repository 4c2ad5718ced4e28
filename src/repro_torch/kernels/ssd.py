"""The Mamba-2 SSD (state-space duality) scan: the chunked dual form behind
every prefill of the SSM family, forward only.

* :func:`ssd_scan` — the wrapper: on CUDA tensors it launches one of the
  hand-written kernels of ``csrc/ssd.cu`` (which replace the TPU kernel
  ``repro/kernels/ssd.py::_ssd_kernel``): bf16 inputs go to
  ``ssd_scan_kernel_mma`` on the tensor cores, fp32 inputs to the fp32 FMA
  ``ssd_scan_kernel``.  On CPU tensors it takes the plain version.  It
  never falls back: CUDA tensors the kernels do not take raise.
* :func:`ssd_scan_plain` — the same function in plain fp32 PyTorch, the
  chunked form with the reference kernel's algebra (per chunk the decay
  matrix ``L``, ``C B^T``, the diagonal and the off-diagonal term, then the
  state pass).  The cross-check on the device and the CPU path.
* ``launches`` — how many times a kernel was launched.
* :func:`plain_flops` — the dot FLOPs a launch reports to an active
  ``core.device_metrics.StepCounter``: the plain version's products.

Shapes (group size 1, the group dim squeezed): x ``(b, S, H, P)``, dt
``(b, S, H)`` fp32 after softplus, A ``(H,)`` fp32 and negative, B and C
``(b, S, N)`` in x's type (fp32 or bf16).  Returns y ``(b, S, H, P)`` in
x's type and the final state ``(b, H, P, N)`` fp32.  ``chunk`` is cut to
S; the last chunk is the ragged rest, which is the reference's zero
padding (dt = 0 there).

The kernels read x, B and C in place through their batch, token (and
x's head) strides (the model hands views into the conv output), so they
need only be dense along their last dims; the bf16 kernel copies x in
16-byte and B, C in 8- or 16-byte pieces, so there x must start and step
on the 16-byte grid and B and C on the 8-byte grid.  Operands that are
not so are copied first (never sent to the plain version).

Shapes: the kernels are compiled for head widths ``HEAD_DIMS`` and take
any N that is a multiple of 4 (the bf16 kernel pads it to 16 with zeros
in shared memory).  :func:`kernel_plan` runs any ``1 <= P <= 256`` and
``1 <= N <= 512`` on them: P rounded up to 16 with zero columns (and N to
4) and cut into slabs of compiled widths, one launch per width with its
slabs an index of the grid; where the plan's launch would not fit a
block's shared memory at chunk 256, narrower slabs, then N in pieces,
one launch each, y summed over the pieces in fp32.  All of it is exact:
zero columns of x give zero columns of y and rows of the state, zero
columns of B and C change no ``C B^T``, the columns of y and rows of the
state are independent given dt, A, B and C, and y is linear in the N
pieces of ``C B^T`` and ``C state^T`` while each piece's state columns
evolve alone.  What stays refused, with a ValueError naming the limit: P
above 256, N above 512, and a chunk whose plan does not fit shared memory
(the limit the compiled instance had: at mamba2's P 64 / N 128, chunks up
to 7,872 in bf16).

Design of the bf16 kernel: one block of 4 warps per (b, h) walks the
chunks in order with the fp32 state in shared memory; per 64-row
sub-tiles, ``C state^T``, ``S = C B^T`` and ``(L o S dt) x`` on m16n8k16
bf16 ``mma.sync`` (x, B and C exact, the score operand rounded once, the
state rounded once as the operand of ``C state^T``); the state update
``(x w)^T B`` with ``w = dt exp(a_tot - a_cum)`` carries ``x w`` as two
bf16 parts (hi + lo), since one rounding misses the state's 1e-4;
``cp.async`` double-buffered sub-tiles, each query sub-tile visiting the
resident key sub-tile first; 109,584 bytes of shared memory at the
serving config, two blocks per SM.

Bound on an H100: bytes (x, y, dt, B, C and the state) against operations
(the lower triangle of ``C B^T`` once per (b, chunk), since heads share B
and C, its masked product with x and ``4QNP`` per (b, h, chunk)) at the
bf16 tensor-core rate.  Tolerance: 1e-4 in fp32 (the reference's own,
against the sequential recurrence); bf16 y within 2e-2 of its scale (one
rounding of y), the fp32 state within 1e-4 of its scale.
tests/test_torch_ssd.py holds the plain version against the reference
package's Pallas kernel in interpret mode, its recurrence and its lax twin,
and a rounding model of the bf16 kernel against the plain version;
``chip_smoke.py`` the kernels against the plain version on the card.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.device_metrics import report_kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)       # the kernels' template instances
TQ, LDK = 64, 68                    # sub-tile rows, padded n-major stride
MMA_WARPS = 4                       # warps of the bf16 kernel's block
MAX_SMEM = 232448                   # what an H100 block may opt into
MAX_P, MAX_N = 256, 512             # the widest head and state taken
PLAN_CHUNK = 256                    # the chunk a plan is fitted at

launches = 0


def smem_bytes(P: int, N: int, chunk: int) -> int:
    """The fp32 kernel's dynamic shared memory for (P, N, chunk): the C and
    B sub-tiles (n-major), the x dt rows, the score tile, the state and the
    chunk's running sum of a, all fp32."""
    return 4 * (2 * N * LDK + TQ * P + TQ * LDK + N * P
                + -(-chunk // TQ) * TQ)


def mma_smem_bytes(P: int, N: int, chunk: int) -> int:
    """The bf16 tensor-core kernel's dynamic shared memory for (P, N,
    chunk) (``MmaLayout`` in csrc/ssd.cu): the fp32 state, the bf16 C
    sub-tile, two B and two x sub-tiles, rows padded by 16 bytes and N by
    zeros to a multiple of 16, then dt of two chunks, a_cum and w of the
    chunk and the scan's warp totals in fp32."""
    ld = -(-N // 16) * 16 + 8
    qpad = -(-chunk // TQ) * TQ
    return (4 * P * ld + 2 * 3 * TQ * ld + 2 * 2 * TQ * (P + 8)
            + 4 * (4 * qpad + MMA_WARPS))


def _on_grid(t: torch.Tensor, n_bytes: int) -> bool:
    """t's start and its strides but the last (batch, token and x's head)
    lie on the n_bytes grid."""
    step = n_bytes // t.element_size()
    return t.data_ptr() % n_bytes == 0 and all(
        st % step == 0 for st in t.stride()[:-1])


@dataclasses.dataclass(frozen=True)
class Plan:
    """How :func:`ssd_scan` runs a (P, N) problem on the kernels: x, y and
    the state at width ``P`` (the head rounded up to 16), B, C and the
    state at width ``N`` (rounded up to 4); ``slabs`` the launches over P,
    each ``(p0, width, count)``: ``count`` slabs of ``width`` from column
    ``p0``; ``pieces`` the walk over N, each ``(n0, width)``."""
    P: int
    N: int
    slabs: tuple
    pieces: tuple

    @property
    def launches(self) -> int:
        return len(self.slabs) * len(self.pieces)


def _slabs(P: int, widest: int) -> tuple:
    """P (a multiple of 16) as slabs of compiled widths up to ``widest``,
    the widest first."""
    out, p0 = [], 0
    while p0 < P:
        w = max(h for h in HEAD_DIMS if h <= min(widest, P - p0))
        count = (P - p0) // w
        out.append((p0, w, count))
        p0 += count * w
    return tuple(out)


def _pieces(N: int, k: int) -> tuple:
    """N (a multiple of 4) in ``k`` pieces of a multiple of 16 (the last
    the rest)."""
    if k == 1:
        return ((0, N),)
    w = -(-N // (16 * k)) * 16
    return tuple((n0, min(w, N - n0)) for n0 in range(0, N, w))


def _smem_of(dtype) -> "callable":
    return mma_smem_bytes if dtype == torch.bfloat16 else smem_bytes


@functools.lru_cache(maxsize=None)
def kernel_plan(P: int, N: int, dtype) -> Plan:
    """The launches for head width P and state width N in ``dtype``: of
    the slab widths and N pieces whose widest launch fits a block's shared
    memory at chunk ``PLAN_CHUNK``, the fewest (slab, piece) programs,
    then the fewest pieces.  A compiled P that fits keeps its one launch.
    ValueError above ``MAX_P`` / ``MAX_N``."""
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N):
        raise ValueError(f"ssd_scan kernel takes head dims 1 <= P <= "
                         f"{MAX_P} and state widths 1 <= N <= {MAX_N}, got "
                         f"P {P}, N {N}")
    Pp, Np = -(-P // 16) * 16, max(4, -(-N // 4) * 4)
    smem = _smem_of(dtype)
    best = None
    for widest in (128, 64, 32, 16):
        slabs = _slabs(Pp, widest)
        w = max(width for _, width, _ in slabs)
        k = 1
        while smem(w, max(n for _, n in _pieces(Np, k)), PLAN_CHUNK) > \
                MAX_SMEM and -(-Np // k) > 16:
            k *= 2
        pieces = _pieces(Np, k)
        if smem(w, max(n for _, n in pieces), PLAN_CHUNK) > MAX_SMEM:
            continue
        cost = (sum(c for _, _, c in slabs) * len(pieces), len(pieces))
        if best is None or cost < best[0]:
            best = (cost, Plan(Pp, Np, slabs, pieces))
    return best[1]


def plan_smem(plan: Plan, chunk: int, dtype) -> int:
    """The shared memory of the plan's widest launch at ``chunk``."""
    smem = _smem_of(dtype)
    return max(smem(w, n, chunk) for _, w, _ in plan.slabs
               for _, n in plan.pieces)


def _check(x, dt, A, B, C, chunk) -> None:
    if not all(isinstance(t, torch.Tensor) for t in (x, dt, A, B, C)):
        raise TypeError("ssd_scan takes torch.Tensors")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan takes x (b, S, H, P), got "
                         f"{tuple(x.shape)}")
    b, S, H, P = x.shape
    if tuple(dt.shape) != (b, S, H) or tuple(A.shape) != (H,) or \
            B.dim() != 3 or tuple(B.shape[:2]) != (b, S) or \
            C.shape != B.shape:
        raise ValueError(
            f"ssd_scan takes x (b, S, H, P), dt (b, S, H), A (H,) and B, C "
            f"(b, S, N), got {tuple(x.shape)}, {tuple(dt.shape)}, "
            f"{tuple(A.shape)}, {tuple(B.shape)}, {tuple(C.shape)}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, B and C of "
                        f"one type, got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes float32 dt and A, got {dt.dtype} "
                        f"and {A.dtype}")
    if len({t.device for t in (x, dt, A, B, C)}) != 1:
        raise ValueError("ssd_scan: all operands must be on one device")
    if isinstance(chunk, bool) or not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"ssd_scan takes a positive int chunk, got "
                         f"{chunk!r}")
    if S < 1:
        raise ValueError("ssd_scan takes at least one token")


def check_kernel_operands(x, dt, A, B, C, chunk: int) -> int:
    """Raise ValueError where one launch does not take checked operands as
    they are (any device): x the launch's first slab (a compiled width,
    dense along p, its head stride at least its width), B and C the
    piece's columns (a multiple of 4, dense along n); else its
    shared-memory bytes for ``chunk`` (already cut to S)."""
    P = x.shape[3]
    N = B.shape[-1]
    if P not in HEAD_DIMS or N % 4 or N < 4:
        raise ValueError(f"ssd_scan kernel takes head dims {HEAD_DIMS} and "
                         f"a state width that is a multiple of 4, got P {P},"
                         f" N {N}")
    if x.stride(3) != 1 or (x.shape[2] > 1 and x.stride(2) < P) or \
            B.stride(2) != 1 or C.stride(2) != 1 or \
            not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("ssd_scan kernel takes x dense along P, B and C "
                         "dense along N, contiguous dt and A")
    if x.dtype == torch.bfloat16 and not (
            _on_grid(x, 16) and _on_grid(B, 8) and _on_grid(C, 8)):
        raise ValueError("ssd_scan bf16 kernel copies x in 16-byte and B, C "
                         "in 8-byte pieces: x must start and step on the "
                         "16-byte grid, B and C on the 8-byte grid")
    need = _smem_of(x.dtype)(P, N, chunk)
    if need > MAX_SMEM:
        raise ValueError(f"ssd_scan kernel: P {P}, N {N}, chunk {chunk} "
                         f"need {need} B of shared memory (at most "
                         f"{MAX_SMEM})")
    return need


def _dense(t: torch.Tensor, grid: int) -> torch.Tensor:
    """t, or a contiguous copy where it is not dense along its last dim
    or (bf16) off the ``grid``-byte grid."""
    if t.stride(-1) == 1 and (t.dtype != torch.bfloat16
                              or _on_grid(t, grid)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def kernel_operands(x, dt, A, B, C, plan: Plan) -> tuple:
    """``(x, dt, A, B, C)`` as the plan's launches read them: x zero-padded
    to ``plan.P`` columns, B and C to ``plan.N``, each a copy only where it
    is padded, not dense along its last dim or (bf16) off its grid; dt and
    A contiguous."""
    if x.shape[3] != plan.P:
        x = F.pad(x, (0, plan.P - x.shape[3]))
    else:
        x = _dense(x, 16)
    B, C = ((F.pad(t, (0, plan.N - t.shape[2])) if t.shape[2] != plan.N
             else _dense(t, 8)) for t in (B, C))
    return x, dt.contiguous(), A.contiguous(), B, C


def plain_flops(b: int, S: int, H: int, P: int, N: int,
                chunk: int = 256) -> int:
    """The dot FLOPs of :func:`ssd_scan_plain`: per chunk of Q rows (the
    last zero-padded to Q), ``C B^T`` (2 b Q^2 N, heads share B and C),
    the masked product with x (2 b H Q^2 P), ``C state^T`` and the state
    update (2 b H Q N P each)."""
    Q = min(chunk, S)
    n = -(-S // Q)
    return n * (2 * b * Q * Q * N + 2 * b * H * Q * Q * P
                + 4 * b * H * Q * N * P)


def ssd_scan_plain(x, dt, A, B, C, chunk: int = 256):
    """The chunked SSD in plain fp32 torch ops -> ``(y, final_state)``."""
    _check(x, dt, A, B, C, chunk)
    b, S, H, P = x.shape
    N = B.shape[-1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    xdt = (xf * dtf[..., None]).permute(0, 2, 1, 3)       # (b, H, Sp, P)
    a = (dtf * A.float()).permute(0, 2, 1)                # (b, H, Sp)
    idx = torch.arange(chunk, device=x.device)
    above = idx[:, None] < idx[None, :]
    st = x.new_zeros((b, H, P, N), dtype=torch.float32)
    ys = []
    for c0 in range(0, S + pad, chunk):
        xq = xdt[:, :, c0:c0 + chunk]                     # (b, H, Q, P)
        Bq, Cq = Bf[:, c0:c0 + chunk], Cf[:, c0:c0 + chunk]  # (b, Q, N)
        a_cum = a[:, :, c0:c0 + chunk].cumsum(-1)         # (b, H, Q)
        a_tot = a_cum[..., -1:]
        # L[i, j] = exp(a_cum[i] - a_cum[j]) for i >= j: exp(-inf) = 0
        # above the diagonal, never exp of a positive difference
        seg = a_cum[..., :, None] - a_cum[..., None, :]
        L = torch.exp(seg.masked_fill(above, float("-inf")))
        scores = Cq @ Bq.transpose(1, 2)                  # (b, Q, Q)
        y_diag = (L * scores[:, None]) @ xq
        y_off = (Cq[:, None] @ st.transpose(-1, -2)) \
            * torch.exp(a_cum)[..., None]
        decay_to_end = torch.exp(a_tot - a_cum)           # (b, H, Q)
        st = st * torch.exp(a_tot)[..., None] \
            + (xq * decay_to_end[..., None]).transpose(-1, -2) @ Bq[:, None]
        ys.append((y_diag + y_off).to(x.dtype))
    y = torch.cat(ys, dim=2)[:, :, :S].permute(0, 2, 1, 3).contiguous()
    return y, st


def ssd_scan(x, dt, A, B, C, chunk: int = 256):
    """Chunked SSD -> ``(y (b, S, H, P), final_state (b, H, P, N) fp32)``;
    the kernel on CUDA tensors (:func:`kernel_plan`'s launches), the plain
    version on CPU tensors."""
    global launches
    _check(x, dt, A, B, C, chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu tensors, got "
                         f"{x.device}")
    b, S, H, P = x.shape
    N = B.shape[-1]
    chunk = min(chunk, S)
    plan = kernel_plan(P, N, x.dtype)
    need = plan_smem(plan, chunk, x.dtype)
    if need > MAX_SMEM:
        raise ValueError(f"ssd_scan kernel: P {P}, N {N}, chunk {chunk} "
                         f"need {need} B of shared memory (at most "
                         f"{MAX_SMEM}) on the plan's widest launch")
    if H * b * max(c for _, _, c in plan.slabs) > 0x7FFFFFFF:
        raise ValueError(f"ssd_scan kernel: {H} heads x batch {b} exceed a "
                         f"grid's 2**31 - 1 blocks")
    xk, dtk, Ak, Bk, Ck = kernel_operands(x, dt, A, B, C, plan)
    y = torch.empty((b, S, H, plan.P), dtype=x.dtype, device=x.device)
    state = torch.empty((b, H, plan.P, plan.N), dtype=torch.float32,
                        device=x.device)
    # the bf16 kernel sums an N walk's pieces of y in fp32 here
    yacc = torch.empty(y.shape, dtype=torch.float32, device=x.device) \
        if x.dtype == torch.bfloat16 and len(plan.pieces) > 1 else None
    import ctypes
    strides = (ctypes.c_longlong * 6)(xk.stride(0), xk.stride(1),
                                      Bk.stride(0), Bk.stride(1),
                                      Ck.stride(0), Ck.stride(1))
    from repro_torch.kernels import _build
    lib = _build.load()
    last = len(plan.pieces) - 1
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i, (n0, nw) in enumerate(plan.pieces):
            Bs, Cs = Bk[..., n0:n0 + nw], Ck[..., n0:n0 + nw]
            for p0, w, count in plan.slabs:
                xs = xk[..., p0:p0 + w]
                need = check_kernel_operands(xs, dtk, Ak, Bs, Cs, chunk)
                geom = (ctypes.c_longlong * 8)(
                    xk.stride(2), plan.P, p0, count, plan.N, n0,
                    int(i == 0), int(i == last))
                # x from its first column: the kernel adds each slab's
                rc = lib.ssd_scan_launch(
                    xk.data_ptr(), dtk.data_ptr(), Ak.data_ptr(),
                    Bs.data_ptr(), Cs.data_ptr(), y.data_ptr(),
                    state.data_ptr(), _DTYPES[x.dtype], b, S, H, w, nw,
                    chunk, strides, need, geom,
                    None if yacc is None else yacc.data_ptr(), stream)
                if rc != 0:
                    raise RuntimeError(
                        f"ssd_scan kernel launch failed (cuda error {rc}) "
                        f"for x {tuple(x.shape)}, N {N}, chunk {chunk}, "
                        f"{x.dtype}: slabs {(p0, w, count)}, state "
                        f"columns {(n0, nw)}")
                launches += 1
    if plan.P != P:
        y = y[..., :P].contiguous()
    if (plan.P, plan.N) != (P, N):
        state = state[:, :, :P, :N].contiguous()
    report_kernel((x, dt, A, B, C, y, state),
                  lambda: plain_flops(b, S, H, P, N, chunk))
    return y, state
