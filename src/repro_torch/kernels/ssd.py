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

The kernels read x, B and C in place through their batch and token
strides (the model hands views into the conv output), so they need only
be dense along their last dims (x along h and p); the bf16 kernel copies
x in 16-byte and B, C in 8- or 16-byte pieces, so there x must start and
step on the 16-byte grid and B and C on the 8-byte grid.  N is any
multiple of 4 (the bf16 kernel pads it to 16 with zeros in shared
memory); P is one of ``HEAD_DIMS``.

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

import torch
import torch.nn.functional as F

from repro_torch.core.device_metrics import report_kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)       # the kernels' template instances
TQ, LDK = 64, 68                    # sub-tile rows, padded n-major stride
MMA_WARPS = 4                       # warps of the bf16 kernel's block
MAX_SMEM = 232448                   # what an H100 block may opt into

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
    """t's start and batch / token strides lie on the n_bytes grid."""
    step = n_bytes // t.element_size()
    return t.data_ptr() % n_bytes == 0 and t.stride(0) % step == 0 and \
        t.stride(1) % step == 0


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
    """Raise ValueError where the kernel does not take checked operands
    (any device); else its shared-memory bytes for ``chunk`` (already cut
    to S)."""
    b, _, _, P = x.shape
    N = B.shape[-1]
    if P not in HEAD_DIMS or N % 4:
        raise ValueError(f"ssd_scan kernel takes head dims {HEAD_DIMS} and "
                         f"a state width that is a multiple of 4, got P {P},"
                         f" N {N}")
    if x.stride(3) != 1 or x.stride(2) != P or B.stride(2) != 1 or \
            C.stride(2) != 1 or not (dt.is_contiguous()
                                     and A.is_contiguous()):
        raise ValueError("ssd_scan kernel takes x dense along (H, P), B and "
                         "C dense along N, contiguous dt and A")
    if x.dtype == torch.bfloat16 and not (
            _on_grid(x, 16) and _on_grid(B, 8) and _on_grid(C, 8)):
        raise ValueError("ssd_scan bf16 kernel copies x in 16-byte and B, C "
                         "in 8-byte pieces: x must start and step on the "
                         "16-byte grid, B and C on the 8-byte grid")
    need = (mma_smem_bytes if x.dtype == torch.bfloat16 else smem_bytes)(
        P, N, chunk)
    if need > MAX_SMEM or b > 65535:
        raise ValueError(f"ssd_scan kernel: P {P}, N {N}, chunk {chunk} "
                         f"need {need} B of shared memory (at most "
                         f"{MAX_SMEM}), batch at most 65535")
    return need


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
    the kernel on CUDA tensors, the plain version on CPU tensors."""
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
    need = check_kernel_operands(x, dt, A, B, C, chunk)
    y = torch.empty((b, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    import ctypes
    strides = (ctypes.c_longlong * 6)(x.stride(0), x.stride(1), B.stride(0),
                                      B.stride(1), C.stride(0), C.stride(1))
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr(), _DTYPES[x.dtype],
            b, S, H, P, N, chunk, strides, need, stream)
    if rc != 0:
        raise RuntimeError(
            f"ssd_scan kernel launch failed (cuda error {rc}) for x "
            f"{tuple(x.shape)}, N {N}, chunk {chunk}, {x.dtype}")
    launches += 1
    report_kernel((x, dt, A, B, C, y, state),
                  lambda: plain_flops(b, S, H, P, N, chunk))
    return y, state
