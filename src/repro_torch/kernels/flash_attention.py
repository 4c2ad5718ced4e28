"""Flash attention, forward and backward: the attention core of every GQA
layer and of the vision tower.

* :func:`flash_fwd` — the forward's wrapper: on CUDA tensors it launches
  the hand-written kernels of ``csrc/flash_attention.cu`` (which replace
  the TPU kernel ``repro/kernels/flash_attention.py::_fwd_kernel``): bf16
  on the tensor cores (``flash_fwd_kernel_mma``), fp32 in fp32 FMA
  (``flash_fwd_kernel``); on CPU tensors it takes the plain version.  It
  never falls back: CUDA tensors the kernels do not take raise.
* :func:`flash_bwd` — the backward's wrapper, the same way: on CUDA
  tensors it launches the two kernels of ``csrc/flash_attention_bwd.cu``
  through :func:`flash_bwd_dq`, the q-stationary dq pass (replaces
  ``_dq_kernel``; it also computes ``delta = sum(dout * out)`` of its
  rows; bf16 on the tensor cores, ``flash_bwd_dq_kernel_mma``), and then
  :func:`flash_bwd_dkv`, the kv-stationary dk / dv pass (replaces
  ``_dkv_kernel``; each block sums over the G query heads of its group
  and every q tile; bf16 on the tensor cores,
  ``flash_bwd_dkv_kernel_mma``).  Each block writes its tile of a gradient
  once: no atomics, bit-equal results from launch to launch.
* :func:`flash_fwd_plain`, :func:`flash_bwd_plain` — the same functions
  in plain PyTorch from the full fp32 score matrix, the backward by its
  explicit formulas (not autograd).  The cross-check on the device and
  the CPU path.
* ``launches``, ``dq_launches``, ``dkv_launches`` — how many times each
  kernel was launched.
* :func:`fwd_flops`, :func:`dq_flops`, :func:`dkv_flops` — the dot FLOPs
  each launch reports to an active ``core.device_metrics.StepCounter``:
  the products the plain versions compute (the whole ``Sq x Skv`` score
  matrix, causal or not, as the reference's chunked lax twin computes
  it), so a step counts the same FLOPs on either path.  The plain
  backward's five products are split between the passes: s, dp and dq to
  the dq pass, dv and dk to the dk / dv pass.

Layouts are the reference's: q ``(B, Sq, H, D)``, k ``(B, Skv, Hkv, D)``,
v ``(B, Skv, Hkv, Dv)`` -> out ``(B, Sq, H, Dv)`` in q's type and lse
``(B, H, Sq)`` fp32; the gradients take their inputs' shapes and types.
GQA maps q head ``h`` to kv head ``h // (H // Hkv)``; ``causal`` masks
``k_pos > q_offset + q_row``.

Bound on an H100: operations over the bf16 tensor-core peak — with
``scores = B*H*Sq*Skv`` (half of it when causal), ``2*scores*(D + Dv)``
forward (q k^T at D, P v at Dv), ``2*scores*(2D + Dv)`` for the dq pass
(s, dq at D; dp at Dv) and ``2*scores*(2D + 2Dv)`` for the dk / dv pass
(s, dk at D; dp, dv at Dv), FA2's count — against the bytes of the
tensors read and written once, each at its own width.  The bf16 kernels run on the tensor cores (bf16 products,
fp32 sums; before the second product the forward carries the
probabilities as two bf16 parts, the dq pass rounds dS to bf16 once, the
dk / dv pass P and dS, as FlashAttention-2 does); the fp32 kernels
compute in fp32 FMA (see the sources' notes).
Their times stand beside the bound in PERF.md.  The bf16 tensor-core
kernels copy with 16-byte ``cp.async``, so they take q, k, v, out / dout
and the gradients at 16-byte aligned addresses (a fresh tensor always
is; a view at an odd offset raises).

Tolerance: fp32 forward outputs agree with the plain version within 2e-5
(both in full fp32, no TF32), fp32 gradients within 5e-4 (longer sums in
another order), bf16 within 2e-2 of the tensor's scale (one rounding of
each output, and of dS, and P, inside the tensor-core backward passes);
tests/test_torch_flash_attention.py and tests/test_torch_flash_backward.py
hold the plain versions, and a rounding model of the tensor-core kernels,
against the reference package's Pallas kernels in interpret mode,
``chip_smoke.py`` the kernels against the plain versions on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.device_metrics import report_kernel

NEG_INF = -1e30

# (D, Dv) pairs the kernels are compiled for (csrc/flash_attention.cu,
# csrc/flash_attention_bwd.cu): the reduced configs' 16, GQA's 32 / 64 /
# 128, 128 -> 64, the MLA pairs of deepseek-v2-lite-16b (qk_nope 128 +
# qk_rope 64 -> v 128) and minicpm3-4b (64 + 32 -> 64), and zamba2-2.7b's
# shared attention (80)
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (128, 64),
             (192, 128), (96, 64), (80, 80))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the bf16 tensor-core kernels' tiles (csrc/flash_attention.cu,
# csrc/flash_attention_bwd.cu): forward and dq 128 q rows x 64 kv rows per
# step (at D > 128 in two 32-row halves, which changes no shared memory),
# dk / dv 128 kv rows x 64 q rows per step (at D + Dv > 256 in two sweeps,
# dV then dK, over the same tiles); 8 warps each
FWD_TILE = (128, 64)
DQ_TILE = (128, 64)
DKV_TILE = (128, 64)

launches = 0          # forward kernel
dq_launches = 0       # backward, dq pass
dkv_launches = 0      # backward, dk / dv pass


def _pairs(q, k) -> int:
    """(query, key) pairs over the heads: B * H * Sq * Skv."""
    B, Sq, H, _ = q.shape
    return B * H * Sq * k.shape[1]


def fwd_flops(q, k, v) -> int:
    """The forward's dot FLOPs: q k^T at D, p v at Dv."""
    return 2 * _pairs(q, k) * (q.shape[3] + v.shape[3])


def dq_flops(q, k, v) -> int:
    """The dq pass's share of the plain backward: s = q k^T (D), dp = dO
    v^T (Dv), dq = ds k (D)."""
    return 2 * _pairs(q, k) * (2 * q.shape[3] + v.shape[3])


def dkv_flops(q, k, v) -> int:
    """The dk / dv pass's share: dv = p^T dO (Dv), dk = ds^T q (D).  Both
    sum over the q rows of a kv head's group; with one row (a step of one
    query without GQA) the plain version's products are elementwise, and
    no dot."""
    if q.shape[1] * (q.shape[2] // k.shape[2]) == 1:
        return 0
    return 2 * _pairs(q, k) * (q.shape[3] + v.shape[3])


def mma_smem_bytes(kernel: str, D: int, Dv: int) -> int:
    """Dynamic shared memory per block of a bf16 tensor-core kernel
    (``"fwd"``, ``"dq"`` or ``"dkv"``) at head dims (D, Dv): bf16 rows
    padded by 8 elements; the forward holds the q tile and two K and two V
    tiles, the dq pass the q and dO tiles and two K and two V tiles, the
    dk / dv pass K, V, two q and two dO tiles and two rows each of lse and
    delta (fp32)."""
    if kernel == "fwd":
        bq, bk = FWD_TILE
        return 2 * (bq * (D + 8) + 2 * bk * (D + 8) + 2 * bk * (Dv + 8))
    if kernel == "dq":
        bq, bk = DQ_TILE
        return 2 * ((bq + 2 * bk) * (D + 8) + (bq + 2 * bk) * (Dv + 8))
    bkv, bq = DKV_TILE
    return 2 * ((bkv + 2 * bq) * (D + 8) + (bkv + 2 * bq) * (Dv + 8)) \
        + 2 * 2 * bq * 4


def _check(q, k, v, q_offset) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"flash_fwd takes 4-D tensors, {name} is "
                             f"{getattr(t, 'shape', type(t))}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_fwd takes float32 or bfloat16 q/k/v of one "
                        f"type, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_fwd: q, k and v must be on one device")
    B, Sq, H, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if Bk != B or Dk != D or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if min(B, Sq, Skv, H, Hkv) < 1 or H % Hkv:
        raise ValueError(f"flash_fwd: H={H} must be a multiple of Hkv={Hkv}"
                         f" and no dim may be empty")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"flash_fwd: q_offset must be an int >= 0, got "
                         f"{q_offset!r}")


def flash_fwd_plain(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """Plain PyTorch: full fp32 scores, softmax, lse; GQA by grouping."""
    _check(q, k, v, q_offset)
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    qg = q.float().reshape(B, Sq, Hkv, G, D) * D ** -0.5
    s = torch.einsum("bshgd,bthd->bhgst", qg, k.float())
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        keep = torch.arange(Skv, device=q.device)[None, :] <= q_pos[:, None]
        s = s.masked_fill(~keep, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)                      # (B,Hkv,G,Sq)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhgst,bthd->bshgd", p, v.float())
    return (out.reshape(B, Sq, H, Dv).to(q.dtype),
            lse.reshape(B, H, Sq))


def flash_fwd(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """Attention forward -> ``(out, lse)``; the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    global launches
    _check(q, k, v, q_offset)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu tensors, got "
                         f"{q.device}")
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel is built for (D, Dv) in "
                         f"{HEAD_DIMS}, got ({D}, {Dv})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd kernel takes contiguous q, k and v")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_fwd kernel takes B, H <= 65535, got "
                         f"B={B}, H={H}")
    _check_aligned("flash_fwd", (q, k, v))
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPES[q.dtype], B, Sq, Skv, H, Hkv, D, Dv,
            q_offset, int(bool(causal)), D ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed (cuda error {rc}) for q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"{q.dtype}")
    launches += 1
    report_kernel((q, k, v, out, lse), lambda: fwd_flops(q, k, v))
    return out, lse


def _check_aligned(what: str, tensors) -> None:
    """The bf16 tensor-core kernels copy 16 bytes at a time (``cp.async``):
    their tensors must start on a 16-byte boundary."""
    if tensors[0].dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: the bf16 kernel takes tensors at 16-byte "
                         f"aligned addresses (a view at an odd offset is "
                         f"not; pass a copy)")


def _check_bwd(q, k, v, out, lse, dout, q_offset) -> None:
    _check(q, k, v, q_offset)
    B, Sq, H, _ = q.shape
    want = (B, Sq, H, v.shape[3])
    for name, t in (("out", out), ("dout", dout)):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != want or \
                t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_bwd: {name} must be {q.dtype} {want} on "
                             f"{q.device}, got {getattr(t, 'dtype', None)} "
                             f"{tuple(getattr(t, 'shape', ()))}")
    if not isinstance(lse, torch.Tensor) or tuple(lse.shape) != (B, H, Sq) \
            or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"flash_bwd: lse must be float32 {(B, H, Sq)} on "
                         f"{q.device}")


def flash_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                    q_offset: int = 0):
    """Plain PyTorch backward -> ``(dq, dk, dv)``: the full fp32 score
    matrix, ``p = exp(s - lse)``, ``delta = sum(dout * out)``, ``ds = p *
    (dout . v^T - delta)``; dq = scale * ds . k, dk = ds^T . (scale * q),
    dv = p^T . dout, summed over each kv head's group."""
    _check_bwd(q, k, v, out, lse, dout, q_offset)
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    scale = D ** -0.5
    qg = q.float().reshape(B, Sq, Hkv, G, D) * scale
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(B, Sq, Hkv, G, Dv)
    delta = (do * out.float().reshape(B, Sq, Hkv, G, Dv)).sum(-1)
    p = torch.einsum("bshgd,bthd->bhgst", qg, kf)
    p.sub_(lse.reshape(B, Hkv, G, Sq, 1)).exp_()            # in place: s -> p
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        keep = torch.arange(Skv, device=q.device)[None, :] <= q_pos[:, None]
        p.masked_fill_(~keep, 0.0)
    dv = torch.einsum("bhgst,bshgd->bthd", p, do)
    ds = torch.einsum("bshgd,bthd->bhgst", do, vf)
    ds.sub_(delta.permute(0, 2, 3, 1)[..., None]).mul_(p)   # dp -> ds
    del p
    dq = torch.einsum("bhgst,bthd->bshgd", ds, kf) * scale
    dk = torch.einsum("bhgst,bshgd->bthd", ds, qg)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_bwd_kernels(q, k, v, tensors) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd kernels run on cuda tensors, got "
                         f"{q.device}")
    B, _, H, D = q.shape
    Dv = v.shape[3]
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash_bwd kernels are built for (D, Dv) in "
                         f"{HEAD_DIMS}, got ({D}, {Dv})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_bwd kernels take contiguous q, k, v, out, "
                         "lse, dout and delta")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_bwd kernels take B, H <= 65535, got "
                         f"B={B}, H={H}")


def _dims(q, k, v, causal, q_offset) -> tuple:
    B, Sq, H, D = q.shape
    return (_DTYPES[q.dtype], B, Sq, k.shape[1], H, k.shape[2], D,
            v.shape[3], q_offset, int(bool(causal)), D ** -0.5)


def flash_bwd_dq(q, k, v, out, lse, dout, *, causal: bool = True,
                 q_offset: int = 0):
    """The dq pass alone on CUDA tensors -> ``(dq, delta)``, delta ``(B, H,
    Sq)`` fp32 for :func:`flash_bwd_dkv`: bf16 on the tensor cores
    (``flash_bwd_dq_kernel_mma``, dS rounded to bf16 once before ``dS k``),
    fp32 in fp32 FMA (``flash_bwd_dq_kernel``)."""
    global dq_launches
    _check_bwd(q, k, v, out, lse, dout, q_offset)
    _check_bwd_kernels(q, k, v, (q, k, v, out, lse, dout))
    _check_aligned("flash_bwd dq", (q, k, v, out, dout))
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_dims(q, k, v, causal, q_offset),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_bwd dq kernel launch failed (cuda error {rc}) for q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"{q.dtype}")
    dq_launches += 1
    report_kernel((q, k, v, out, dout, lse, dq, delta),
                  lambda: dq_flops(q, k, v))
    return dq, delta


def flash_bwd_dkv(q, k, v, lse, dout, delta, *, causal: bool = True,
                  q_offset: int = 0):
    """The dk / dv pass alone on CUDA tensors -> ``(dk, dv)``; ``delta``
    from :func:`flash_bwd_dq` (enqueued before it on the same stream)."""
    global dkv_launches
    _check_bwd(q, k, v, dout, lse, dout, q_offset)
    if not isinstance(delta, torch.Tensor) or delta.shape != lse.shape or \
            delta.dtype != torch.float32 or delta.device != q.device:
        raise ValueError(f"flash_bwd: delta must be float32 "
                         f"{tuple(lse.shape)} on {q.device}")
    _check_bwd_kernels(q, k, v, (q, k, v, lse, dout, delta))
    _check_aligned("flash_bwd dk/dv", (q, k, v, dout))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_dims(q, k, v, causal, q_offset),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_bwd dk/dv kernel launch failed (cuda error {rc}) for q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"{q.dtype}")
    dkv_launches += 1
    report_kernel((q, k, v, dout, lse, delta, dk, dv),
                  lambda: dkv_flops(q, k, v))
    return dk, dv


def flash_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
              q_offset: int = 0):
    """Attention backward -> ``(dq, dk, dv)`` for the forward's ``out`` and
    ``lse``; the two kernels on CUDA tensors (dq pass, then dk / dv pass),
    the plain version on CPU tensors."""
    _check_bwd(q, k, v, out, lse, dout, q_offset)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                               q_offset=q_offset)
    dq, delta = flash_bwd_dq(q, k, v, out, lse, dout, causal=causal,
                             q_offset=q_offset)
    dk, dv = flash_bwd_dkv(q, k, v, lse, dout, delta, causal=causal,
                           q_offset=q_offset)
    return dq, dk, dv
