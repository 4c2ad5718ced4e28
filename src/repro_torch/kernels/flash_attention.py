"""Flash attention, forward and backward: the attention core of every GQA
layer and of the vision tower.

* :func:`flash_fwd` — the forward's wrapper: on CUDA tensors it launches
  a hand-written kernel that replaces the TPU kernel
  ``repro/kernels/flash_attention.py::_fwd_kernel``: bf16 on the tensor
  cores with Hopper's wgmma, TMA and warp specialisation
  (``flash_fwd_kernel_wgmma``, ``csrc/flash_attention_wgmma.cu``), fp32
  in fp32 FMA (``flash_fwd_kernel``, ``csrc/flash_attention.cu``); on CPU
  tensors it takes the plain version.  It never falls back: CUDA tensors the kernels do not take
  raise.
* :func:`flash_bwd` — the backward's wrapper, the same way: on CUDA
  tensors it launches :func:`flash_bwd_dq`, the q-stationary dq pass
  (replaces ``_dq_kernel``; it also computes ``delta = sum(dout * out)``
  of its rows), and then :func:`flash_bwd_dkv`, the kv-stationary dk / dv
  pass (replaces ``_dkv_kernel``; each block sums over the G query heads
  of its group and every q tile): bf16 on wgmma
  (``flash_bwd_dq_kernel_wgmma``, ``flash_bwd_dkv_kernel_wgmma`` of
  ``csrc/flash_attention_bwd_wgmma.cu``), fp32 in fp32 FMA
  (``csrc/flash_attention_bwd.cu``).  Each block writes its tile of a
  gradient once: no atomics, bit-equal results from launch to launch.
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
tensors read and written once, each at its own width.  The bf16 kernels
run on the tensor cores (bf16 products, fp32 sums; before the second
product the forward carries the probabilities as two bf16 parts, the dq
pass rounds dS to bf16 once, the dk / dv pass P and dS, as
FlashAttention-2 does); the fp32 kernels compute in fp32 FMA (see the
sources' notes).  Their times stand beside the bound in PERF.md.  The
wgmma kernels read their operands by TMA (:func:`wgmma_plan`: 4-D (width,
heads, seq, batch) tensor maps, encoded per launch), so they take q, k,
v, out / dout and the gradients contiguous at 16-byte aligned addresses;
the wrappers hand them a contiguous copy of a strided or unaligned view,
never the plain version.

Head dims: the kernels are compiled for the pairs ``HEAD_DIMS``; any
other ``1 <= D, Dv <= 256`` runs on :func:`instance_for`'s pair, the
compiled one that dominates it with the fewest columns, its operands
zero-padded to that pair (:func:`pad_operands`) and the extra columns of
out and the gradients dropped.  That is exact: zero columns of q and k add
nothing to ``q k^T``, zero columns of v give zero columns of out, lse and
``delta = sum(dout * out)`` do not move, and the gradients' extra columns
are zero.  The softmax scale stays the true ``D ** -0.5``: it is an
explicit argument of every launch and plain version.  What stays refused,
with a ValueError: D or Dv above 256 (``MAX_HEAD_DIM``), rank other than
4, ``H % Hkv != 0``; float16 raises a TypeError.

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

import functools

import torch

from repro_torch.core.device_metrics import report_kernel

NEG_INF = -1e30

# (D, Dv) pairs the kernels are compiled for (csrc/flash_attention.cu,
# csrc/flash_attention_bwd.cu): the reduced configs' 16, GQA's 32 / 64 /
# 128, 128 -> 64, the MLA pairs of deepseek-v2-lite-16b (qk_nope 128 +
# qk_rope 64 -> v 128) and minicpm3-4b (64 + 32 -> 64), zamba2-2.7b's
# shared attention (80), and 256, which covers every pair up to it
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (128, 64),
             (192, 128), (96, 64), (80, 80), (256, 256))
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)

# Every bf16 pass runs one design at every compiled pair: Hopper's wgmma,
# TMA and warp specialisation (csrc/flash_attention_wgmma.cu,
# csrc/flash_attention_bwd_wgmma.cu; :func:`wgmma_plan`), which replaced
# mma.sync kernels.  Timed in turns in one chip call each (H100 80GB HBM3,
# 700 W; PERF.md § 6), kernel alone, mma.sync / wgmma, us at each pair's
# main-path shape: the forward 1,512 / 764 at (128, 128), 102 / 67 at the
# vision tower's (64, 64), 446 / 220, 688 / 373, 563 / 315, 891 / 355 and
# 302 / 155 at (192, 128), (96, 64), (80, 80), (256, 256) and (128, 64);
# dk / dv 2,622 / 1,359, 181 / 102, 1,215 / 743, 1,244 / 598, 968 / 488,
# 3,152 / 2,710 and 557 / 310; at the reduced configs' tiny grids, (16,
# 16) and (32, 32), the two were within 0.7 us (4-7 us).  The dq pass
# (L2 flushed): 1,710 / 893 at (128, 128), 464 / 282 and 253 / 169 at
# (64, 64) non-causal and causal (4 x 2,048, 16 heads), 783 / 460, 598 /
# 385, 593 / 309 and 1,046 / 547 at (96, 64), (80, 80), (192, 128) and
# (256, 256); at the reduced (32, 32) 3.9 / 3.8, at (16, 16) 4.1 / 5.2,
# against the 215-277 us of host time a wrapper call takes there.
#
# the wgmma kernels' blocks: 2 consumer warpgroups and 1 producer
# warpgroup, registers shifted between them by setmaxnreg
WGMMA_THREADS = 384
WGMMA_REGS = {"producer": 40, "consumer": 232}
MAX_SMEM = 232448                 # an H100 block's shared-memory opt-in

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


@functools.lru_cache(maxsize=None)
def instance_for(D: int, Dv: int) -> tuple:
    """The compiled pair a ``(D, Dv)`` problem runs on: the pair of
    ``HEAD_DIMS`` that dominates it (``Di >= D``, ``Dvi >= Dv``) with the
    fewest columns ``Di + Dvi`` (then the narrower ``Di``); a compiled pair
    is its own.  ValueError outside ``1 <= D, Dv <= MAX_HEAD_DIM``."""
    if not (1 <= D <= MAX_HEAD_DIM and 1 <= Dv <= MAX_HEAD_DIM):
        raise ValueError(f"flash kernels take head dims 1 <= D, Dv <= "
                         f"{MAX_HEAD_DIM}, got ({D}, {Dv})")
    return min((p for p in HEAD_DIMS if p[0] >= D and p[1] >= Dv),
               key=lambda p: (p[0] + p[1], p[0]))


def swizzle_cols(cols: int) -> int:
    """The swizzle width of a bf16 operand of ``cols`` columns in the wgmma
    kernels: the widest of 64 (128-byte swizzle), 32 (64-byte) and 16
    (32-byte) columns that divides it; the operand is ``cols / width``
    TMA boxes of that width, one wgmma descriptor layout for all."""
    return next(w for w in (64, 32, 16) if cols % w == 0)


def _tma_operand(cols: int, rows: int, swizzled: bool = True) -> dict:
    w = swizzle_cols(cols) if swizzled else cols
    return {"cols": cols, "rows": rows, "box": (w, 1, rows, 1),
            "boxes": cols // w, "swizzle_bytes": 2 * w if swizzled else 0}


@functools.lru_cache(maxsize=None)
def wgmma_plan(kernel: str, D: int, Dv: int) -> dict:
    """The plan of a wgmma kernel (``"fwd"``, ``"dq"`` or ``"dkv"``) at the
    compiled pair (D, Dv), as csrc/wgmma_plan.cuh lays it out: ``tile``
    (rows per block, rows per step of the inner loop: q and kv for the
    forward and dq, kv and q for dk / dv), ring ``stages``, ``sweeps`` over
    the q tiles,
    ``operands`` (each a 4-D (width, heads, seq, batch) TMA view cut into
    ``boxes`` boxes ``box`` of ``swizzle_bytes`` swizzle), the ``products``
    one consumer warpgroup launches per step as (name, M, N, K, where A
    lives, B's major dim), the fp32 and packed bf16 ``live_registers`` of
    its heaviest step, and the dynamic shared memory ``smem_bytes`` (tiles
    and mbarriers, plus 1,024 bytes to align the base)."""
    if kernel == "fwd":
        bq, bk = 128, (64 if D + Dv > 384 else 128)
        # 3 stages of K and V where they fit the opt-in, else 2
        stages = 3 if _fwd_smem(D, Dv, bq, bk, 3) <= MAX_SMEM else 2
        operands = {"q": _tma_operand(D, bq), "k": _tma_operand(D, bk),
                    "v": _tma_operand(Dv, bk),
                    "out": _tma_operand(Dv, 64, swizzled=False)}
        products = [("s = q k^T", 64, bk, D, "smem", "K"),
                    ("o += p_hi v", 64, Dv, bk, "registers", "MN"),
                    ("o += p_lo v", 64, Dv, bk, "registers", "MN")]
        # O, P(j-1)'s two parts and S(j), live across one slot's products
        live = Dv // 2 + bk // 2 + bk // 2
        smem = _fwd_smem(D, Dv, bq, bk, stages)
        tile, sweeps = (bq, bk), 1
    elif kernel == "dq":
        # 64-row kv steps, 32 at (256, 256), where dQ alone holds 128
        # accumulator registers; 3 stages of K and V where they fit
        bq, bk = 128, (32 if D + Dv > 384 else 64)
        stages = 3 if _dq_smem(D, Dv, bq, bk, 3) <= MAX_SMEM else 2
        operands = {"q": _tma_operand(D, bq), "dout": _tma_operand(Dv, bq),
                    "k": _tma_operand(D, bk), "v": _tma_operand(Dv, bk)}
        products = [("s = q k^T", 64, bk, D, "smem", "K"),
                    ("dp = dout v^T", 64, bk, Dv, "smem", "K"),
                    ("dq += ds k", 64, D, bk, "registers", "MN")]
        # dQ, S and dP
        live = D // 2 + bk // 2 + bk // 2
        smem = _dq_smem(D, Dv, bq, bk, stages)
        tile, sweeps = (bq, bk), 1
    elif kernel == "dkv":
        # sweeps over the q tiles: one to D + Dv = 256 (dK and dV), two to
        # 384 (dV, then dK), four above (dV's and dK's column halves); the
        # accumulator registers of the largest sweep
        sweeps = 1 if D + Dv <= 256 else 2 if D + Dv <= 384 else 4
        acc = {1: (D + Dv) // 2, 2: max(D, Dv) // 2,
               4: max(D, Dv) // 4}[sweeps]
        # 32-row q steps beside 128 accumulator registers, or where two
        # 64-row stages pass the opt-in; 64 elsewhere
        bkv = 128
        bq = 32 if acc >= 128 or _dkv_smem(D, Dv, bkv, 64, 2) > MAX_SMEM \
            else 64
        stages = 3 if _dkv_smem(D, Dv, bkv, bq, 3) <= MAX_SMEM else 2
        nk, nv = {1: (D, Dv), 2: (D, Dv), 4: (D // 2, Dv // 2)}[sweeps]
        operands = {"k": _tma_operand(D, bkv), "v": _tma_operand(Dv, bkv),
                    "q": _tma_operand(D, bq), "dout": _tma_operand(Dv, bq)}
        products = [("s^T = k q^T", 64, bq, D, "smem", "K"),
                    ("dp^T = v dout^T", 64, bq, Dv, "smem", "K"),
                    ("dv += p^T dout", 64, nv, bq, "registers", "MN"),
                    ("dk += ds^T q", 64, nk, bq, "registers", "MN")]
        # the sweep's accumulators, S^T and dP^T
        live = acc + bq // 2 + bq // 2
        smem = _dkv_smem(D, Dv, bkv, bq, stages)
        tile = (bkv, bq)
    else:
        raise ValueError(f"no wgmma kernel {kernel!r}")
    return {"design": "wgmma", "threads": WGMMA_THREADS,
            "registers": dict(WGMMA_REGS), "tile": tile, "stages": stages,
            "sweeps": sweeps, "operands": operands, "products": products,
            "live_registers": live, "smem_bytes": smem}


def _fwd_smem(D, Dv, bq, bk, stages) -> int:
    """The forward's q tile, ``stages`` K and V tiles, its 1 + 4 stages
    mbarriers and 1,024 bytes to align the base."""
    return bq * D * 2 + stages * bk * (D + Dv) * 2 + 8 * (1 + 4 * stages) \
        + 1024


def _dq_smem(D, Dv, bq, bk, stages) -> int:
    """The dq pass's q and dO tiles, ``stages`` K and V tiles, its 1 + 2
    stages mbarriers and 1,024 bytes to align the base."""
    return bq * (D + Dv) * 2 + stages * bk * (D + Dv) * 2 \
        + 8 * (1 + 2 * stages) + 1024


def _dkv_smem(D, Dv, bkv, bq, stages) -> int:
    """The dk / dv pass's K and V, ``stages`` q and dO tiles with their lse
    and delta rows, 1 + 2 stages mbarriers and 1,024 bytes of alignment."""
    return bkv * (D + Dv) * 2 + stages * bq * ((D + Dv) * 2 + 2 * 4) \
        + 8 * (1 + 2 * stages) + 1024


def _operand(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` as a kernel reads it: contiguous, 16-byte aligned in bf16,
    its last dim zero-padded to ``width`` (a fresh tensor where any of
    that does not hold already)."""
    if t.shape[-1] != width:
        return torch.nn.functional.pad(t, (0, width - t.shape[-1]))
    if not t.is_contiguous() or (t.dtype == torch.bfloat16
                                 and t.data_ptr() % 16):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def pad_operands(q, k, v, *rest) -> tuple:
    """The problem the kernels run for ``(q, k, v[, out, dout])``: each
    operand contiguous, aligned and zero-padded to :func:`instance_for`'s
    pair (q, k to its D; v and the rest to its Dv), and the true scale
    ``D ** -0.5``."""
    D, Dv = q.shape[3], v.shape[3]
    Di, Dvi = instance_for(D, Dv)
    return ((_operand(q, Di), _operand(k, Di), _operand(v, Dvi))
            + tuple(_operand(t, Dvi) for t in rest) + (D ** -0.5,))


def _unpad(t: torch.Tensor, width: int) -> torch.Tensor:
    return t if t.shape[-1] == width else t[..., :width].contiguous()


def _check_grid(what: str, q, k) -> None:
    """The kernels' one-dimensional grids: (B, H, q tiles) and (B, Hkv, kv
    tiles) blocks below 2^31 (the tiles of 64 rows, the smallest)."""
    B, Sq, H, _ = q.shape
    blocks = B * max(H * -(-Sq // 64), k.shape[2] * -(-k.shape[1] // 64))
    if blocks > 0x7FFFFFFF:
        raise ValueError(f"{what}: {blocks} blocks of 64 rows exceed a "
                         f"grid's 2**31 - 1")


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


def flash_fwd_plain(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    scale: float = None):
    """Plain PyTorch: full fp32 scores, softmax, lse; GQA by grouping.
    ``scale`` multiplies q (default ``D ** -0.5``)."""
    _check(q, k, v, q_offset)
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    qg = q.float().reshape(B, Sq, Hkv, G, D) * (
        D ** -0.5 if scale is None else scale)
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
    _check_grid("flash_fwd", q, k)
    qp, kp, vp, scale = pad_operands(q, k, v)
    Di, Dvi = qp.shape[3], vp.shape[3]
    _check_aligned("flash_fwd", (qp, kp, vp))
    out, lse = _launch_fwd(qp, kp, vp, causal, q_offset, scale)
    out = _unpad(out, Dv)
    report_kernel((q, k, v, out, lse), lambda: fwd_flops(q, k, v))
    return out, lse


def _launch_fwd(qp, kp, vp, causal, q_offset, scale):
    """One launch of the forward on operands padded to an instance ->
    ``(out at the instance's Dv, lse)``: fp32 on the FMA kernel, bf16 on
    the wgmma kernel."""
    global launches
    B, Sq, H, Di = qp.shape
    Skv, Hkv, Dvi = kp.shape[1], kp.shape[2], vp.shape[3]
    out = torch.empty((B, Sq, H, Dvi), dtype=qp.dtype, device=qp.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=qp.device)
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(qp.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
                lse.data_ptr())
        dims = (B, Sq, Skv, H, Hkv, Di, Dvi, q_offset, int(bool(causal)),
                scale, stream)
        launch = (lib.flash_fwd_wgmma_launch if qp.dtype == torch.bfloat16
                  else lib.flash_fwd_launch)
        rc = launch(*ptrs, *dims)
    if rc != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed (cuda error {rc}) for q "
            f"{tuple(qp.shape)}, k {tuple(kp.shape)}, v {tuple(vp.shape)}, "
            f"{qp.dtype} on the ({Di}, {Dvi}) instance")
    launches += 1
    return out, lse


def _check_aligned(what: str, tensors) -> None:
    """The bf16 kernels copy by TMA, whose tensor maps take 16-byte
    aligned bases: the tensors a
    launch is given must start on a 16-byte boundary (the wrappers hand it
    :func:`pad_operands`' copies of any that do not)."""
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
                    q_offset: int = 0, scale: float = None):
    """Plain PyTorch backward -> ``(dq, dk, dv)``: the full fp32 score
    matrix, ``p = exp(s - lse)``, ``delta = sum(dout * out)``, ``ds = p *
    (dout . v^T - delta)``; dq = scale * ds . k, dk = ds^T . (scale * q),
    dv = p^T . dout, summed over each kv head's group (``scale`` default
    ``D ** -0.5``)."""
    _check_bwd(q, k, v, out, lse, dout, q_offset)
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
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


def _check_bwd_kernels(q, k, tensors) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd kernels run on cuda tensors, got "
                         f"{q.device}")
    _check_grid("flash_bwd", q, k)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_bwd kernels take contiguous lse and delta")


def _dims(qp, kp, vp, causal, q_offset, scale) -> tuple:
    B, Sq, H, Di = qp.shape
    return (B, Sq, kp.shape[1], H, kp.shape[2], Di, vp.shape[3], q_offset,
            int(bool(causal)), scale)


def _launch_dq(qp, kp, vp, outp, lse, doutp, causal, q_offset, scale):
    """One launch of the dq pass on operands padded to an instance ->
    ``(dq at the instance's D, delta)``: fp32 on the FMA kernel, bf16 on
    the wgmma kernel."""
    global dq_launches
    _check_aligned("flash_bwd dq", (qp, kp, vp, outp, doutp))
    dq = torch.empty_like(qp)
    delta = torch.empty_like(lse)
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(qp.device):
        launch = (lib.flash_bwd_dq_wgmma_launch
                  if qp.dtype == torch.bfloat16 else lib.flash_bwd_dq_launch)
        rc = launch(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), outp.data_ptr(),
            doutp.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), *_dims(qp, kp, vp, causal, q_offset, scale),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_bwd dq kernel launch failed (cuda error {rc}) for q "
            f"{tuple(qp.shape)}, k {tuple(kp.shape)}, v {tuple(vp.shape)}, "
            f"{qp.dtype}")
    dq_launches += 1
    return dq, delta


def _launch_dkv(qp, kp, vp, lse, doutp, delta, causal, q_offset, scale):
    """One launch of the dk / dv pass on operands padded to an instance ->
    ``(dk, dv)`` at the instance's widths: fp32 on the FMA kernel, bf16 on
    the wgmma kernel."""
    global dkv_launches
    _check_aligned("flash_bwd dk/dv", (qp, kp, vp, doutp))
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(qp.device):
        ptrs = (qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                doutp.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dk.data_ptr(), dv.data_ptr())
        launch = (lib.flash_bwd_dkv_wgmma_launch
                  if qp.dtype == torch.bfloat16 else lib.flash_bwd_dkv_launch)
        rc = launch(*ptrs, *_dims(qp, kp, vp, causal, q_offset, scale),
                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_bwd dk/dv kernel launch failed (cuda error {rc}) for q "
            f"{tuple(qp.shape)}, k {tuple(kp.shape)}, v {tuple(vp.shape)}, "
            f"{qp.dtype}")
    dkv_launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, out, lse, dout, *, causal: bool = True,
                 q_offset: int = 0):
    """The dq pass alone on CUDA tensors -> ``(dq, delta)``, delta ``(B, H,
    Sq)`` fp32 for :func:`flash_bwd_dkv`: bf16 on wgmma
    (``flash_bwd_dq_kernel_wgmma``, dS rounded to bf16 once before ``dS
    k``), fp32 in fp32 FMA (``flash_bwd_dq_kernel``)."""
    _check_bwd(q, k, v, out, lse, dout, q_offset)
    _check_bwd_kernels(q, k, (lse,))
    qp, kp, vp, outp, doutp, scale = pad_operands(q, k, v, out, dout)
    dq, delta = _launch_dq(qp, kp, vp, outp, lse, doutp, causal, q_offset,
                           scale)
    dq = _unpad(dq, q.shape[3])
    report_kernel((q, k, v, out, dout, lse, dq, delta),
                  lambda: dq_flops(q, k, v))
    return dq, delta


def flash_bwd_dkv(q, k, v, lse, dout, delta, *, causal: bool = True,
                  q_offset: int = 0):
    """The dk / dv pass alone on CUDA tensors -> ``(dk, dv)``; ``delta``
    from :func:`flash_bwd_dq` (enqueued before it on the same stream)."""
    _check_bwd(q, k, v, dout, lse, dout, q_offset)
    if not isinstance(delta, torch.Tensor) or delta.shape != lse.shape or \
            delta.dtype != torch.float32 or delta.device != q.device:
        raise ValueError(f"flash_bwd: delta must be float32 "
                         f"{tuple(lse.shape)} on {q.device}")
    _check_bwd_kernels(q, k, (lse, delta))
    qp, kp, vp, doutp, scale = pad_operands(q, k, v, dout)
    dk, dv = _launch_dkv(qp, kp, vp, lse, doutp, delta, causal, q_offset,
                         scale)
    dk, dv = _unpad(dk, k.shape[3]), _unpad(dv, v.shape[3])
    report_kernel((q, k, v, dout, lse, delta, dk, dv),
                  lambda: dkv_flops(q, k, v))
    return dk, dv


def flash_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
              q_offset: int = 0):
    """Attention backward -> ``(dq, dk, dv)`` for the forward's ``out`` and
    ``lse``; the two kernels on CUDA tensors (dq pass, then dk / dv pass,
    on operands padded once), the plain version on CPU tensors."""
    _check_bwd(q, k, v, out, lse, dout, q_offset)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                               q_offset=q_offset)
    _check_bwd_kernels(q, k, (lse,))
    qp, kp, vp, outp, doutp, scale = pad_operands(q, k, v, out, dout)
    dq, delta = _launch_dq(qp, kp, vp, outp, lse, doutp, causal, q_offset,
                           scale)
    del outp
    dk, dv = _launch_dkv(qp, kp, vp, lse, doutp, delta, causal, q_offset,
                         scale)
    dq = _unpad(dq, q.shape[3])
    dk, dv = _unpad(dk, k.shape[3]), _unpad(dv, v.shape[3])
    report_kernel((q, k, v, out, dout, lse, dq, delta),
                  lambda: dq_flops(q, k, v))
    report_kernel((q, k, v, dout, lse, delta, dk, dv),
                  lambda: dkv_flops(q, k, v))
    return dq, dk, dv
