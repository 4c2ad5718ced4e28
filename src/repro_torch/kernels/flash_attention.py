"""Flash attention, forward: the attention core of every GQA layer and of
the vision tower.

* :func:`flash_fwd` — the wrapper: on CUDA tensors it launches the
  hand-written kernel ``csrc/flash_attention.cu`` (which replaces the TPU
  kernel ``repro/kernels/flash_attention.py::_fwd_kernel``); on CPU
  tensors it takes the plain version.  It never falls back: CUDA tensors
  the kernel does not take raise.
* :func:`flash_fwd_plain` — the same function in plain PyTorch: the full
  score matrix in fp32, softmax, ``lse``.  The cross-check on the device
  and the CPU path.
* ``launches`` — how many times the kernel was launched.

Layouts are the reference's: q ``(B, Sq, H, D)``, k ``(B, Skv, Hkv, D)``,
v ``(B, Skv, Hkv, Dv)`` -> out ``(B, Sq, H, Dv)`` in q's type and lse
``(B, H, Sq)`` fp32.  GQA maps q head ``h`` to kv head ``h // (H // Hkv)``;
``causal`` masks ``k_pos > q_offset + q_row``.

Bound on an H100: operations, ``4*B*H*Sq*Skv*D`` (half of it when causal)
over the bf16 tensor-core peak, against ``(q + k + v + out)`` bytes plus
the lse.  The first kernel computes in fp32 FMA (see the source's note);
its times stand beside the bound in PERF.md.

Tolerance: fp32 inputs agree with the plain version within 2e-5 (both in
full fp32, no TF32), bf16 within 2e-2 (one rounding of the output);
tests/test_torch_flash_attention.py holds the plain version against the
reference package's Pallas kernel in interpret mode, ``chip_smoke.py``
the kernel against the plain version on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

# (D, Dv) pairs the kernel is compiled for (csrc/flash_attention.cu)
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (128, 64))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


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
    return out, lse
