"""Optimizers: AdamW (fp32 master + m + v), 8-bit Adam (int8 m / v with
per-block fp32 scales) and Adafactor (factored second moment, RMS update
clip) — the reference's ``repro.train.optimizer`` over the port's
per-block tensors.

The state is a dict keyed by parameter name (``trainable_params``'
names), each entry the reference's per-leaf state dict.  The byte
accounting of ``core.factors.opt_bytes_for`` describes these states.

Two deliberate differences from the reference, both from the port's
blocks owning their tensors (one tensor per layer where the reference
stacks the layers):

* every update is per tensor, which is the reference's per-layer
  ``_leaf_update_chunked`` for stacked leaves of 3 or more dims.  A
  stacked leaf of 2 dims (one vector per layer: norm scales, biases) the
  reference updates whole, so its Adafactor factors the (layers, width)
  stack and clips over all layers; here each layer's vector has its own
  unfactored second moment and clip.  AdamW is elementwise and the same
  either way;
* 8-bit Adam's 256-value blocks never straddle two layers (the reference
  quantizes a stacked leaf flattened, so its blocks do where a layer's
  size is not a multiple of 256).

The update writes ``p`` and the fp32 master copy in place.  The reference
returns new arrays (XLA may alias them with the donated old ones); the
byte model's non-aliased ``out_copy`` term therefore overstates the port's
optimizer step (ROADMAP C4).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

BLOCK = 256  # 8-bit Adam quantization block


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adamw8bit | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    master_fp32: bool = True       # adam variants keep an fp32 master copy


# ---------------------------------------------------------------------------
# 8-bit block quantization helpers
# ---------------------------------------------------------------------------


def _quant8(x: torch.Tensor) -> tuple:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    fp = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = fp.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(fp / scale.clamp_min(1e-12)).to(torch.int8)
    return q, scale[:, 0]


def _dequant8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    x = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    return x[:_size(shape)].reshape(shape)


def _size(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


# ---------------------------------------------------------------------------
# per-tensor state
# ---------------------------------------------------------------------------


def _leaf_state(p: torch.Tensor, cfg: OptimizerConfig) -> dict:
    f32 = dict(dtype=torch.float32, device=p.device)
    if cfg.name == "adamw":
        st = {"m": torch.zeros(p.shape, **f32),
              "v": torch.zeros(p.shape, **f32)}
    elif cfg.name == "adamw8bit":
        nblk = -(-p.numel() // BLOCK)
        i8 = dict(dtype=torch.int8, device=p.device)
        st = {"m_q": torch.zeros((nblk, BLOCK), **i8),
              "m_s": torch.zeros((nblk,), **f32),
              "v_q": torch.zeros((nblk, BLOCK), **i8),
              "v_s": torch.zeros((nblk,), **f32)}
    elif cfg.name == "adafactor":
        if p.dim() >= 2:
            st = {"v_row": torch.zeros(p.shape[:-1], **f32),
                  "v_col": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        else:
            st = {"v": torch.zeros(p.shape, **f32)}
    else:
        raise ValueError(f"optimizer {cfg.name!r}: expected adamw, "
                         f"adamw8bit or adafactor")
    if cfg.name in ("adamw", "adamw8bit") and cfg.master_fp32:
        st["master"] = p.detach().to(torch.float32, copy=True)
    return st


def init_opt_state(trainable: list, cfg: OptimizerConfig) -> dict:
    """``trainable``: ``(name, tensor)`` pairs -> {name: state dict}."""
    return {name: _leaf_state(p, cfg) for name, p in trainable}


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------


def _adam_update(g, m, v, step, cfg: OptimizerConfig):
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    mhat = m / (1 - cfg.b1 ** step)
    vhat = v / (1 - cfg.b2 ** step)
    return mhat / (torch.sqrt(vhat) + cfg.eps), m, v


@torch.no_grad()
def _leaf_update(p: torch.Tensor, g: torch.Tensor, st: dict,
                 step: torch.Tensor, cfg: OptimizerConfig) -> None:
    g = g.to(torch.float32)
    master = st.get("master")
    x = master if master is not None else p.to(torch.float32)

    if cfg.name == "adamw":
        upd, m, v = _adam_update(g, st["m"], st["v"], step, cfg)
        st["m"].copy_(m)
        st["v"].copy_(v)
    elif cfg.name == "adamw8bit":
        m = _dequant8(st["m_q"], st["m_s"], p.shape)
        # v is stored in sqrt-space: halves the dynamic range an int8 grid
        # must cover, which is what keeps 8-bit Adam tracking fp32 Adam.
        v = _dequant8(st["v_q"], st["v_s"], p.shape) ** 2
        upd, m, v = _adam_update(g, m, v, step, cfg)
        for key, val in (("m", m), ("v", torch.sqrt(v))):
            q, s = _quant8(val)
            st[f"{key}_q"].copy_(q)
            st[f"{key}_s"].copy_(s)
    else:  # adafactor
        g2 = g * g + 1e-30
        if p.dim() >= 2:
            v_row = cfg.b2 * st["v_row"] + (1 - cfg.b2) * g2.mean(-1)
            v_col = cfg.b2 * st["v_col"] + (1 - cfg.b2) * g2.mean(-2)
            r = v_row / v_row.mean(-1, keepdim=True).clamp_min(1e-30)
            vhat = r[..., None] * v_col[..., None, :]
            st["v_row"].copy_(v_row)
            st["v_col"].copy_(v_col)
        else:
            vhat = cfg.b2 * st["v"] + (1 - cfg.b2) * g2
            st["v"].copy_(vhat)
        upd = g / torch.sqrt(vhat + cfg.eps)
        # update clipping (Adafactor RMS rule)
        rms = torch.sqrt(torch.mean(upd * upd) + 1e-30)
        upd = upd / rms.clamp_min(1.0)

    x = x - cfg.lr * (upd + cfg.weight_decay * x)
    if master is not None:
        master.copy_(x)
    p.copy_(x)                           # cast to p's type


def apply_updates(trainable: list, grads: list, state: dict,
                  step: torch.Tensor, cfg: OptimizerConfig) -> None:
    """One optimizer step, in place: ``trainable`` ``(name, tensor)``
    pairs, ``grads`` in the same order, ``state`` from
    :func:`init_opt_state`, ``step`` the new step count as a float32
    scalar tensor (bias correction is computed in fp32 from it, as the
    reference's ``step.astype(float32)``)."""
    if len(grads) != len(trainable):
        raise ValueError(f"{len(grads)} gradients for {len(trainable)} "
                         f"trainable tensors")
    for (name, p), g in zip(trainable, grads):
        _leaf_update(p, g, state[name], step, cfg)
