"""Optimizers: AdamW (fp32 master + m + v), 8-bit Adam (int8 m / v with
per-block fp32 scales) and Adafactor (factored second moment, RMS update
clip) — the reference's ``repro.train.optimizer`` over the port's
per-block tensors.

The reference keeps one array per leaf, the layers of a scanned module
stacked on a leading axis; the port keeps one tensor per layer.  The
optimizer works on the reference's leaves (:class:`~repro_torch.models.
param.Leaf`, from ``param.trainable_leaves``): the state is a dict keyed
by leaf name, each entry the reference's state of that leaf with the
reference's shapes, so its bytes are ``core.factors.opt_bytes_for`` of
the stacked shape.  Each leaf is updated as the reference updates it:

* AdamW is elementwise: each layer's tensor is updated against its slice
  of the stacked state, which is the reference's update value for value;
* Adafactor updates a stacked leaf of 3 or more dims layer by layer (the
  reference's ``_leaf_update_chunked``: per-layer factored moments and
  clip) and a stack of vectors (norm scales, biases) whole: one factored
  second moment ``v_row (L,)`` + ``v_col (d,)`` and one RMS clip over the
  stack;
* 8-bit Adam quantizes the leaf flattened, so its 256-value blocks
  straddle layers wherever a layer's size is not a multiple of 256.  The
  update walks the flat leaf in block ranges of about one layer, so no
  fp32 copy of a whole stack is ever made.

The update writes each layer's tensor and the fp32 master copy in place.
The reference returns new arrays (XLA may alias them with the donated old
ones); the byte model's non-aliased ``out_copy`` term therefore overstates
the port's optimizer step (ROADMAP C4).
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


def _dequant8(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    return (q.to(torch.float32) * scale[:, None]).reshape(-1)[:n]


def _size(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


# ---------------------------------------------------------------------------
# per-leaf state
# ---------------------------------------------------------------------------


def _master(leaf) -> torch.Tensor:
    """The leaf's values in fp32, stacked like the reference's leaf."""
    t0 = leaf.params[0][1]
    out = torch.empty(leaf.shape, dtype=torch.float32, device=t0.device)
    for i, (_, p) in enumerate(leaf.params):
        (out[i] if leaf.stacked else out).copy_(p.detach())
    return out


def _state_specs(shape: tuple, cfg: OptimizerConfig) -> dict:
    """(shape, dtype) of each state tensor of a leaf of ``shape``."""
    f32, i8 = torch.float32, torch.int8
    if cfg.name == "adamw":
        st = {"m": (shape, f32), "v": (shape, f32)}
    elif cfg.name == "adamw8bit":
        nblk = -(-_size(shape) // BLOCK)
        st = {"m_q": ((nblk, BLOCK), i8), "m_s": ((nblk,), f32),
              "v_q": ((nblk, BLOCK), i8), "v_s": ((nblk,), f32)}
    elif cfg.name == "adafactor":
        if len(shape) >= 2:
            st = {"v_row": (shape[:-1], f32),
                  "v_col": (shape[:-2] + shape[-1:], f32)}
        else:
            st = {"v": (shape, f32)}
    else:
        raise ValueError(f"optimizer {cfg.name!r}: expected adamw, "
                         f"adamw8bit or adafactor")
    if cfg.name in ("adamw", "adamw8bit") and cfg.master_fp32:
        st["master"] = (shape, f32)
    return st


def _leaf_state(leaf, cfg: OptimizerConfig) -> dict:
    device = leaf.params[0][1].device
    return {name: _master(leaf) if name == "master"
            else torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in _state_specs(leaf.shape,
                                                     cfg).items()}


def init_opt_state(leaves: list, cfg: OptimizerConfig) -> dict:
    """``leaves`` (``param.Leaf``s) -> {leaf name: state dict}."""
    return {leaf.name: _leaf_state(leaf, cfg) for leaf in leaves}


def opt_state_specs(trainable_specs: dict, cfg: OptimizerConfig) -> dict:
    """The reference's ``opt_state_specs``: for each leaf of a tree of
    ``param.TensorSpec``s in the reference's layout (``None`` for a frozen
    leaf), its state's ``TensorSpec``s by name (no allocation)."""
    from repro_torch.models.param import TensorSpec

    def leaf(p):
        if p is None:
            return None
        if isinstance(p, dict):
            return {k: leaf(v) for k, v in p.items()}
        return {name: TensorSpec(tuple(shape), dtype) for name, (shape, dtype)
                in _state_specs(tuple(p.shape), cfg).items()}

    return leaf(trainable_specs)


def state_bytes(state: dict) -> dict:
    """Bytes of each leaf's state tensors, by leaf name."""
    return {name: sum(t.numel() * t.element_size() for t in st.values())
            for name, st in state.items()}


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------


def _adam_update(g, m, v, step, cfg: OptimizerConfig):
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    mhat = m / (1 - cfg.b1 ** step)
    vhat = v / (1 - cfg.b2 ** step)
    return mhat / (torch.sqrt(vhat) + cfg.eps), m, v


def _decay_and_write(x, upd, p, master, cfg: OptimizerConfig) -> None:
    x = x - cfg.lr * (upd + cfg.weight_decay * x)
    if master is not None:
        master.copy_(x)
    p.copy_(x)                           # cast to p's type


def _adamw(p, g, st: dict, i, step, cfg: OptimizerConfig) -> None:
    """One tensor against its slice ``i`` of the state (``None``: the
    whole state)."""
    part = (lambda t: t) if i is None else (lambda t: t[i])
    master = part(st["master"]) if "master" in st else None
    x = master if master is not None else p.to(torch.float32)
    m, v = part(st["m"]), part(st["v"])
    upd, m_new, v_new = _adam_update(g.to(torch.float32), m, v, step, cfg)
    m.copy_(m_new)
    v.copy_(v_new)
    _decay_and_write(x, upd, p, master, cfg)


def _adafactor(g, st: dict, cfg: OptimizerConfig):
    """The reference's Adafactor ``_leaf_update`` on one array ``g`` (a
    tensor, or a stack of vectors); writes ``st`` and returns the clipped
    update."""
    g2 = g * g + 1e-30
    if g.dim() >= 2:
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
    return upd / rms.clamp_min(1.0)


def _flat_range(tensors: list, lo: int, hi: int) -> torch.Tensor:
    """Elements ``[lo, hi)`` of the tensors laid end to end (a view when
    the range lies in one tensor)."""
    parts, start = [], 0
    for t in tensors:
        n = t.numel()
        a, b = max(lo - start, 0), min(hi - start, n)
        if a < b:
            parts.append(t.reshape(-1)[a:b])
        start += n
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _write_range(tensors: list, lo: int, values: torch.Tensor) -> None:
    """Write ``values`` over elements ``[lo, lo + len)`` of the tensors
    laid end to end, casting to each tensor's type."""
    start, hi = 0, lo + values.numel()
    for t in tensors:
        n = t.numel()
        a, b = max(lo - start, 0), min(hi - start, n)
        if a < b:
            t.view(-1)[a:b].copy_(values[start + a - lo:start + b - lo])
        start += n


def _adamw8bit(leaf, grads: list, st: dict, step,
               cfg: OptimizerConfig) -> None:
    """The reference's 8-bit update of the leaf flattened, walked in
    ranges of whole quantization blocks covering about one layer each."""
    params = [p for _, p in leaf.params]
    total = _size(leaf.shape)
    per = max(1, -(-params[0].numel() // BLOCK)) * BLOCK
    master = st.get("master")
    for lo in range(0, total, per):
        hi = min(lo + per, total)
        blocks = slice(lo // BLOCK, -(-hi // BLOCK))
        n = hi - lo
        g = _flat_range(grads, lo, hi).to(torch.float32)
        x = master.view(-1)[lo:hi] if master is not None \
            else _flat_range(params, lo, hi).to(torch.float32)
        m = _dequant8(st["m_q"][blocks], st["m_s"][blocks], n)
        # v is stored in sqrt-space: halves the dynamic range an int8 grid
        # must cover, which is what keeps 8-bit Adam tracking fp32 Adam.
        v = _dequant8(st["v_q"][blocks], st["v_s"][blocks], n) ** 2
        upd, m, v = _adam_update(g, m, v, step, cfg)
        for key, val in (("m", m), ("v", torch.sqrt(v))):
            q, s = _quant8(val)
            st[f"{key}_q"][blocks] = q
            st[f"{key}_s"][blocks] = s
        x = x - cfg.lr * (upd + cfg.weight_decay * x)
        if master is not None:
            master.view(-1)[lo:hi] = x
        _write_range(params, lo, x)


@torch.no_grad()
def _leaf_update(leaf, grads: list, st: dict, step,
                 cfg: OptimizerConfig) -> None:
    params = [p for _, p in leaf.params]
    if cfg.name == "adamw":
        for i, (p, g) in enumerate(zip(params, grads)):
            _adamw(p, g, st, i if leaf.stacked else None, step, cfg)
    elif cfg.name == "adamw8bit":
        _adamw8bit(leaf, grads, st, step, cfg)
    elif leaf.stacked and len(leaf.shape) >= 3:
        # Adafactor, layer by layer (the reference's chunked update)
        for i, (p, g) in enumerate(zip(params, grads)):
            sub = {k: v[i] for k, v in st.items()}
            upd = _adafactor(g.to(torch.float32), sub, cfg)
            _decay_and_write(p.to(torch.float32), upd, p, None, cfg)
    else:
        # Adafactor, the leaf whole: one tensor or a stack of vectors
        g = torch.stack(grads) if leaf.stacked else grads[0]
        x = torch.stack(params) if leaf.stacked else params[0]
        upd = _adafactor(g.to(torch.float32), st, cfg)
        x = x.to(torch.float32)
        x = x - cfg.lr * (upd + cfg.weight_decay * x)
        for i, p in enumerate(params):
            p.copy_(x[i] if leaf.stacked else x)


def apply_updates(leaves: list, grads: dict, state: dict,
                  step: torch.Tensor, cfg: OptimizerConfig) -> None:
    """One optimizer step, in place: ``leaves`` the ``param.Leaf``s of
    :func:`init_opt_state`, ``grads`` each tensor's gradient by the port's
    parameter name, ``state`` from :func:`init_opt_state`, ``step`` the
    new step count as a float32 scalar tensor (bias correction is
    computed in fp32 from it, as the reference's
    ``step.astype(float32)``)."""
    names = [n for leaf in leaves for n, _ in leaf.params]
    if set(grads) != set(names):
        raise ValueError(f"{len(grads)} gradients for {len(names)} "
                         f"trainable tensors")
    for leaf in leaves:
        _leaf_update(leaf, [grads[n] for n, _ in leaf.params],
                     state[leaf.name], step, cfg)
