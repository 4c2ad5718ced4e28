"""Plain PyTorch layers of the benchmark's reference, in float32 with TF32
off, and the reference's training loop.

Nothing here imports the program under test.  Every layer is written out
from its equations.  The matrix products, the attention core, RMSNorm and
the chunked cross-entropy are ``torch.autograd.Function``s with explicit
backward formulas, so that the reference keeps only what it needs for its
gradients.  A frozen weight may stay in bfloat16: each product upcasts it
where it is used.  A trainable weight is a float32 leaf.

``rnd`` is the rounding applied to every operand of a product: the
identity for the reference, :func:`round_fp8` for the control (the same
computation with each operand of each product, the gradients that the
backward's products take included, rounded to float8 e4m3 with a
per-tensor scale, accumulated in float32).
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32
F8_MAX = 448.0


def exact() -> None:
    """Float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale, back in
    float32."""
    s = x.abs().amax().float().clamp_min(1e-30) / F8_MAX
    return (x.float() / s).to(torch.float8_e4m3fn).to(F32) * s



class _Linear(torch.autograd.Function):
    """y = x @ w; w is (d_in, d_out)."""

    @staticmethod
    def forward(ctx, x, w, rnd):
        xq = rnd(x)
        ctx.save_for_backward(xq, w)
        ctx.rnd = rnd
        return xq @ rnd(w.to(F32))

    @staticmethod
    def backward(ctx, dy):
        xq, w = ctx.saved_tensors
        dx = dw = None
        dyq = ctx.rnd(dy)
        if ctx.needs_input_grad[0]:
            dx = dyq @ ctx.rnd(w.to(F32)).T
        if ctx.needs_input_grad[1]:
            dw = xq.reshape(-1, xq.shape[-1]).T @ \
                dyq.reshape(-1, dyq.shape[-1])
        return dx, dw, None


def linear(x, w, rnd=identity):
    return _Linear.apply(x, w, rnd)


class _RMSNorm(torch.autograd.Function):
    """y = x / sqrt(mean(x^2) + eps) * scale over the last dim."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        rstd = torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, rstd, scale)
        return x * rstd * scale.to(F32)

    @staticmethod
    def backward(ctx, dy):
        x, rstd, scale = ctx.saved_tensors
        xhat = x * rstd
        g = dy * scale.to(F32)
        dx = rstd * (g - xhat * (g * xhat).mean(-1, keepdim=True))
        dscale = None
        if ctx.needs_input_grad[1]:
            dscale = (dy * xhat).reshape(-1, x.shape[-1]).sum(0)
        return dx, dscale, None


def rmsnorm(x, scale, eps):
    return _RMSNorm.apply(x, scale, eps)


def rope(x, theta: float):
    """Split-half rotary embedding of x (B, S, H, D) at positions 0..S-1."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=F32,
                                         device=x.device) / D)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class _Attention(torch.autograd.Function):
    """softmax(q k^T / sqrt(D)) v with grouped kv heads; q (B, S, H, D),
    k (B, T, Hkv, D), v (B, T, Hkv, Dv); the probabilities are recomputed
    in the backward from the saved log-sum-exp."""

    @staticmethod
    def _scores(q, k, causal, rnd):
        H, Hkv = q.shape[2], k.shape[2]
        kk = k.repeat_interleave(H // Hkv, dim=2)
        s = rnd(q).transpose(1, 2) @ rnd(kk).permute(0, 2, 3, 1)
        s = s * (q.shape[-1] ** -0.5)
        if causal:
            S, T = s.shape[-2], s.shape[-1]
            mask = torch.ones(S, T, dtype=torch.bool, device=s.device) \
                .triu(1)
            s = s.masked_fill(mask, float("-inf"))
        return s

    @staticmethod
    def forward(ctx, q, k, v, causal, rnd):
        H, Hkv = q.shape[2], k.shape[2]
        s = _Attention._scores(q, k, causal, rnd)
        lse = torch.logsumexp(s, dim=-1, keepdim=True)
        p = torch.exp(s - lse)
        del s
        vv = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
        out = (rnd(p) @ rnd(vv)).transpose(1, 2)        # (B, S, H, Dv)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.rnd = causal, rnd
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        rnd = ctx.rnd
        B, S, H, D = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        G = H // Hkv
        p = torch.exp(_Attention._scores(q, k, ctx.causal, rnd) - lse)
        do = rnd(dout.transpose(1, 2))                      # (B, H, S, Dv)
        vv = v.repeat_interleave(G, dim=2).transpose(1, 2)
        dv = rnd(p).transpose(-1, -2) @ do                  # (B, H, T, Dv)
        dp = do @ rnd(vv).transpose(-1, -2)
        delta = (dout * out).sum(-1).transpose(1, 2)[..., None]
        ds = rnd(p * (dp - delta) * (D ** -0.5))
        del p, dp
        kk = k.repeat_interleave(G, dim=2).transpose(1, 2)
        dq = (ds @ rnd(kk)).transpose(1, 2)
        dk = ds.transpose(-1, -2) @ rnd(q).transpose(1, 2)  # (B, H, T, D)
        dk = dk.reshape(B, Hkv, G, T, D).sum(2).transpose(1, 2)
        dv = dv.reshape(B, Hkv, G, T, -1).sum(2).transpose(1, 2)
        return dq, dk, dv, None, None


def attention(q, k, v, causal: bool, rnd=identity):
    return _Attention.apply(q, k, v, causal, rnd)


class _Xent(torch.autograd.Function):
    """Sum over the rows of h (N, d) with a label >= 0 of
    logsumexp(h w) - (h w)[label], in chunks of rows; each chunk's
    logits are made again in the backward."""

    CHUNK = 512

    @staticmethod
    def forward(ctx, h, w, labels, rnd):
        wq = rnd(w.to(F32))
        total = h.new_zeros((), dtype=F32)
        for i in range(0, h.shape[0], _Xent.CHUNK):
            lab = labels[i:i + _Xent.CHUNK]
            logits = rnd(h[i:i + _Xent.CHUNK]) @ wq
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(-1, lab.clamp_min(0)[:, None])[:, 0]
            total = total + torch.where(lab >= 0, lse - tgt, 0.0).sum()
        ctx.save_for_backward(h, w, labels)
        ctx.rnd = rnd
        return total

    @staticmethod
    def backward(ctx, dtotal):
        h, w, labels = ctx.saved_tensors
        rnd = ctx.rnd
        wq = rnd(w.to(F32))
        dh = torch.empty_like(h) if ctx.needs_input_grad[0] else None
        dw = torch.zeros(w.shape, dtype=F32, device=w.device) \
            if ctx.needs_input_grad[1] else None
        for i in range(0, h.shape[0], _Xent.CHUNK):
            lab = labels[i:i + _Xent.CHUNK]
            hq = rnd(h[i:i + _Xent.CHUNK])
            g = torch.softmax(hq @ wq, dim=-1)
            g[torch.arange(lab.shape[0], device=g.device),
              lab.clamp_min(0)] -= 1.0
            g = rnd(g * ((lab >= 0).to(F32) * dtotal)[:, None])
            if dh is not None:
                dh[i:i + _Xent.CHUNK] = g @ wq.T
            if dw is not None:
                dw += hq.T @ g
        return dh, dw, None, None


def xent_sum(h, w, labels, rnd=identity):
    """(loss summed over the labelled rows, the number of those rows)."""
    return _Xent.apply(h, w, labels.long(), rnd), \
        (labels >= 0).sum().to(F32)


def embed(ids, table):
    """Rows of ``table`` (float32, or a frozen bfloat16 table upcast)."""
    if table.requires_grad:
        return torch.nn.functional.embedding(ids.long(), table)
    return table[ids.long()].to(F32)


def silu(x):
    return x * torch.sigmoid(x)


def gelu_tanh(x):
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


def swiglu(x, wg, wu, wd, rnd=identity):
    return linear(silu(linear(x, wg, rnd)) * linear(x, wu, rnd), wd, rnd)


def gqa(x, W: dict, pre: str, n_heads: int, n_kv: int, hd: int,
        theta: float, causal: bool, rnd=identity, memory=None):
    """Grouped-query attention of the block at ``pre`` (weights
    ``pre.wq``, ``wk``, ``wv``, ``wo``); with ``memory`` the keys and
    values come from it, unrotated (cross-attention)."""
    B, S, _ = x.shape
    q = linear(x, W[pre + ".wq"], rnd).reshape(B, S, n_heads, hd)
    src = x if memory is None else memory
    T = src.shape[1]
    k = linear(src, W[pre + ".wk"], rnd).reshape(B, T, n_kv, hd)
    v = linear(src, W[pre + ".wv"], rnd).reshape(B, T, n_kv, hd)
    if memory is None:
        q, k = rope(q, theta), rope(k, theta)
    ctx = attention(q, k, v, causal, rnd)
    return linear(ctx.reshape(B, S, n_heads * hd), W[pre + ".wo"], rnd)


def leaf_of(name: str) -> str:
    """The leaf a tensor belongs to: its name without a layer index
    (``...blocks.3.attn.wq`` -> ``...blocks.attn.wq``)."""
    return ".".join(p for p in name.split(".") if not p.isdigit())


def group_norms(tensors: dict) -> dict:
    """{leaf: the float32 norm of its tensors together}."""
    sq: dict = {}
    for name, t in tensors.items():
        key = leaf_of(name)
        sq[key] = sq.get(key, 0.0) + float(t.float().pow(2).sum())
    return {k: math.sqrt(v) for k, v in sq.items()}


def follow(loss_rows, weights: dict, trainable: set, batches: list,
           opt: dict, rnd=identity) -> dict:
    """The reference's training of ``len(batches)`` steps from
    ``weights`` (name -> tensor; the ``trainable`` ones are copied to
    float32 leaves, the others read as they are).

    ``loss_rows(W, batch, rnd)`` -> (loss summed over the batch's
    labelled positions, their count) for a batch of a few rows.  Each
    step's loss is the mean over all its labelled positions; its
    gradient is summed a sequence at a time, so that the float32
    activations of one sequence are all it holds.  The optimizer is
    AdamW with decoupled weight decay over every trainable tensor.

    Returns the loss of each step, the norm of each trainable leaf's
    first gradient and of its change over all the steps."""
    W = {n: (t.detach().to(F32).clone().requires_grad_()
             if n in trainable else t) for n, t in weights.items()}
    start = {n: weights[n] for n in trainable}
    m = {n: torch.zeros_like(W[n]) for n in trainable}
    v = {n: torch.zeros_like(W[n]) for n in trainable}
    losses, grad1 = [], None
    for step, batch in enumerate(batches, 1):
        n_rows = next(iter(batch.values())).shape[0]
        parts = [{k: t[i:i + 1] for k, t in batch.items()}
                 for i in range(n_rows)]
        with torch.no_grad():
            n_tok = sum(float((p["labels"] >= 0).sum()) for p in parts)
        total = 0.0
        for part in parts:
            s, _ = loss_rows(W, part, rnd)
            (s / n_tok).backward()
            total += float(s.detach())
            del s
        losses.append(total / n_tok)
        grads = {n: W[n].grad for n in trainable}
        if step == 1:
            grad1 = group_norms(grads)
        with torch.no_grad():
            b1, b2 = opt["b1"], opt["b2"]
            for n in trainable:
                g = grads[n]
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m[n] / (1 - b1 ** step)) / \
                    (torch.sqrt(v[n] / (1 - b2 ** step)) + opt["eps"])
                W[n].sub_(opt["lr"] * (upd + opt["weight_decay"] * W[n]))
                W[n].grad = None
    with torch.no_grad():
        change = group_norms({n: W[n] - start[n].to(F32)
                              for n in trainable})
    return {"losses": losses, "grad1": grad1, "change": change}

