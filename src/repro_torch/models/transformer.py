"""Decoder-only LM family: llama / qwen / mistral (GQA), minicpm /
deepseek (MLA), dense or MoE FFN.

Spec functions of every member, and for every member, GQA or MLA, dense
or MoE, the training forward (``lm_backbone`` under a remat policy,
``chunked_xent``, ``lm_loss``) and the serving path.  Blocks are
depth-stacked (``scanned``) modules in the spec; their parameters are one
:class:`~repro_torch.models.param.ModuleParams` per block, walked by a
Python loop where the reference scans, each block under its own
checkpoint.  An MoE config's leading ``n_dense_layers`` blocks are the
``dense_blocks`` stack; each MoE block adds the dense residual FFN where
the config has one (arctic), and its load-balance loss is summed into
``lm_backbone``'s ``aux`` (a dense model makes no aux tensor: its aux is
the float 0.0).  The loss is the chunked cross-entropy the byte model
describes, which never materializes the full (B, S, V) logits
(``LOSS_CHUNK`` rows at a time, each chunk recomputed in the backward),
plus ``0.01 * aux / n_layers`` for an MoE config.

The serving functions keep the reference's program so that the memory and
the launches measured are those of the program the predictor models:
``lm_prefill`` recomputes each block's K/V through ``_prefill_kv`` from its
own ``norm1`` (so ``norm1`` runs twice per block), and the KV cache is
bf16 whatever the model's type.  An MLA config caches the normed latent
and the raw rope key (``latent``, ``k_rope``) in place of k and v; its
``_prefill_kv`` recomputes them with ``wkv_a`` and ``kv_norm`` and makes
no q (the reference's ``_prefill_kv`` discards the q of its
``_mla_qkv``, which its jitted program never computes).
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.configs import ArchConfig
from repro_torch.core.device_metrics import span
from repro_torch.core.spec import LayerSpec, ModuleSpec
from repro_torch.kernels import ops
from repro_torch.mesh_ctx import (current_mesh, current_mesh_shape,
                                  current_rules, mesh_context)
from repro_torch.models import layers as L
from repro_torch.models.attention import (_mla_kv, gqa_decode, gqa_forward,
                                          gqa_spec, mla_decode, mla_forward,
                                          mla_spec)
from repro_torch.models.moe import moe_forward, moe_spec

LOSS_CHUNK = 512


def attn_spec_for(cfg: ArchConfig) -> LayerSpec:
    if cfg.mla:
        return mla_spec("attn", cfg.d_model, cfg.n_heads, cfg.mla, cfg.dtype)
    return gqa_spec("attn", cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim, cfg.qk_norm, cfg.dtype)


def _block_layers(cfg: ArchConfig, ffn: str) -> list[LayerSpec]:
    layers = [L.rmsnorm_spec("norm1", cfg.d_model, cfg.dtype),
              attn_spec_for(cfg),
              L.rmsnorm_spec("norm2", cfg.d_model, cfg.dtype)]
    if ffn == "moe":
        layers.append(moe_spec("ffn", cfg.d_model, cfg.moe, cfg.dtype))
        if cfg.moe.dense_residual:
            layers.append(L.mlp_spec("dense_ffn", cfg.d_model, cfg.d_ff,
                                     cfg.dtype))
    else:
        layers.append(L.mlp_spec("ffn", cfg.d_model, cfg.d_ff, cfg.dtype))
    return layers


def lm_spec(cfg: ArchConfig, name: str = "language_model") -> ModuleSpec:
    children = [ModuleSpec(
        name="embed", modality="text",
        layers=[L.embedding_spec("tok", cfg.vocab, cfg.d_model, cfg.dtype,
                                 tied=cfg.tie_embeddings)])]
    n_moe_dense = cfg.moe.n_dense_layers if cfg.moe else 0
    if cfg.moe:
        if n_moe_dense:
            children.append(ModuleSpec(
                name="dense_blocks", modality="text", repeat=n_moe_dense,
                scanned=True, layers=_block_layers(cfg, "mlp")))
        children.append(ModuleSpec(
            name="blocks", modality="text", repeat=cfg.n_layers - n_moe_dense,
            scanned=True, layers=_block_layers(cfg, "moe")))
    else:
        children.append(ModuleSpec(
            name="blocks", modality="text", repeat=cfg.n_layers,
            scanned=True, layers=_block_layers(cfg, "mlp")))
    final = [L.rmsnorm_spec("final_norm", cfg.d_model, cfg.dtype)]
    if not cfg.tie_embeddings:
        final.append(L.lm_head_spec("lm_head", cfg.d_model, cfg.vocab,
                                    cfg.dtype))
    children.append(ModuleSpec(name="head", modality="text", layers=final))
    return ModuleSpec(name=name, modality="text", children=children)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _stacks(cfg: ArchConfig, p) -> list:
    """(cache key, block stack, MoE blocks?) in the order they run: the
    leading dense blocks of an MoE config, then the main stack."""
    out = []
    if cfg.moe and cfg.moe.n_dense_layers:
        out.append(("dense_blocks", p.dense_blocks, False))
    out.append(("blocks", p.blocks, bool(cfg.moe)))
    return out


def _moe_meta(cfg: ArchConfig) -> dict:
    return moe_spec("ffn", cfg.d_model, cfg.moe, cfg.dtype).meta


def _ffn_apply(cfg: ArchConfig, moe_block: bool, bp, h: torch.Tensor):
    """The block's FFN -> (y, aux): the MoE FFN (+ the dense residual FFN)
    with its load-balance loss, or the dense MLP with aux 0.0."""
    if not moe_block:
        return L.mlp(bp.ffn, h), 0.0
    y, aux = moe_forward(bp.ffn, h, _moe_meta(cfg))
    if cfg.moe.dense_residual:
        y = y + L.mlp(bp.dense_ffn, h)
    return y, aux


def _attn_apply(cfg: ArchConfig, ap, h: torch.Tensor,
                positions) -> torch.Tensor:
    if cfg.mla:
        return mla_forward(ap, h, n_heads=cfg.n_heads, mla=cfg.mla,
                           norm_eps=cfg.norm_eps, positions=positions)
    return gqa_forward(ap, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                       head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta,
                       qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps,
                       positions=positions)


def _block_apply(cfg: ArchConfig, moe_block: bool, bp, x: torch.Tensor,
                 positions=None):
    """One block -> (x, aux)."""
    h = L.rmsnorm(bp.norm1, x, cfg.norm_eps)
    x = x + _attn_apply(cfg, bp.attn, h, positions)
    h = L.rmsnorm(bp.norm2, x, cfg.norm_eps)
    y, aux = _ffn_apply(cfg, moe_block, bp, h)
    return x + y, aux


# what the "dots" policy saves: the outputs of the matrix products (the
# q/k/v/o projections, the MLP's three products, and on the CPU path the
# plain attention's einsums).  The attention core on the card is a kernel
# behind an autograd Function, not a matmul, so under "dots" it runs again
# in the backward, and its residuals (q, k, v, out, lse) come from that
# recompute.
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``fn`` under the reference's remat policy: "none" saves every
    activation, "block" only ``fn``'s inputs (the block's carry) and
    reruns ``fn`` in the backward, "dots" the matmul outputs too.  Each
    run of ``fn``, forward or recompute, is a ``repro_torch.model.block``
    span.

    The recompute runs in the backward, which may run outside the
    ``mesh_ctx.mesh_context`` the forward ran under: it reruns ``fn``
    under the mesh context the forward saw, so an MoE block takes the same
    path both times.

    The reference also pins the scan carry with an XLA optimization
    barrier (``_pin``) so XLA cannot hoist a convert of the saved stack out
    of the loop; eager PyTorch has no such rewrite, so nothing stands in
    for it here."""
    fn = functools.partial(_block_span, fn)
    if policy == "none":
        return fn
    if policy not in ("block", "dots"):
        raise ValueError(f"remat policy {policy!r}: expected none, block "
                         f"or dots")

    def contexts():
        fwd, rec = (_ckpt.create_selective_checkpoint_contexts(_save_dots)
                    if policy == "dots" else
                    (contextlib.nullcontext(), contextlib.nullcontext()))
        mesh = current_mesh()        # a live DeviceMesh, else the shape
        return fwd, _entered(rec, mesh_context(
            mesh if mesh is not None else current_mesh_shape(),
            current_rules()))
    return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False,
                             context_fn=contexts)


def _block_span(fn, *args, **kwargs):
    with span("repro_torch.model.block"):
        return fn(*args, **kwargs)


@contextlib.contextmanager
def _entered(*managers):
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield


def lm_backbone(cfg: ArchConfig, p, embeds: torch.Tensor,
                positions=None, remat=None):
    """embeds: (B, S, D) -> (final-normed hidden (B, S, D), the MoE blocks'
    summed aux loss: an fp32 scalar, 0.0 for a dense model); each block
    under the ``remat`` policy (default ``cfg.remat``)."""
    policy = remat if remat is not None else cfg.remat
    x, aux = embeds, 0.0
    for _, stack, moe_block in _stacks(cfg, p):
        block = _remat(functools.partial(_block_apply, cfg, moe_block),
                       policy)
        for bp in stack:
            x, a = block(bp, x, positions)
            aux = aux + a
    return L.rmsnorm(p.head.final_norm, x, cfg.norm_eps), aux


def embed_tokens(cfg: ArchConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    return L.embed(p.embed.tok, tokens)


def lm_logits(cfg: ArchConfig, p, hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return L.unembed(p.embed.tok, hidden)
    return L.linear(p.head.lm_head, hidden).float()


# ---------------------------------------------------------------------------
# chunked cross-entropy (never materializes (B, S, V))
# ---------------------------------------------------------------------------


def _chunk_loss(cfg: ArchConfig, p, h: torch.Tensor, labels: torch.Tensor):
    with span("repro_torch.model.loss_chunk"):
        logits = lm_logits(cfg, p, h)                    # (B, c, V) fp32
        lse = torch.logsumexp(logits, dim=-1)
        mask = labels >= 0
        tgt = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
        return (torch.where(mask, lse - tgt, 0.0).sum(),
                mask.sum().to(torch.float32))


def chunked_xent(cfg: ArchConfig, p, hidden: torch.Tensor,
                 labels: torch.Tensor, chunk: int = LOSS_CHUNK):
    """hidden: (B, S, D); labels: (B, S) with -100 = masked.  Returns
    (sum_loss, n_tokens), fp32 scalars.  ``chunk`` positions at a time,
    each chunk's logits recomputed in the backward instead of saved (the
    reference's ``jax.checkpoint`` per chunk); the last chunk is the
    ragged rest where the reference pads it with masked labels."""
    S = hidden.shape[1]
    chunk = min(chunk, S)
    fn = functools.partial(_chunk_loss, cfg, p)
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    n_tok = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, S, chunk):
        h, lab = hidden[:, i:i + chunk], labels[:, i:i + chunk]
        s, n = _ckpt.checkpoint(fn, h, lab, use_reentrant=False)
        loss_sum = loss_sum + s
        n_tok = n_tok + n
    return loss_sum, n_tok


def xent_loss(cfg: ArchConfig, p, hidden: torch.Tensor,
              labels: torch.Tensor):
    """Mean next-token loss over the unmasked labels -> (loss, metrics)."""
    loss_sum, n_tok = chunked_xent(cfg, p, hidden, labels)
    loss = loss_sum / n_tok.clamp_min(1.0)
    return loss, {"xent": loss.detach(), "n_tok": n_tok}


def lm_loss(cfg: ArchConfig, params, tokens: torch.Tensor,
            labels: torch.Tensor, remat=None):
    """tokens, labels: (B, S) -> (loss, {"xent", "n_tok"}, and "aux" for
    an MoE config, whose loss adds ``0.01 * aux / n_layers``)."""
    p = params.language_model if "language_model" in params \
        else next(iter(params.children()))
    hidden, aux = lm_backbone(cfg, p, embed_tokens(cfg, p, tokens),
                              remat=remat)
    loss, metrics = xent_loss(cfg, p, hidden, labels)
    if cfg.moe:
        loss = loss + 0.01 * aux / max(cfg.n_layers, 1)
        metrics = dict(metrics, aux=aux.detach())
    return loss, metrics


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                  device) -> dict:
    """Stacked (L-leading) cache: {'blocks': {'k', 'v': (L, B, max_len,
    Hkv, D) bf16}, 'len': (B,) int32}, zeroed, on ``device``; an MLA
    config's stack holds {'latent': (L, B, max_len, kv_lora), 'k_rope':
    (L, B, max_len, qk_rope)} bf16 instead; an MoE config's leading dense
    blocks have their own 'dense_blocks' stack."""
    n_dense = cfg.moe.n_dense_layers if cfg.moe else 0

    def one(n):
        if cfg.mla:
            shapes = {"latent": cfg.mla.kv_lora_rank,
                      "k_rope": cfg.mla.qk_rope_head_dim}
            return {name: torch.zeros((n, batch, max_len, w),
                                      dtype=torch.bfloat16, device=device)
                    for name, w in shapes.items()}
        shape = (n, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}

    cache = {"blocks": one(cfg.n_layers - n_dense),
             "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if n_dense:
        cache["dense_blocks"] = one(n_dense)
    return cache


def _prefill_kv(cfg: ArchConfig, ap, h: torch.Tensor) -> dict:
    """Recompute the cacheable K/V (an MLA config: latent and raw rope
    key) for a full sequence."""
    if cfg.mla:
        latent, k_rope = _mla_kv(ap, h, cfg.mla, cfg.norm_eps)
        return {"latent": latent.to(torch.bfloat16),
                "k_rope": k_rope.to(torch.bfloat16)}
    B, S, _ = h.shape
    hd = cfg.resolved_head_dim
    positions = torch.arange(S, device=h.device).expand(B, S)
    k = (h @ ap.wk).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        k = ops.rmsnorm(k, ap.k_norm, cfg.norm_eps)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    v = (h @ ap.wv).reshape(B, S, cfg.n_kv_heads, hd)
    return {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}


def prefill_embeds(cfg: ArchConfig, lm, x: torch.Tensor):
    """Prefill of the LM blocks over ready embeddings x (B, S, D): the
    last position's logits (B, 1, V) fp32 and the populated cache (sized
    to S).  Each block's K/V (or latent) is written straight into the
    stacked cache."""
    B, S, _ = x.shape
    cache = init_kv_cache(cfg, B, S, x.device)
    for key, stack, moe_block in _stacks(cfg, lm):
        for i, bp in enumerate(stack):
            h = L.rmsnorm(bp.norm1, x, cfg.norm_eps)
            kv = _prefill_kv(cfg, bp.attn, h)
            for name, t in kv.items():
                cache[key][name][i] = t
            x, _ = _block_apply(cfg, moe_block, bp, x)
    cache["len"].fill_(S)
    x = L.rmsnorm(lm.head.final_norm, x[:, -1:], cfg.norm_eps)
    return lm_logits(cfg, lm, x), cache


def lm_prefill(cfg: ArchConfig, params, tokens: torch.Tensor):
    """Full-sequence prefill: last-position logits + populated cache
    (layout of :func:`init_kv_cache` with max_len == S)."""
    lm = params.language_model
    return prefill_embeds(cfg, lm, embed_tokens(cfg, lm, tokens))


def _decode_block(cfg: ArchConfig, moe_block: bool, bp, x: torch.Tensor,
                  layer_cache: dict):
    h = L.rmsnorm(bp.norm1, x, cfg.norm_eps)
    if cfg.mla:
        a, _ = mla_decode(bp.attn, h, layer_cache, n_heads=cfg.n_heads,
                          mla=cfg.mla, norm_eps=cfg.norm_eps)
    else:
        a, _ = gqa_decode(bp.attn, h, layer_cache, n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads,
                          head_dim=cfg.resolved_head_dim,
                          theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                          norm_eps=cfg.norm_eps)
    x = x + a
    h = L.rmsnorm(bp.norm2, x, cfg.norm_eps)
    return x + _ffn_apply(cfg, moe_block, bp, h)[0]


def decode_lm(cfg: ArchConfig, lm, token: torch.Tensor, cache: dict):
    """token: (B, 1) -> (logits (B, 1, V) fp32, cache).  The cache tensors
    are updated in place; the returned dict carries ``len + 1``."""
    x = embed_tokens(cfg, lm, token)
    length = cache["len"]
    stacks = {}
    for key, stack, moe_block in _stacks(cfg, lm):
        leaves = dict(cache[key])
        for i, bp in enumerate(stack):
            x = _decode_block(cfg, moe_block, bp, x,
                              {**{n: t[i] for n, t in leaves.items()},
                               "len": length})
        stacks[key] = leaves
    x = L.rmsnorm(lm.head.final_norm, x, cfg.norm_eps)
    # len + 1 made last, as before the MoE stacks: made first, its block
    # would sit under the decode step's peak
    return lm_logits(cfg, lm, x), {**stacks, "len": length + 1}


def lm_decode_step(cfg: ArchConfig, params, token: torch.Tensor,
                   cache: dict):
    """token: (B, 1) -> (logits (B, 1, V), new cache)."""
    return decode_lm(cfg, params.language_model, token, cache)
