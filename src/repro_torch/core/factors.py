"""Per-factor analytical equations (paper workflow steps 5-6).

For every parsed layer, four factors are computed:

* ``M_param`` — parameter bytes, divided by the layer's real shard factor
  (TP over ``model``; optionally FSDP over ``data``).
* ``M_grad``  — gradient bytes (param dtype), zero for frozen layers.  In a
  single compiled XLA train step the full (TP-sharded) gradient pytree is
  live at the end of the backward pass, so grads share the *param* shard
  factor — the ZeRO reduce-scatter changes the persistent accumulator, not
  the transient peak.
* ``M_opt``   — optimizer-state bytes (AdamW: fp32 master + m + v; 8-bit
  Adam: fp32 master + int8 m/v + block scales; Adafactor: factored second
  moment), ZeRO-sharded over ``data`` on top of the param sharding.
* ``M_act``   — activation bytes saved for backward, a function of the
  remat policy and of the training behaviour: frozen modules save nothing
  (the paper's central multimodal observation).

All equations take shard factors from the SAME axis-resolution logic the
runtime uses (``repro_torch.mesh_ctx``), so prediction and execution cannot
disagree about sharding.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.parser import ParsedLayer
from repro_torch.core.spec import ActTerm, ParamSpec, dtype_bytes
from repro_torch.mesh_ctx import (CONTEXT_AXIS, DEFAULT_RULES, EXPERT_AXIS,
                            shard_factor)

AXIS_LAYERS = "layers"


# ---------------------------------------------------------------------------
# Symbolic term specs: the shared vocabulary between the scalar factor
# equations below and the columnar batch kernels (core.batch).  A TermSpec
# is one Eq.1 byte term in unevaluated form —
#
#     bytes = mult * prod(dims) * nbytes // max(shard_factor(dims), 1)
#
# where every entry of ``dims`` is either a concrete int (arch-dependent,
# cell-independent) or one of the TERM_VARS tokens resolved against an
# environment of cell knobs.  The scalar path evaluates a spec with a
# scalar env (``term_env``); the batch path evaluates the same spec with
# int64 column arrays.  Because both paths share the spec AND the shard
# resolution, they cannot drift apart.
# ---------------------------------------------------------------------------

#: env keys a symbolic dim may name.  ``mb``/``gb`` micro/global batch,
#: ``seq`` sequence length, ``enc`` encoder length, ``slen`` cache length
#: (max_len or seq), ``chunk`` loss chunk (min(LOSS_CHUNK, seq)), ``qc``
#: flash q/kv chunk (min(FLASH_CHUNK, seq)), ``tok_cross`` cross-attention
#: cache length (enc, falling back to slen), ``cache_mult`` the cpu-oracle
#: decode bf16-twin multiplier (a dimension-shaped multiplier: it scales
#: prod(dims) but carries no shardable axis), ``pool_tok`` the effective
#: paged-pool tokens per sequence (slen folded through the serve knobs —
#: block padding, utilization, prefix-cache hits, request mix; equals
#: slen exactly when no serve spec is active).
TERM_VARS = ("mb", "gb", "seq", "enc", "slen", "chunk", "qc", "tok_cross",
             "cache_mult", "pool_tok")


@dataclass(frozen=True)
class TermSpec:
    """One symbolic byte term (see module comment above)."""

    dims: tuple                    # ints and/or TERM_VARS tokens
    axes: tuple                    # logical axis names (or None) per dim
    nbytes: int                    # per-element bytes
    mult: int = 1                  # constant multiplier INSIDE the floor div


def term_env(ctx: "PredictContext") -> dict:
    """Scalar evaluation environment for TermSpec dims.  ``mb`` is the
    *pipeline* micro-batch: under pipeline parallelism only one
    microbatch's activations are in flight per term (the stash multiplier
    in ``core.stages`` accounts for the schedule's in-flight copies).

    The expert-parallel / context-parallel divisors (``ctx.ep`` /
    ``ctx.cp``) deliberately do NOT appear as env tokens: they divide
    through the shard-factor side of every TermSpec instead — the
    `experts`/`expert_buf` and `seq` logical axes map onto the `expert`
    and `context` mesh axes — so every existing spec scales with ep/cp
    automatically and the scalar and columnar paths cannot disagree on
    where the division happens."""
    from repro_torch.models.transformer import LOSS_CHUNK
    from repro_torch.serve.pool import pool_tokens
    slen = ctx.max_len or ctx.seq_len
    return {"mb": ctx.pp_micro_batch, "gb": ctx.global_batch,
            "seq": ctx.seq_len, "enc": ctx.enc_seq, "slen": slen,
            "chunk": min(LOSS_CHUNK, ctx.seq_len),
            "qc": min(FLASH_CHUNK, ctx.seq_len),
            "tok_cross": ctx.enc_seq or slen,
            "cache_mult": 3 if (ctx.backend == "cpu"
                                and ctx.kind == "decode") else 1,
            "pool_tok": pool_tokens(slen, ctx.serve)}


def eval_term(spec: TermSpec, env: dict, mesh_shape: dict,
              rules: dict) -> int:
    """Scalar TermSpec evaluation (the batch twin lives in core.batch)."""
    dims = tuple(env[d] if isinstance(d, str) else d for d in spec.dims)
    denom = shard_factor(dims, spec.axes, mesh_shape, rules)
    return math.prod(dims) * spec.nbytes * spec.mult // max(denom, 1)


# ---------------------------------------------------------------------------
# Optimizer-state host offload: the Eq.1 offload tier.
#
# With ``PredictContext.offload_opt`` the optimizer states live in host
# DRAM and stream through a small double-buffered device staging window
# during the (bucketed) update: the full state is cut into
# ``OFFLOAD_BUCKETS`` equal buckets and while bucket i updates on device
# bucket i+1 prefetches, so exactly TWO bucket-sized staging buffers are
# resident at the peak.  The device-side term therefore shrinks from
# ``opt_total`` to ``offload_staged_bytes(opt_total)`` and the full
# ``opt_total`` moves to the host tier, reported as
# ``PredictedMemory.offload_bytes`` (NOT part of the device peak).
#
# This helper is the SINGLE source of truth for the staging arithmetic:
# the scalar path (predictor.compute_static) and the columnar path
# (core.batch._stage_tables) both call it, in exact integer arithmetic,
# so offload cells stay byte-identical between the two paths and
# offload-off cells are untouched (the transform is only applied when
# the knob is set).
# ---------------------------------------------------------------------------

OFFLOAD_BUCKETS = 16


def offload_staged_bytes(opt_total: int) -> int:
    """Device bytes of the double-buffered streaming window over a host
    optimizer state of ``opt_total`` bytes: 2 ceil-divided buckets.
    Exact ints; monotone in ``opt_total``; 0 stays 0."""
    return 2 * (-(-int(opt_total) // OFFLOAD_BUCKETS))


def eff_act_nbytes(nbytes: int, ctx: "PredictContext", saved: bool) -> int:
    """Backend-adjusted per-element bytes of an activation tensor: bf16
    tensors feel the cpu-oracle float normalization (see PredictContext)."""
    if nbytes == 2:
        return ctx.act_saved_bytes_per_bf16 if saved \
            else nbytes * ctx.act_transient_mult
    return nbytes


@dataclass(frozen=True)
class PredictContext:
    """Everything the factor equations need to know about the run."""

    mesh_shape: dict[str, int] = field(default_factory=dict)
    rules: dict = field(default_factory=lambda: dict(DEFAULT_RULES))
    optimizer: str = "adamw"
    zero: bool = True              # ZeRO: opt states sharded over data
    fsdp: bool = False             # params/grads sharded over data too
    remat: str = "block"
    global_batch: int = 1
    seq_len: int = 1
    enc_seq: int = 0
    kind: str = "train"            # train | prefill | decode
    max_len: int = 0               # KV-cache length for decode
    # Pipeline parallelism: the mesh's `pipe` axis degree, the microbatch
    # count the batch is split into, and the schedule governing how many
    # microbatch activation sets are in flight per stage (core.stages).
    pp: int = 1
    microbatches: int = 1
    schedule: str = "1f1b"         # "1f1b" | "gpipe"
    grad_accum: int = 1
    grad_dtype_bytes: int = 2      # bf16 grads
    master_fp32: bool = True       # keep fp32 master copy in optimizer
    # Oracle backend the prediction targets.  "tpu": native bf16 compute
    # (deployment prediction).  "cpu": XLA:CPU float-normalization — every
    # bf16 op is legalized to f32-with-converts and LICM hoists the
    # converts of loop-carried stacks, so saved bf16 buffers effectively
    # exist twice (bf16 + f32) at the fwd->bwd boundary and gradients
    # accumulate in f32.  Used when validating against this container's
    # compiled-memory ground truth (see DESIGN.md §2).
    backend: str = "cpu"
    # Serving-fleet knobs (repro_torch.serve.pool.ServeSpec) for serve kinds:
    # paged-KV block pool, prefix-cache hits, request mix, draft model.
    # Always None for train kinds and when every knob is neutral —
    # planner.make_context normalizes, so serve=None cells are
    # bit-identical to pre-serve predictions.
    serve: Optional[object] = None
    # Eq.1 offload tier (train-only; planner.make_context rejects it on
    # serve kinds): optimizer states live in host DRAM and only the
    # double-buffered ``offload_staged_bytes`` streaming window stays on
    # device; the host residency is reported as
    # ``PredictedMemory.offload_bytes`` outside the device peak.
    offload_opt: bool = False

    @property
    def act_saved_bytes_per_bf16(self) -> int:
        return 6 if self.backend == "cpu" else 2      # bf16 + hoisted f32

    @property
    def act_transient_mult(self) -> int:
        return 2 if self.backend == "cpu" else 1      # f32 twins of bf16

    @property
    def eff_grad_bytes(self) -> int:
        if self.grad_accum > 1 or self.eff_microbatches > 1:
            return 4                     # fp32 cross-microbatch accumulator
        return self.grad_dtype_bytes

    # In-flight fp32 new-state stacks of the (chunked) optimizer update
    # before buffer assignment aliases them — ZeRO-sharded, so the term
    # shrinks with DP.  Coefficient calibrated on the fig2a DP sweep
    # (llava15-7b, SeqLen 1024, MBS 16) and validated on fig2b + the
    # arch sweep; see EXPERIMENTS.md §Calibration.
    OPT_UPDATE_TRANSIENT = 0.6

    @property
    def opt_transient_frac(self) -> float:
        return self.OPT_UPDATE_TRANSIENT if self.backend == "cpu" else 0.0

    @property
    def micro_batch(self) -> int:
        """Activations live per-microbatch under gradient accumulation."""
        return max(self.global_batch // max(self.grad_accum, 1), 1)

    @property
    def eff_microbatches(self) -> int:
        """Pipeline microbatch count that actually splits the batch.

        Without a pipeline (``pp == 1``) there is nothing to fill — the
        step is the plain fused step and ``microbatches`` is inert
        (gradient accumulation already models batch splitting there);
        serve steps never split either.
        """
        if self.pp > 1 and self.kind == "train":
            return max(self.microbatches, 1)
        return 1

    @property
    def pp_micro_batch(self) -> int:
        """Per-pipeline-microbatch batch size: the batch dimension every
        in-flight activation/loss term sees."""
        return max(self.micro_batch // self.eff_microbatches, 1)

    @property
    def dp(self) -> int:
        return (self.mesh_shape.get("data", 1)
                * self.mesh_shape.get("pod", 1))

    @property
    def ep(self) -> int:
        """Expert-parallel degree: the mesh's `expert` axis.  Divides
        ONLY the MoE `experts` weight stacks and `expert_buf` dispatch
        buffers (through the rule table) — never dense layers."""
        return int(self.mesh_shape.get(EXPERT_AXIS, 1))

    @property
    def cp(self) -> int:
        """Context-parallel (ring-attention) degree: the mesh's `context`
        axis.  Divides the seq dim of train/prefill activations through
        the `seq` rule; every TermSpec with a seq-axis dim scales
        automatically.  Decode caches stay on `cache_seq` (cp is
        rejected for decode by planner.check_parallel)."""
        return int(self.mesh_shape.get(CONTEXT_AXIS, 1))


def _stacked(p: ParamSpec, row: ParsedLayer) -> tuple[tuple, tuple]:
    """Shape/axes including the scan-stack leading dim."""
    if row.scanned:
        return (row.repeat,) + tuple(p.shape), \
            (AXIS_LAYERS,) + (tuple(p.axes) if p.axes
                              else (None,) * len(p.shape))
    return tuple(p.shape), tuple(p.axes) if p.axes else (None,) * len(p.shape)


def _psharding(p: ParamSpec, row: ParsedLayer, ctx: PredictContext) -> int:
    shape, axes = _stacked(p, row)
    extra = ("data",) if ctx.fsdp else ()
    return shard_factor(shape, axes, ctx.mesh_shape, ctx.rules, extra)


# ---------------------------------------------------------------------------
# factor 1: parameters
# ---------------------------------------------------------------------------


def param_factor(row: ParsedLayer, ctx: PredictContext) -> int:
    total = 0
    for p in row.layer.params.values():
        # stacked total bytes divided by the stacked shard factor
        total += p.nbytes * row.repeat // _psharding(p, row, ctx)
    return total


# ---------------------------------------------------------------------------
# factor 2: gradients
# ---------------------------------------------------------------------------


def grad_factor(row: ParsedLayer, ctx: PredictContext) -> int:
    if not row.trainable or ctx.kind != "train":
        return 0
    total = 0
    for p in row.layer.params.values():
        # grads share the param sharding (TP / FSDP); dtype per backend
        n = p.size * row.repeat
        total += n * ctx.eff_grad_bytes // _psharding(p, row, ctx)
    return total


# ---------------------------------------------------------------------------
# factor 3: optimizer states
# ---------------------------------------------------------------------------


def opt_bytes_for(p: ParamSpec, stacked_shape: tuple, optimizer: str,
                  master_fp32: bool = True) -> int:
    """Bytes of optimizer state for one (possibly stacked) param tensor.

    Mirrors train/optimizer.py exactly: any change there must land here.
    """
    size = math.prod(stacked_shape) if stacked_shape else 1
    if optimizer == "adamw":
        return size * (4 + 4 + (4 if master_fp32 else 0))      # m, v, master
    if optimizer == "adamw8bit":
        nblk = -(-size // 256)                                 # padded blocks
        scales = 2 * nblk * 4                                  # per-block fp32
        return 2 * nblk * 256 + size * (4 if master_fp32 else 0) + scales
    if optimizer == "adafactor":
        if len(stacked_shape) >= 2:
            r = math.prod(stacked_shape[:-1])
            c = math.prod(stacked_shape[:-2]) * stacked_shape[-1]
            return 4 * (r + c)                                 # v_row + v_col
        return 4 * size                                        # full v
    raise ValueError(optimizer)


def opt_factor(row: ParsedLayer, ctx: PredictContext) -> int:
    if not row.trainable or ctx.kind != "train":
        return 0
    total = 0
    for p in row.layer.params.values():
        shape, axes = _stacked(p, row)
        rep = 1 if row.scanned else row.repeat
        extra = ("data",) if (ctx.zero or ctx.fsdp) else ()
        denom = shard_factor(shape, axes, ctx.mesh_shape, ctx.rules, extra)
        total += opt_bytes_for(p, shape, ctx.optimizer,
                               ctx.master_fp32) * rep // denom
    return total


# ---------------------------------------------------------------------------
# factor 4: activations
# ---------------------------------------------------------------------------


def _term_bytes(t: ActTerm, ctx: PredictContext, batch: int,
                saved: bool = False) -> int:
    shape = t.concrete_shape(batch, ctx.seq_len, ctx.enc_seq)
    axes = t.axes if t.axes else (None,) * len(shape)
    denom = shard_factor(shape, axes, ctx.mesh_shape, ctx.rules)
    nb = eff_act_nbytes(dtype_bytes(t.dtype), ctx, saved)
    return math.prod(shape) * nb // max(denom, 1)


_DOT_KINDS = {"linear", "attention", "mlp", "moe", "ssm", "embedding"}


def _is_dot_term(t: ActTerm) -> bool:
    return not (t.name.endswith(".lse") or t.dtype == "int32")


def layer_act_terms(row: ParsedLayer, ctx: PredictContext,
                    batch: Optional[int] = None,
                    saved: bool = False) -> dict[str, int]:
    """Bytes of each activation tensor of ONE instance of this layer."""
    b = batch if batch is not None else ctx.pp_micro_batch
    return {t.name: _term_bytes(t, ctx, b, saved) for t in row.layer.acts}


def act_factor_saved(row: ParsedLayer, ctx: PredictContext) -> int:
    """Activation bytes SAVED for backward across all repeats of the layer
    under the remat policy.  Frozen layers save nothing (their backward is
    dead-code-eliminated); the paper's M_act rule for multimodal models.
    """
    if ctx.kind != "train" or not row.trainable or not row.layer.acts:
        return 0
    terms = layer_act_terms(row, ctx, saved=True)
    # weight-tied python-unrolled invocations (zamba2 shared blocks): all
    # invocations' activations are saved — no scan, no remat
    inv = row.layer.meta.get("invocation_repeat")
    if inv:
        return sum(terms.values()) * inv
    if not row.scanned or ctx.remat == "none":
        return sum(terms.values()) * row.repeat
    if ctx.remat == "dots":
        keep = sum(v for t, v in zip(row.layer.acts, terms.values())
                   if _is_dot_term(t))
        return keep * row.repeat
    # remat == "block": only the scan carry is saved per iteration; it is
    # attributed to the block's first layer (its ".in" term == block input).
    first = row.layer.acts[0]
    if first.name.endswith(".in") and row.layer.kind in ("rmsnorm",
                                                         "layernorm"):
        return terms[first.name] * row.repeat
    return 0


FLASH_CHUNK = 1024


def flash_tile_spec(row: ParsedLayer) -> Optional[TermSpec]:
    """Symbolic fp32 probability tiles of the two-level blocked flash
    attention: (B, q_chunk, H, kv_chunk) — the dominant attention
    transient.  None for non-attention rows; callers must additionally
    gate on ``ctx.kind != "decode"``."""
    if row.layer.kind != "attention":
        return None
    h = row.layer.meta.get("n_heads", 1)
    return TermSpec(dims=("mb", "qc", h, "qc"),
                    axes=("batch", "seq", "heads", None), nbytes=4)


def _flash_tile_bytes(row: ParsedLayer, ctx: PredictContext) -> int:
    spec = flash_tile_spec(row)
    if spec is None or ctx.kind == "decode":
        return 0
    return eval_term(spec, term_env(ctx), ctx.mesh_shape, ctx.rules)


def ring_kv_spec(row: ParsedLayer) -> Optional[TermSpec]:
    """Per-hop ring-attention KV block of one attention row under
    context parallelism: each cp shard holds its own KV slice plus one
    in-flight send + recv buffer pair rotating around the ring.  GQA
    rows rotate k+v ``(mb, seq, Hkv, hd)`` bf16 blocks (mult 4 = (k+v)
    x (send+recv)); MLA rows rotate the compressed latent.  The seq dim
    carries the `seq` axis so the block shards by cp (and SP's model
    split) exactly like the activations it travels with.  None for
    non-attention rows; callers gate on ``ctx.cp > 1`` and
    ``ctx.kind != "decode"`` (decode has no ring)."""
    if row.layer.kind != "attention":
        return None
    meta = row.layer.meta
    tok = "enc" if meta.get("cross") else "seq"
    if meta.get("attn_kind") == "mla":
        mla = meta["mla"]
        width = mla.kv_lora_rank + mla.qk_rope_head_dim
        return TermSpec(dims=("mb", tok, width),
                        axes=("batch", "seq", None), nbytes=2, mult=2)
    if "n_kv_heads" in meta:
        return TermSpec(dims=("mb", tok, meta["n_kv_heads"],
                              meta["head_dim"]),
                        axes=("batch", "seq", "kv_heads", None),
                        nbytes=2, mult=4)
    return None


def _ring_bytes(row: ParsedLayer, ctx: PredictContext) -> int:
    """Ring-hop send/recv transient (0 without a context axis > 1)."""
    if ctx.cp <= 1 or ctx.kind == "decode":
        return 0
    spec = ring_kv_spec(row)
    if spec is None:
        return 0
    return eval_term(spec, term_env(ctx), ctx.mesh_shape, ctx.rules)


def act_factor_transient(row: ParsedLayer, ctx: PredictContext) -> int:
    """Peak transient working set of ONE instance (recomputed block during
    its backward, or plain forward for frozen modules).  Under context
    parallelism the ring-attention per-hop KV send/recv buffers ride on
    top (folded into act_transient by the assembler)."""
    if not row.layer.acts:
        return 0
    total = sum(layer_act_terms(row, ctx).values())
    tiles = _flash_tile_bytes(row, ctx)
    ring = _ring_bytes(row, ctx)
    if ctx.kind == "train" and row.trainable:
        # recomputed fwd + cotangents (+ p and ds score tiles in the
        # flash backward)
        return 2 * total + 2 * tiles + ring
    return total + tiles + ring
