"""Peak-memory predictor (paper workflow step 6-7 + Eq. 1).

``predict(model, policy, ctx)`` evaluates the four factors for every parsed
layer and aggregates them with a schedule model of the compiled XLA step:

    peak = M_param + M_opt + M_grad                (persistent + backward)
         + M_act_saved (remat-aware scan carries)
         + max transient working set (one block's recomputed backward)
         + loss-head terms (hidden + one vocab-sharded logits chunk)
         + batch inputs (+ KV/SSM caches for serving)

Per-module subtotals are reported so the multimodal structure (frozen
vision tower vs. trainable language model) is visible, as in the paper.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.configs import ArchConfig
from repro_torch.core import factors as F
from repro_torch.core.parser import ParsedLayer, parse_model
from repro_torch.core.spec import TrainPolicy, dtype_bytes
from repro_torch.mesh_ctx import shard_factor

GiB = 1024 ** 3


@dataclass
class PredictedMemory:
    param_bytes: int = 0
    grad_bytes: int = 0
    opt_bytes: int = 0
    act_saved_bytes: int = 0
    act_transient_bytes: int = 0
    loss_bytes: int = 0
    input_bytes: int = 0
    cache_bytes: int = 0
    # updated trainable params: the optimizer writes NEW buffers while the
    # donated inputs are still live, so they cannot alias — one extra copy
    # of the trainable params exists at the end of every train step.
    output_copy_bytes: int = 0
    # per-chip constant overhead added by an applied CalibrationProfile
    # (repro_torch.calibrate); 0 on the uncalibrated path.
    calibration_bytes: int = 0
    # learned per-family correction added by an applied ResidualModel
    # (repro_torch.calibrate.learned), the structure left over AFTER the affine
    # profile; 0 (bit-inert) when no model is active.  May be negative.
    residual_bytes: int = 0
    # serving-fleet terms (0 unless ctx.serve is active): the paged
    # KV-pool allocation (replaces the slen-bearing cache terms, which
    # then report only their fixed non-paged remainder in cache_bytes)
    # and the speculative-decode draft model's residency (params + its
    # own pool) on the first stage.
    pool_bytes: int = 0
    draft_bytes: int = 0
    # informational: pool bytes the prefix-cache hit rate saved vs. the
    # same cell at hit-rate 0.  NOT part of peak_bytes.
    hit_saved_bytes: int = 0
    # liveness assembly (core.liveness): how much the legacy sum-of-maxima
    # OVERSTATES the true interval-overlap peak.  0 on the legacy path, so
    # legacy predictions stay bit-identical; under assembly="liveness"
    # peak_bytes is the component sum MINUS this slack, while the component
    # fields keep reporting the legacy breakdown they always did.
    overlap_slack_bytes: int = 0
    # Eq.1 offload tier: host-DRAM bytes of the offloaded optimizer
    # states (ctx.offload_opt).  Host memory, not HBM — NOT part of
    # peak_bytes, and a CalibrationProfile leaves it unscaled.
    offload_bytes: int = 0
    # pipeline-parallel provenance: which of n_stages stages this
    # prediction describes (0/1 on the non-pipelined path).  predict()
    # returns the max-peak stage; predict_stages() returns all of them.
    stage: int = 0
    n_stages: int = 1
    per_module: dict = field(default_factory=dict)
    # liveness assembly only: profile-term group -> bytes live at the
    # peak event (liveness.Replay.group_at_peak); sums to peak_bytes.
    # None on the legacy path — calibrate.residual uses it to build
    # liveness design rows without re-walking the event program.
    liveness_groups: Optional[dict] = None

    @property
    def peak_bytes(self) -> int:
        return (self.param_bytes + self.grad_bytes + self.opt_bytes
                + self.act_saved_bytes + self.act_transient_bytes
                + self.loss_bytes + self.input_bytes + self.cache_bytes
                + self.output_copy_bytes + self.calibration_bytes
                + self.residual_bytes
                + self.pool_bytes + self.draft_bytes
                - self.overlap_slack_bytes)

    def summary(self) -> str:
        rows = [("params", self.param_bytes), ("grads", self.grad_bytes),
                ("opt", self.opt_bytes), ("act_saved", self.act_saved_bytes),
                ("act_trans", self.act_transient_bytes),
                ("loss", self.loss_bytes), ("inputs", self.input_bytes),
                ("cache", self.cache_bytes),
                ("out_copy", self.output_copy_bytes),
                ("calib", self.calibration_bytes)]
        if self.residual_bytes:
            rows += [("learned", self.residual_bytes)]
        if self.pool_bytes or self.draft_bytes or self.hit_saved_bytes:
            rows += [("kv_pool", self.pool_bytes),
                     ("draft", self.draft_bytes),
                     ("hit_saved", self.hit_saved_bytes)]
        if self.offload_bytes:
            rows += [("host_opt", self.offload_bytes)]
        if self.overlap_slack_bytes:
            rows += [("ovl_slack", -self.overlap_slack_bytes)]
        rows += [("PEAK", self.peak_bytes)]
        out = "\n".join(f"  {k:<10s} {v / GiB:9.3f} GiB" for k, v in rows)
        if self.n_stages > 1:
            out = (f"  stage      {self.stage} of {self.n_stages} "
                   f"(pipeline max)\n") + out
        return out


# ---------------------------------------------------------------------------
# Symbolic term-spec functions.  Each returns cell-independent
# :class:`repro_torch.core.factors.TermSpec` lists whose symbolic dims are
# resolved against a knob environment (``factors.term_env`` scalar-side,
# int64 column arrays in ``core.batch``).  The scalar helpers below
# evaluate the SAME specs — the columnar path cannot diverge from them.
# ---------------------------------------------------------------------------


def loss_specs(cfg: ArchConfig, kind: str) -> list[F.TermSpec]:
    """hidden (B,S,D) bf16 saved + one logits chunk fp32 (vocab-sharded),
    forward + backward transient; serve steps keep one (B, 1, V) fp32
    logits row instead."""
    if kind != "train":
        return [F.TermSpec(dims=("gb", 1, cfg.vocab),
                           axes=("batch", None, "vocab"), nbytes=4)]
    return [F.TermSpec(dims=("mb", "seq", cfg.d_model),
                       axes=("batch", "seq", None), nbytes=2),
            F.TermSpec(dims=("mb", "chunk", cfg.vocab),
                       axes=("batch", None, "vocab"), nbytes=4, mult=2)]


def cache_specs(rows: list[ParsedLayer]) -> list[F.TermSpec]:
    """KV / latent / SSM cache byte terms for serving steps.

    Shapes/axes mirror the runtime cache layouts exactly (5-D GQA stacks,
    4-D MLA latents, 5-D SSM states) so non-divisible head counts replicate
    in prediction just as they do in execution.  On the cpu oracle a decode
    step's bf16 KV stacks additionally exist as a hoisted fp32 twin
    (XLA:CPU float normalization + LICM) — the ``cache_mult`` env dim.
    """
    specs: list[F.TermSpec] = []
    for r in rows:
        meta = r.layer.meta
        rep = meta.get("cache_repeat", r.repeat)
        if r.layer.kind == "attention" and "kv_bytes_per_token" in meta:
            tok = "tok_cross" if meta.get("cross") else "slen"
            if meta.get("attn_kind") == "mla":
                mla = meta["mla"]
                width = mla.kv_lora_rank + mla.qk_rope_head_dim
                specs.append(F.TermSpec(                   # bf16 latent
                    dims=(rep, "gb", tok, width, "cache_mult"),
                    axes=("layers", "batch", "cache_seq", None, None),
                    nbytes=2))
            else:
                hkv, hd = meta["n_kv_heads"], meta["head_dim"]
                specs.append(F.TermSpec(                   # k + v, bf16
                    dims=(rep, "gb", tok, hkv, hd, "cache_mult"),
                    axes=("layers", "batch", "cache_seq", "kv_heads", None,
                          None),
                    nbytes=2, mult=2))
        elif r.layer.kind == "ssm":
            h, p, n_st = meta["n_heads"], meta["head_dim"], meta["d_state"]
            specs.append(F.TermSpec(                       # fp32 state
                dims=(rep, "gb", h, p, n_st),
                axes=("layers", "batch", "ssm", None, None), nbytes=4))
            specs.append(F.TermSpec(                       # bf16 conv tail
                dims=(rep, "gb", meta["d_conv"] - 1, meta["conv_ch"],
                      "cache_mult"),
                axes=("layers", "batch", None, "ffn", None), nbytes=2))
    return specs


def _is_paged(spec: F.TermSpec) -> bool:
    """A cache term is pool-managed iff it grows with the live context
    (carries the ``slen`` dim).  Fixed-footprint terms — cross-attention
    caches over the encoder, SSM states, conv tails — are allocated once
    per sequence and never enter the block pool."""
    return "slen" in spec.dims


def pool_specs(rows: list[ParsedLayer]) -> list[F.TermSpec]:
    """The slen-growing cache terms of :func:`cache_specs`, re-keyed onto
    the ``pool_tok`` env dim: effective tokens per sequence after the
    serve knobs (block padding, utilization slack, prefix-cache hits,
    request mix).  With a neutral serve spec ``pool_tok == slen`` and
    these terms are byte-identical to their contiguous originals."""
    out = []
    for s in cache_specs(rows):
        if _is_paged(s):
            out.append(F.TermSpec(
                dims=tuple("pool_tok" if d == "slen" else d
                           for d in s.dims),
                axes=s.axes, nbytes=s.nbytes, mult=s.mult))
    return out


def fixed_cache_specs(rows: list[ParsedLayer]) -> list[F.TermSpec]:
    """The non-paged remainder of :func:`cache_specs` (see _is_paged)."""
    return [s for s in cache_specs(rows) if not _is_paged(s)]


def decode_transient_groups(
        rows: list[ParsedLayer]) -> list[list[F.TermSpec]]:
    """Per-attention-row spec groups of a decode step's transients: fp32
    scores over the cache, the in-scan cache-slice update copy, and (naive
    MLA) the per-layer expanded K/V.  The live transient is the worst
    row's group sum."""
    groups: list[list[F.TermSpec]] = []
    for r in rows:
        meta = r.layer.meta
        if r.layer.kind != "attention":
            continue
        h = meta.get("n_heads", 1)
        group = [F.TermSpec(dims=("gb", h, "slen"),     # scores + softmax
                            axes=("batch", "heads", "cache_seq"),
                            nbytes=4, mult=2)]
        if meta.get("attn_kind") == "mla":
            mla = meta["mla"]
            qk = mla.qk_nope_head_dim + mla.qk_rope_head_dim
            group.append(F.TermSpec(
                dims=("gb", "slen", h, qk + mla.v_head_dim),
                axes=("batch", "cache_seq", "heads", None), nbytes=2))
        elif "n_kv_heads" in meta:
            # dynamic-update-slice inside the layer scan cannot alias the
            # carried stack slice -> one layer's k+v update copy is live
            hkv, hd = meta["n_kv_heads"], meta["head_dim"]
            group.append(F.TermSpec(
                dims=("gb", "slen", hkv, hd),
                axes=("batch", "cache_seq", "kv_heads", None),
                nbytes=2, mult=2))
        groups.append(group)
    return groups


def boundary_specs(cfg: ArchConfig, kind: str) -> list[F.TermSpec]:
    """One stage-boundary activation buffer of the pipeline: the residual
    stream crossing a stage edge.  Train steps transfer one microbatch's
    (mb, S, D) bf16 block per edge (and the matching gradient on the way
    back — the x2 lives in :func:`repro_torch.core.stages.boundary_edges`
    callers); prefill sends the full-batch block, decode one token row.
    """
    if kind == "decode":
        return [F.TermSpec(dims=("gb", 1, cfg.d_model),
                           axes=("batch", "seq", None), nbytes=2)]
    if kind == "prefill":
        return [F.TermSpec(dims=("gb", "seq", cfg.d_model),
                           axes=("batch", "seq", None), nbytes=2)]
    return [F.TermSpec(dims=("mb", "seq", cfg.d_model),
                       axes=("batch", "seq", None), nbytes=2)]


def boundary_mult(stage: int, pp: int, kind: str) -> int:
    """Live boundary-buffer count for a stage: edges touching it, doubled
    in training (forward activation + backward gradient per edge)."""
    from repro_torch.core import stages as ST
    return ST.boundary_edges(stage, pp) * (2 if kind == "train" else 1)


def _boundary_bytes(cfg: ArchConfig, ctx: F.PredictContext, kind: str,
                    stage: int, n_stages: int) -> int:
    mult = boundary_mult(stage, n_stages, kind)
    if not mult:
        return 0
    env = F.term_env(ctx)
    return mult * sum(F.eval_term(s, env, ctx.mesh_shape, ctx.rules)
                      for s in boundary_specs(cfg, kind))


def embed_gather_const(rows: list[ParsedLayer], backend: str) -> int:
    """Tied (vocab-sharded) embedding tables are fully all-gathered by the
    token lookup — fp32 on the cpu oracle (float normalization).  Constant
    per (rows, backend): no cell knob touches it."""
    total = 0
    for r in rows:
        meta = r.layer.meta
        if r.layer.kind == "embedding" and meta.get("lookup_gather"):
            per = 4 if backend == "cpu" else 2
            total += meta["vocab"] * meta["d_model"] * per
    return total


# ---------------------------------------------------------------------------
# scalar evaluation of the spec groups above
# ---------------------------------------------------------------------------


def _loss_terms(cfg: ArchConfig, ctx: F.PredictContext) -> int:
    env = F.term_env(ctx)
    return sum(F.eval_term(s, env, ctx.mesh_shape, ctx.rules)
               for s in loss_specs(cfg, ctx.kind))


def _input_bytes(model, shape_kind: str, ctx: F.PredictContext) -> int:
    """Bytes of the batch arguments, sharded over batch.  Under pipeline
    parallelism the first stage stages one microbatch's inputs at a time
    (``eff_microbatches == 1`` without a pipeline, so this is the full
    batch on the non-pipelined path)."""
    from repro_torch.configs import ShapeConfig
    shape = ShapeConfig(
        "tmp", ctx.seq_len,
        max(ctx.global_batch // ctx.eff_microbatches, 1), shape_kind)
    total = 0
    for arr in model.batch_spec(shape).values():
        denom = shard_factor(arr.shape,
                             ("batch",) + (None,) * (len(arr.shape) - 1),
                             ctx.mesh_shape, ctx.rules)
        total += math.prod(arr.shape) * dtype_bytes(arr.dtype) // max(denom, 1)
    return total


def _cache_bytes(model, ctx: F.PredictContext,
                 rows: list[ParsedLayer]) -> int:
    if ctx.kind == "train":
        return 0
    env = F.term_env(ctx)
    specs = fixed_cache_specs(rows) if ctx.serve is not None \
        else cache_specs(rows)
    return sum(F.eval_term(s, env, ctx.mesh_shape, ctx.rules)
               for s in specs)


def _pool_terms(rows: list[ParsedLayer],
                ctx: F.PredictContext) -> tuple[int, int]:
    """(pool_bytes, hit_saved_bytes) of the paged KV pool — the
    slen-growing cache terms re-priced at ``pool_tok`` tokens per
    sequence.  hit_saved is the delta vs. the same cell with the
    prefix-cache hit rate forced to 0 (informational, not in peak)."""
    if ctx.kind == "train" or ctx.serve is None:
        return 0, 0
    import dataclasses
    from repro_torch.serve.pool import pool_tokens
    specs = pool_specs(rows)
    env = F.term_env(ctx)
    pool = sum(F.eval_term(s, env, ctx.mesh_shape, ctx.rules)
               for s in specs)
    saved = 0
    if ctx.serve.hit_bp:
        env0 = dict(env)
        env0["pool_tok"] = pool_tokens(
            ctx.max_len or ctx.seq_len,
            dataclasses.replace(ctx.serve, hit_bp=0))
        saved = sum(F.eval_term(s, env0, ctx.mesh_shape, ctx.rules)
                    for s in specs) - pool
    return pool, saved


@functools.lru_cache(maxsize=16)
def _draft_state(arch: str, kind: str):
    """(cfg, rows, rules) of a speculative-decode draft model — memoized:
    a pure function of (arch, kind), parsed under FULL_TRAIN (trainability
    is irrelevant at serve kinds, where grads/opt are zero by kind)."""
    from repro_torch.configs import get_config
    from repro_torch.core.spec import FULL_TRAIN
    from repro_torch.launch.mesh import arch_rules
    from repro_torch.models import build_model
    cfg = get_config(arch)
    rows = parse_model(build_model(cfg).spec, FULL_TRAIN)
    return cfg, rows, arch_rules(cfg, kind)


def draft_residency_bytes(ctx: F.PredictContext) -> int:
    """Speculative-decode draft-model residency: the draft's (frozen)
    params under ITS OWN sharding rules + fsdp flag, plus its KV pool and
    fixed caches under the same serve knobs (minus draft_arch — drafts
    don't nest).  Lives on the first pipeline stage with the inputs."""
    serve = ctx.serve
    if serve is None or not serve.draft_arch:
        return 0
    import dataclasses
    from repro_torch.core.sweep import normalize_arch
    dcfg, drows, drules = _draft_state(normalize_arch(serve.draft_arch),
                                       ctx.kind)
    dctx = dataclasses.replace(
        ctx, rules=drules, fsdp=dcfg.fsdp,
        serve=dataclasses.replace(serve, draft_arch=""))
    params = sum(F.param_factor(r, dctx) for r in drows)
    env = F.term_env(dctx)
    caches = sum(F.eval_term(s, env, dctx.mesh_shape, dctx.rules)
                 for s in pool_specs(drows) + fixed_cache_specs(drows))
    return params + caches


def _decode_transients(rows: list[ParsedLayer], ctx: F.PredictContext) -> int:
    env = F.term_env(ctx)
    worst = 0
    for group in decode_transient_groups(rows):
        t = sum(F.eval_term(s, env, ctx.mesh_shape, ctx.rules)
                for s in group)
        worst = max(worst, t)
    return worst


def _embed_gather_bytes(rows: list[ParsedLayer],
                        ctx: F.PredictContext) -> int:
    return embed_gather_const(rows, ctx.backend)


# ---------------------------------------------------------------------------
# Component terms.  ``predict`` is a pure composition of the three term
# groups below; they are split out (and returned as immutable dataclasses)
# so the capacity-planning sweep engine (core.sweep) can memoize each group
# independently — the static terms don't change with batch/remat, the
# activation terms don't change with optimizer — while staying byte-identical
# to a monolithic evaluation, because this is the only implementation.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StaticTerms:
    """Per-run-invariant factors: params, grads, optimizer states.

    Depends on (rows, mesh, rules, optimizer, fsdp, master_fp32,
    eff_grad_bytes, kind) — NOT on batch size, seq_len, or remat.
    """

    param_bytes: int
    grad_bytes: int
    opt_bytes: int
    output_copy_bytes: int
    # host-DRAM residency of the offloaded optimizer states (the Eq.1
    # offload tier); 0 unless ctx.offload_opt, in which case opt_bytes
    # above is the staged device window over this total.
    host_opt_bytes: int = 0
    # ((module_path, param, grad, opt, trainable), ...) in row order
    per_module: tuple = ()


@dataclass(frozen=True)
class ActTermsAgg:
    """Activation factors: saved-for-backward + worst transient working set.

    Depends on (rows, mesh, rules, micro_batch, seq_len, remat, backend,
    kind) — NOT on the optimizer.
    """

    saved_bytes: int
    transient_bytes: int
    # ((module_path, act_bytes), ...) in row order
    per_module: tuple = ()


@dataclass(frozen=True)
class OverheadTerms:
    """Loss head, batch inputs, serve caches, embed all-gathers, and (on
    pipeline stages) the stage-boundary send/recv buffers."""

    loss_bytes: int
    input_bytes: int
    cache_bytes: int
    embed_gather_bytes: int
    boundary_bytes: int = 0
    # serving-fleet terms (ctx.serve active): paged pool on the stage's
    # rows, draft residency on the first stage, prefix-hit savings info
    pool_bytes: int = 0
    draft_bytes: int = 0
    hit_saved_bytes: int = 0


def compute_static(rows: list[ParsedLayer],
                   ctx: F.PredictContext) -> StaticTerms:
    param = grad = opt = out_copy = 0
    per: dict[str, list] = {}
    for r in rows:
        p = F.param_factor(r, ctx)
        g = F.grad_factor(r, ctx)
        o = F.opt_factor(r, ctx)
        if ctx.kind == "train" and r.trainable:
            out_copy += p
        param += p
        grad += g
        opt += o
        m = per.setdefault(r.module_path, [0, 0, 0, r.trainable])
        m[0] += p
        m[1] += g
        m[2] += o
    host = 0
    if ctx.offload_opt and opt:
        # Eq.1 offload tier: the (already TP/ZeRO-sharded) state total
        # moves to host DRAM; the device keeps the double-buffered
        # streaming window.  per_module keeps reporting the pre-offload
        # residency — it documents where the bytes COME from.
        host, opt = opt, F.offload_staged_bytes(opt)
    return StaticTerms(
        param_bytes=param, grad_bytes=grad, opt_bytes=opt,
        output_copy_bytes=out_copy, host_opt_bytes=host,
        per_module=tuple((k, v[0], v[1], v[2], v[3])
                         for k, v in per.items()))


def compute_acts(rows: list[ParsedLayer], ctx: F.PredictContext,
                 kind: str, stash: int = 1) -> ActTermsAgg:
    """``stash`` multiplies the saved-for-backward set: the number of
    in-flight microbatch activation copies a pipeline stage holds under
    its schedule (``core.stages.stash_count``; 1 without a pipeline)."""
    saved = 0
    per: dict[str, int] = {}
    for r in rows:
        a = F.act_factor_saved(r, ctx) * stash
        saved += a
        per[r.module_path] = per.get(r.module_path, 0) + a

    if ctx.kind == "train":
        # one block's recomputed backward (or fwd-only if frozen) is the
        # live transient while the scan walks backward: scanned rows sum
        # per module (the whole block recomputes), unscanned rows stand
        # alone
        worst = 0
        block_sums: dict[str, int] = {}
        for r in rows:
            t = F.act_factor_transient(r, ctx)
            if r.scanned:
                block_sums[r.module_path] = \
                    block_sums.get(r.module_path, 0) + t
            else:
                worst = max(worst, t)
        transient = max(worst, max(block_sums.values(), default=0))
    elif kind == "decode":
        transient = _decode_transients(rows, ctx)
    else:  # prefill: no backward — transient = one block's forward set
        per_block: dict[str, int] = {}
        for r in rows:
            if r.scanned:
                per_block[r.module_path] = per_block.get(r.module_path, 0) \
                    + F.act_factor_transient(r, ctx)
        transient = max(per_block.values()) if per_block else 0
    return ActTermsAgg(saved_bytes=saved, transient_bytes=transient,
                       per_module=tuple(per.items()))


def compute_overheads(model, rows: list[ParsedLayer],
                      ctx: F.PredictContext, kind: str, stage: int = 0,
                      n_stages: int = 1) -> OverheadTerms:
    """Overhead terms of one pipeline stage (the whole model by default):
    batch inputs live on the first stage, the loss head on the last,
    caches/embed-gathers wherever their rows landed, boundary buffers on
    every stage with a pipeline edge."""
    first = stage == 0
    last = stage == n_stages - 1
    pool, hit_saved = _pool_terms(rows, ctx)
    return OverheadTerms(
        loss_bytes=_loss_terms(model.cfg, ctx) if last else 0,
        input_bytes=_input_bytes(model, kind, ctx) if first else 0,
        cache_bytes=_cache_bytes(model, ctx, rows),
        embed_gather_bytes=_embed_gather_bytes(rows, ctx),
        boundary_bytes=_boundary_bytes(model.cfg, ctx, kind, stage,
                                       n_stages),
        pool_bytes=pool,
        draft_bytes=draft_residency_bytes(ctx) if first else 0,
        hit_saved_bytes=hit_saved)


def liveness_values(static: StaticTerms, acts: ActTermsAgg,
                    over: OverheadTerms, ctx: F.PredictContext,
                    pred: PredictedMemory = None, profile=None) -> dict:
    """Component byte values for the liveness event program
    (``core.liveness.COMPONENTS``).  With ``pred``+``profile`` given the
    values are the CALIBRATED ones: per-field scales come straight off the
    applied prediction and the act_transient group members are telescoped
    (``liveness.telescoped_transient``) so they sum back to the legacy
    group scale byte-exactly."""
    from repro_torch.core import liveness as LV
    opt_trans = int(ctx.opt_transient_frac * static.opt_bytes)
    raw_trans = {"embed": over.embed_gather_bytes,
                 "boundary": over.boundary_bytes,
                 "transient": acts.transient_bytes,
                 "opt_transient": opt_trans}
    if profile is None:
        return {
            "base": (static.param_bytes + static.grad_bytes
                     + static.opt_bytes),
            "inputs": over.input_bytes, "cache": over.cache_bytes,
            "pool": over.pool_bytes, "draft": over.draft_bytes,
            "saved": acts.saved_bytes, "loss": over.loss_bytes,
            "out_copy": static.output_copy_bytes, **raw_trans,
        }
    c_t = profile.coef("act_transient")
    return {
        # chip constant: persistent allocator overhead -> rides the base
        "base": (pred.param_bytes + pred.grad_bytes + pred.opt_bytes
                 + pred.calibration_bytes),
        "inputs": pred.input_bytes, "cache": pred.cache_bytes,
        "pool": pred.pool_bytes, "draft": pred.draft_bytes,
        "saved": pred.act_saved_bytes, "loss": pred.loss_bytes,
        "out_copy": pred.output_copy_bytes,
        **LV.telescoped_transient(raw_trans,
                                  lambda v: int(round(v * c_t))),
    }


def assemble(static: StaticTerms, acts: ActTermsAgg, over: OverheadTerms,
             ctx: F.PredictContext, profile=None,
             chip: str = None, stage: int = 0,
             n_stages: int = 1, assembly: str = "legacy") -> PredictedMemory:
    """Compose the component groups into a prediction; when a
    CalibrationProfile (repro_torch.calibrate.profile) is given, its per-term
    corrections + the ``chip`` constant are applied to the RAW composition
    (duck-typed — the profile scales, this module never imports it).

    ``assembly`` selects the peak model: ``"legacy"`` (default) keeps the
    Eq.1 sum-of-maxima bit-identical to every golden; ``"liveness"``
    replays the interval-overlap event program (core.liveness) and records
    the overestimate as ``overlap_slack_bytes``, so ``peak_bytes`` becomes
    the true overlap peak while the component breakdown stays legacy."""
    out = PredictedMemory(
        param_bytes=static.param_bytes, grad_bytes=static.grad_bytes,
        opt_bytes=static.opt_bytes,
        act_saved_bytes=acts.saved_bytes,
        # optimizer-update in-flight fp32 stacks (cpu oracle; ZeRO-sharded)
        # + pipeline boundary send/recv buffers: transient working set
        act_transient_bytes=(acts.transient_bytes
                             + over.embed_gather_bytes
                             + over.boundary_bytes
                             + int(ctx.opt_transient_frac
                                   * static.opt_bytes)),
        loss_bytes=over.loss_bytes, input_bytes=over.input_bytes,
        cache_bytes=over.cache_bytes,
        output_copy_bytes=static.output_copy_bytes,
        pool_bytes=over.pool_bytes, draft_bytes=over.draft_bytes,
        hit_saved_bytes=over.hit_saved_bytes,
        offload_bytes=static.host_opt_bytes,
        stage=stage, n_stages=n_stages)
    for path, p, g, o, trainable in static.per_module:
        out.per_module[path] = {"param": p, "grad": g, "opt": o, "act": 0,
                                "trainable": trainable}
    for path, a in acts.per_module:
        out.per_module[path]["act"] = a
    if profile is not None:
        out = profile.apply(out, chip)
    if assembly == "liveness":
        from repro_torch.core import liveness as LV
        vals = liveness_values(static, acts, over, ctx, pred=out,
                               profile=profile)
        rep = LV.replay(LV.compile_program(ctx.kind), vals)
        slack = out.peak_bytes - rep.peak
        # every event prefix is a sub-sum of the non-negative component
        # values whose total IS the legacy peak -> slack can never go
        # negative; this is the soundness invariant docs/search.md leans on
        assert slack >= 0, (slack, vals)
        out.overlap_slack_bytes = slack
        out.liveness_groups = dict(rep.group_at_peak)
    elif assembly != "legacy":
        raise ValueError(f"unknown assembly {assembly!r}; "
                         f"expected one of ('legacy', 'liveness')")
    return out


def predict_stages(model, policy: TrainPolicy, ctx: F.PredictContext,
                   shape_kind: str = None,
                   rows: list[ParsedLayer] = None, profile=None,
                   chip: str = None,
                   assembly: str = "legacy") -> list[PredictedMemory]:
    """One prediction per pipeline stage (a single-element list when
    ``ctx.pp == 1`` — that element is bit-equal to the non-pipelined
    path, because it IS the non-pipelined path)."""
    from repro_torch.core import stages as ST
    if rows is None:
        rows = parse_model(model.spec, policy)
    kind = shape_kind or ctx.kind
    if ctx.pp <= 1:
        return [assemble(compute_static(rows, ctx),
                         compute_acts(rows, ctx, kind),
                         compute_overheads(model, rows, ctx, kind), ctx,
                         profile=profile, chip=chip, assembly=assembly)]
    plan = ST.partition(rows, ctx.pp)
    out = []
    for s, srows in enumerate(plan.stages):
        srows = list(srows)
        stash = ST.stash_count(s, ctx.pp, ctx.eff_microbatches,
                               ctx.schedule)
        out.append(assemble(
            compute_static(srows, ctx),
            compute_acts(srows, ctx, kind, stash=stash),
            compute_overheads(model, srows, ctx, kind, stage=s,
                              n_stages=ctx.pp),
            ctx, profile=profile, chip=chip, stage=s, n_stages=ctx.pp,
            assembly=assembly))
    return out


def predict(model, policy: TrainPolicy, ctx: F.PredictContext,
            shape_kind: str = None,
            rows: list[ParsedLayer] = None, profile=None,
            chip: str = None, assembly: str = "legacy") -> PredictedMemory:
    """Peak prediction: the worst stage under pipeline parallelism (the
    whole model when ``ctx.pp == 1``); ties keep the earliest stage.
    Under ``assembly="liveness"`` the comparison key is the liveness peak
    (``peak_bytes`` already nets out ``overlap_slack_bytes``)."""
    preds = predict_stages(model, policy, ctx, shape_kind=shape_kind,
                           rows=rows, profile=profile, chip=chip,
                           assembly=assembly)
    best = preds[0]
    for p in preds[1:]:
        if p.peak_bytes > best.peak_bytes:
            best = p
    return best


def per_device(pred: PredictedMemory) -> int:
    return pred.peak_bytes
