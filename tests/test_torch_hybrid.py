"""Port of the hybrid SSM + shared-attention family
(``repro_torch.models.hybrid``: ``hybrid_backbone``, ``hybrid_loss``,
``hybrid_prefill``, ``hybrid_decode_step``, ``hybrid_init_cache``, and
zamba2-2.7b's ``Model`` entry points) against the reference package, on
the CPU.

Two configs: the reduced zamba2-2.7b (2 mamba blocks, one segment, one
shared block, head dim 16) and a three-segment variant (``n_layers=6,
attn_every=2, shared_attn_blocks=2``: shared blocks A / B / A, so block A's
tensors run twice and its gradient sums both invocations).  The
reference's parameters (PRNGKey(0)) are carried across with
``from_numpy``; inputs are made with numpy from a seed.  The reference
runs eagerly (``jax.disable_jit``), op for op (C6), except where a test
reads its jitted program too.

Tolerances, those of tests/test_torch_ssm_train.py and
tests/test_torch_mamba.py:

* fp32: the loss within 1e-5 relative, each gradient leaf within 1e-4 of
  its scale (max |ref|), under remat none and block; one AdamW step's
  metrics within 1e-5 relative and every leaf within 1e-4 of its scale;
* bf16: the loss within 2e-2; each gradient leaf within the larger of
  2e-2 of its scale and that leaf's jitted-vs-eager spread in the
  reference (C8's rule takes 1.5x the spread and caps it at 5e-2; the
  hybrid's reference spreads past the cap, up to 0.26 of scale on a
  mamba block's ``A_log``, so the cap is dropped and the factor tightened
  to 1x: the port stays no further from the eager reference than the
  reference's own jitted program, past the 2e-2 floor);
* serving (bf16): logits and every cache leaf within 2e-2 of
  max(1, max |ref|).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import spec as RSPEC
from repro.models import build_model as ref_build
from repro.serve import generate as ref_generate
from repro.serve import pad_cache as ref_pad_cache
from repro.train import optimizer as RO
from repro.train import train_step as RTS
from repro_torch.configs import get_config
from repro_torch.core.spec import FULL_TRAIN
from repro_torch.kernels import flash_attention as FL
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ssd as SSD
from repro_torch.models import build_model
from repro_torch.models import hybrid as TH
from repro_torch.models import param as TPM
from repro_torch.serve import serve_step as TS
from repro_torch.train import OptimizerConfig, make_train_step, train_state
from tests.test_torch_train import leaf_close, ref_leaf, to_torch

ARCH = "zamba2-2.7b"
B, SEQ = 2, 40                 # one SSD chunk of 32 and a ragged rest of 8
TOL = 2e-2
# the reduced config as it is, and three segments over two shared blocks
VARIANTS = {"reduced": {},
            "three_segments": {"n_layers": 6, "attn_every": 2,
                               "shared_attn_blocks": 2}}


def config_of(get, variant: str, dtype: str = None, **extra):
    """A package's (``get``) reduced zamba2 config, changed by the variant
    (and ``extra``), the same way in both packages."""
    cfg = get(ARCH).reduced()
    knobs = {**VARIANTS[variant], **extra}
    hyb = {k: knobs.pop(k) for k in ("attn_every", "shared_attn_blocks")
           if k in knobs}
    if hyb:
        cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(
            cfg.hybrid, **hyb))
    if dtype:
        knobs["dtype"] = dtype
    return dataclasses.replace(cfg, **knobs)


_PAIRS = {}


def pair_of(variant: str, dtype: str = "bfloat16", **extra):
    """(ref model, ref params, port model, port params) of a variant."""
    key = (variant, dtype, tuple(sorted(extra.items())))
    if key not in _PAIRS:
        rmodel = ref_build(config_of(ref_config, variant, dtype, **extra))
        rparams = rmodel.init(jax.random.PRNGKey(0))
        tmodel = build_model(config_of(get_config, variant, dtype, **extra))
        tparams = tmodel.from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
        _PAIRS[key] = (rmodel, rparams, tmodel, tparams)
    return _PAIRS[key]


def rel(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, what: str) -> None:
    want = f32(want)
    tol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(f32(got), want, rtol=0, atol=tol,
                               err_msg=what)


def batch_of(seed: int, vocab: int = 256, b: int = B, s: int = SEQ):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def tokens(n: int, seed: int, b: int = B) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (b, n)) \
        .astype(np.int32)


def port_loss_and_grads(tmodel, tparams, batch, remat=None):
    TPM.set_trainable(tparams, FULL_TRAIN)
    try:
        named = TPM.trainable_params(tparams)
        loss, metrics = tmodel.loss(tparams, {k: to_torch(v)
                                              for k, v in batch.items()},
                                    remat=remat)
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    materialize_grads=True)
    finally:
        for p in tparams.parameters():
            p.requires_grad_(False)
    return loss, metrics, dict(zip([n for n, _ in named], grads))


# ---------------------------------------------------------------------------
# parameters and the segments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_params_carry_across_and_segments_alternate(variant):
    rmodel, rparams, tmodel, tparams = pair_of(variant)
    cfg = tmodel.cfg
    lm = tparams.language_model
    assert len(lm.shared_attn) == cfg.hybrid.shared_attn_blocks
    assert len(lm.blocks) == cfg.n_layers
    assert TPM.count_params(tparams) == sum(
        np.asarray(a).size for a in jax.tree.leaves(rparams))
    for name, p in tparams.named_parameters():
        assert np.array_equal(f32(p), ref_leaf(rparams, name)), name
    segs = [(s, [i for i in layers]) for s, _, layers in
            TH._segments(cfg, lm)]
    every = cfg.hybrid.attn_every
    assert segs == [(s, list(range(s * every, (s + 1) * every)))
                    for s in range(cfg.n_layers // every)]
    shared = [sp for _, sp, _ in TH._segments(cfg, lm)]
    nb = cfg.hybrid.shared_attn_blocks
    assert all(sp is lm.shared_attn[s % nb] for s, sp in enumerate(shared))
    # the optimizer sees the reference's stacked shared leaf
    TPM.set_trainable(tparams, FULL_TRAIN)
    try:
        leaves = {leaf.name: leaf for leaf in TPM.trainable_leaves(tparams)}
    finally:
        for p in tparams.parameters():
            p.requires_grad_(False)
    wq = leaves["language_model.shared_attn.attn.wq"]
    assert wq.stacked and wq.shape == tuple(
        rparams["language_model"]["shared_attn"]["attn"]["wq"].shape)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_grads_match_the_reference_fp32(variant, remat):
    rmodel, rparams, tmodel, tparams = pair_of(variant, "float32")
    batch = batch_of(1)
    vg = jax.value_and_grad(
        lambda p, b: rmodel.loss(p, b, remat=remat), has_aux=True)
    with jax.disable_jit():
        (want, metrics), grads = vg(rparams, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
    loss, tmetrics, tgrads = port_loss_and_grads(tmodel, tparams, batch,
                                                 remat)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics["xent"]),
                               float(metrics["xent"]), rtol=1e-5)
    assert float(tmetrics["n_tok"]) == float(metrics["n_tok"]) == B * SEQ
    assert len(tgrads) == len(list(tparams.parameters()))
    for name, g in tgrads.items():
        p = dict(tparams.named_parameters())[name]
        assert g.dtype == p.dtype and g.shape == p.shape, name
        assert bool(g.abs().max() > 0), name       # every leaf learns
        leaf_close(g, ref_leaf(grads, name), 1e-4, f"d{name} ({remat})")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_grads_match_the_eager_reference_bf16(variant):
    rmodel, rparams, tmodel, tparams = pair_of(variant)
    batch = batch_of(4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vg = jax.value_and_grad(rmodel.loss, has_aux=True)
    with jax.disable_jit():
        (want, _), grads = vg(rparams, jb)
    (_, _), jit_grads = jax.jit(vg)(rparams, jb)
    loss, _, tgrads = port_loss_and_grads(tmodel, tparams, batch)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=2e-2)
    for name, g in tgrads.items():
        want_g = ref_leaf(grads, name)
        spread = rel(ref_leaf(jit_grads, name), want_g)
        leaf_close(g, want_g, max(2e-2, spread),
                   f"d{name} (reference jit-vs-eager spread {spread:.3g})")


def test_remat_block_gives_the_grads_of_remat_none():
    """Under "block" only the mamba blocks rerun (twice per step, the
    recompute), the shared invocations once; loss and every gradient
    bit-equal to remat "none"."""
    rmodel, rparams, tmodel, tparams = pair_of("three_segments", "float32")
    calls = {"mamba": 0, "shared": 0}
    fwd, shared = TH.mamba2_forward, TH._shared_block
    batch = batch_of(2)
    runs = {}
    try:
        TH.mamba2_forward = lambda *a, **k: (
            calls.__setitem__("mamba", calls["mamba"] + 1) or fwd(*a, **k))
        TH._shared_block = lambda *a, **k: (
            calls.__setitem__("shared", calls["shared"] + 1)
            or shared(*a, **k))
        for remat in ("none", "block"):
            calls.update(mamba=0, shared=0)
            runs[remat] = port_loss_and_grads(tmodel, tparams, batch, remat)
            runs[remat + "_calls"] = dict(calls)
    finally:
        TH.mamba2_forward, TH._shared_block = fwd, shared
    n_inv = tmodel.cfg.n_layers // tmodel.cfg.hybrid.attn_every
    assert runs["none_calls"] == {"mamba": tmodel.cfg.n_layers,
                                  "shared": n_inv}
    assert runs["block_calls"] == {"mamba": 2 * tmodel.cfg.n_layers,
                                   "shared": n_inv}
    loss0, _, grads0 = runs["none"]
    loss, _, grads = runs["block"]
    assert torch.equal(loss, loss0)
    for name in grads0:
        assert torch.equal(grads[name], grads0[name]), name


def test_one_adamw_step_matches_the_reference():
    """One AdamW ``make_train_step`` step under FULL_TRAIN against the
    reference's jitted step, on three segments over two shared blocks:
    the stacked shared leaf updated as one."""
    rmodel, rparams, _, _ = pair_of("three_segments", "float32")
    tmodel = build_model(config_of(get_config, "three_segments", "float32"))
    batch = batch_of(6)
    rcfg = RO.OptimizerConfig(name="adamw")
    mask = RTS.PM.trainable_mask(rmodel.spec, RSPEC.FULL_TRAIN)
    trainable, _ = RTS.PM.partition_params(rparams, mask)
    rstate = RTS.TrainState(params=rparams,
                            opt=RO.init_opt_state(trainable, rcfg),
                            step=jnp.zeros((), jnp.int32))
    rstate, rmetrics = jax.jit(RTS.make_train_step(
        rmodel, RSPEC.FULL_TRAIN, rcfg))(
        rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = tmodel.from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    before = {n: p.detach().clone() for n, p in tparams.named_parameters()}
    tstate = train_state(tparams, FULL_TRAIN, OptimizerConfig(name="adamw"))
    assert "language_model.shared_attn.attn.wq" in tstate.opt
    tstate, tmetrics = make_train_step(
        tmodel, FULL_TRAIN, OptimizerConfig(name="adamw"))(
        tstate, {k: to_torch(v) for k, v in batch.items()})
    for key in ("loss", "xent", "grad_norm"):
        np.testing.assert_allclose(float(tmetrics[key]),
                                   float(rmetrics[key]), rtol=1e-5,
                                   err_msg=key)
    for name, p in tstate.params.named_parameters():
        assert not torch.equal(p.detach(), before[name]), name
        leaf_close(p, ref_leaf(rstate.params, name), 1e-4, name)


def test_training_launches_follow_the_reference_program(monkeypatch):
    """Per loss-and-backward under remat "block": flash forward once per
    shared invocation and its backward once; RMSNorm forward twice per
    mamba block (block norm, gated norm; rerun by the recompute) and
    twice per invocation, plus the final norm; RMSNorm backward once each
    — zamba2's 9 / 9 / 235 / 127 at full depth."""
    rmodel, rparams, tmodel, tparams = pair_of("three_segments", "float32")
    calls = {"flash": 0, "flash_bwd": 0, "rms": 0, "rms_bwd": 0}
    fwd, bwd = TO._fa.flash_fwd, TO._fa.flash_bwd
    rfwd, rbwd = TO._rn.rmsnorm_fwd, TO._rn.rmsnorm_bwd

    def counting(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call
    monkeypatch.setattr(TO._fa, "flash_fwd", counting("flash", fwd))
    monkeypatch.setattr(TO._fa, "flash_bwd", counting("flash_bwd", bwd))
    monkeypatch.setattr(TO._rn, "rmsnorm_fwd", counting("rms", rfwd))
    monkeypatch.setattr(TO._rn, "rmsnorm_bwd", counting("rms_bwd", rbwd))
    port_loss_and_grads(tmodel, tparams, batch_of(3), "block")
    L, n = tmodel.cfg.n_layers, 3
    assert calls == {"flash": n, "flash_bwd": n,
                     "rms": 2 * 2 * L + 2 * n + 1,
                     "rms_bwd": 2 * L + 2 * n + 1}
    full = get_config(ARCH)
    n_full = full.n_layers // full.hybrid.attn_every
    assert (2 * 2 * full.n_layers + 2 * n_full + 1,
            2 * full.n_layers + 2 * n_full + 1) == (235, 127)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _prefill_both(variant: str, toks: np.ndarray, **extra):
    rmodel, rparams, tmodel, tparams = pair_of(variant, **extra)
    with jax.disable_jit():
        want, wcache = rmodel.prefill(rparams, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, gcache = tmodel.prefill(tparams,
                                     {"tokens": torch.from_numpy(toks)})
    return want, wcache, got, gcache


def _cache_close(gcache, wcache, what: str, n_run: int = None) -> None:
    """Every cache leaf of the port against the reference's; ``n_run``:
    the mamba blocks the reference ran (its stack holds only those)."""
    blocks = gcache["blocks"]
    assert set(blocks) == set(wcache["blocks"]) == {"ssm", "conv"}
    assert blocks["ssm"].dtype == torch.float32
    assert blocks["conv"].dtype == torch.bfloat16
    for key in ("ssm", "conv"):
        got = blocks[key][:n_run] if n_run else blocks[key]
        assert tuple(got.shape) == wcache["blocks"][key].shape, key
        close(got, wcache["blocks"][key], f"{what} cache {key}")
    assert set(gcache["attn"]) == set(wcache["attn"]) == {"k", "v"}
    for key in ("k", "v"):
        leaf = gcache["attn"][key]
        assert leaf.dtype == torch.bfloat16
        assert tuple(leaf.shape) == wcache["attn"][key].shape, key
        close(leaf, wcache["attn"][key], f"{what} cache attn {key}")
    assert gcache["len"].dtype == torch.int32
    assert np.array_equal(gcache["len"].numpy(), np.asarray(wcache["len"]))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_logits_and_cache_match_the_reference(variant):
    want, wcache, got, gcache = _prefill_both(variant, tokens(SEQ, 1))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape \
        == (B, 1, 256)
    close(got, want, "prefill logits")
    _cache_close(gcache, wcache, "prefill")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_steps_match_the_reference(variant):
    """One decode step, then more teacher-forced ones, from each side's
    prefill cache grown by ``pad_cache``: the logits and every cache leaf;
    the port's cache tensors are updated in place."""
    rmodel, rparams, tmodel, tparams = pair_of(variant)
    want, wcache, got, gcache = _prefill_both(variant, tokens(SEQ, 1))
    n = 4
    wcache, gcache = ref_pad_cache(wcache, n), TS.pad_cache(gcache, n)
    ptrs = {k: gcache["attn"][k].data_ptr() for k in ("k", "v")}
    ptrs["ssm"] = gcache["blocks"]["ssm"].data_ptr()
    toks = tokens(n, 4)
    for step in range(n):
        tok = toks[:, step:step + 1]
        with jax.disable_jit():
            want, wcache = rmodel.decode_step(rparams, jnp.asarray(tok),
                                              wcache)
        with torch.inference_mode():
            got, gcache = tmodel.decode_step(tparams, torch.from_numpy(tok),
                                             gcache)
        close(got, want, f"decode step {step} logits")
        if step == 0:
            _cache_close(gcache, wcache, "after one decode step")
    _cache_close(gcache, wcache, "after the decode steps")
    assert ptrs == {"k": gcache["attn"]["k"].data_ptr(),
                    "v": gcache["attn"]["v"].data_ptr(),
                    "ssm": gcache["blocks"]["ssm"].data_ptr()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_teacher_forced_decode_reproduces_prefill(variant, dtype):
    """The port's token-by-token decode from an empty cache gives the
    last-position logits of its own prefill over the same tokens, within
    the bound of the twin tests/test_models.py::test_decode_matches_forward
    (2e-2 absolute and relative).  The two programs differ by more than
    rounding order: decode attends over the bf16 K/V cache, prefill over
    its own K/V, so the shared block's output moves each later block's
    input — the caches are held to the reference instead
    (``test_decode_steps_match_the_reference``)."""
    _, _, tmodel, tparams = pair_of(variant, dtype)
    S = 16
    toks = torch.from_numpy(tokens(S, 5)[:1])
    with torch.inference_mode():
        full, _ = tmodel.prefill(tparams, {"tokens": toks})
        cache = tmodel.init_cache(1, S, "cpu")
        for t in range(S):
            step, cache = tmodel.decode_step(tparams, toks[:, t:t + 1],
                                             cache)
    np.testing.assert_allclose(f32(full[:, -1]).ravel(),
                               f32(step[:, 0]).ravel(), atol=TOL, rtol=TOL)
    assert int(cache["len"][0]) == S


def test_serving_launches_follow_the_reference_program(monkeypatch):
    """The reference's program: per prefill one flash forward per shared
    invocation, one SSD per mamba block, RMSNorm twice per mamba block,
    three times per invocation (``norm1`` again for the cached K/V) and
    the final norm; per decode step no flash and no SSD, RMSNorm twice
    per block and per invocation and the final norm — zamba2's 9 / 54 /
    136 and 0 / 0 / 127 at full depth.  The SSD gets the views its CUDA
    kernel takes."""
    _, _, tmodel, tparams = pair_of("three_segments")
    calls = {"flash": 0, "ssd": 0, "rms": 0}
    flash, ssd, rms = TO._fa.flash_fwd, SSD.ssd_scan, TO._rn.rmsnorm_fwd

    def count_ssd(x, dt, A, Bm, Cm, chunk):
        calls["ssd"] += 1
        SSD.check_kernel_operands(x, dt, A, Bm, Cm, min(chunk, x.shape[1]))
        return ssd(x, dt, A, Bm, Cm, chunk)

    def count(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call
    monkeypatch.setattr(SSD, "ssd_scan", count_ssd)
    monkeypatch.setattr(TO._fa, "flash_fwd", count("flash", flash))
    monkeypatch.setattr(TO._rn, "rmsnorm_fwd", count("rms", rms))
    toks = torch.from_numpy(tokens(12, 3))
    with torch.inference_mode():
        _, cache = tmodel.prefill(tparams, {"tokens": toks})
    L, n = tmodel.cfg.n_layers, 3
    assert calls == {"flash": n, "ssd": L, "rms": 2 * L + 3 * n + 1}
    with torch.inference_mode():
        tmodel.decode_step(tparams, toks[:, :1], TS.pad_cache(cache, 1))
    assert calls == {"flash": n, "ssd": L,
                     "rms": 2 * L + 3 * n + 1 + 2 * L + 2 * n + 1}
    full = get_config(ARCH)
    n_full = full.n_layers // full.hybrid.attn_every
    assert (2 * full.n_layers + 3 * n_full + 1,
            2 * full.n_layers + 2 * n_full + 1) == (136, 127)
    assert FL.launches == 0 and SSD.launches == 0   # the CPU runs no kernel


def test_short_prompt_keeps_the_conv_window_causal():
    """A prompt shorter than the conv window (C10), in fp32 (the window a
    bf16 decode leaves differs by the K/V cache's rounding, as above): the
    prefill cache's window holds the prompt at its end and zeros before
    it, the window and every other leaf within 2e-2 of those a decode of
    the same tokens from an empty cache leaves, and the next decode step
    runs on it (the reference's fails to broadcast)."""
    _, _, tmodel, tparams = pair_of("three_segments", "float32")
    toks = torch.from_numpy(tokens(2, 6))
    with torch.inference_mode():
        _, pcache = tmodel.prefill(tparams, {"tokens": toks})
        cache = tmodel.init_cache(B, 2, "cpu")
        for t in range(2):
            _, cache = tmodel.decode_step(tparams, toks[:, t:t + 1], cache)
    conv = pcache["blocks"]["conv"]
    assert tuple(conv.shape) == tuple(cache["blocks"]["conv"].shape)
    assert not conv[:, :, 0].any()            # before the prompt: zeros
    assert conv[:, :, 1:].all()
    close(conv, cache["blocks"]["conv"], "conv window")
    close(pcache["blocks"]["ssm"], cache["blocks"]["ssm"], "ssm state")
    for key in ("k", "v"):
        close(pcache["attn"][key], cache["attn"][key], f"attn {key}")
    with torch.inference_mode():
        logits, _ = tmodel.decode_step(tparams, toks[:, :1],
                                       TS.pad_cache(pcache, 1))
    assert bool(torch.isfinite(logits).all())


def test_generate_matches_the_reference_where_the_margin_is_clear():
    """Greedy tokens through ``generate`` on the CPU equal the reference's
    at every step whose top-2 logit margin exceeds twice the tolerance;
    past the first that does not, nothing more is compared."""
    rmodel, rparams, tmodel, tparams = pair_of("three_segments")
    batch = {"tokens": tokens(24, 7)}
    n_new = 6
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(ref_generate(rmodel, rparams, jb, n_new))
    with jax.disable_jit():
        logits, cache = rmodel.prefill(rparams, jb)
        cache = ref_pad_cache(cache, n_new)
        steps = [np.asarray(logits[:, -1], np.float32)]
        for i in range(n_new - 1):
            logits, cache = rmodel.decode_step(
                rparams, jnp.asarray(want[:, i:i + 1]), cache)
            steps.append(np.asarray(logits[:, -1], np.float32))
    got = TS.generate(tmodel, tparams, batch, n_new, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, n_new)
    got = got.numpy()
    compared = 0
    for b in range(B):
        for i, lg in enumerate(steps):
            top2 = np.sort(lg[b])[-2:]
            if top2[1] - top2[0] <= 2 * TOL * max(1.0, np.abs(lg).max()):
                break
            assert got[b, i] == want[b, i], (b, i)
            compared += 1
    assert compared >= B


def test_entry_points_run_on_cuda_by_default(monkeypatch):
    _, _, tmodel, tparams = pair_of("reduced")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = {"tokens": tokens(4, 8)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.generate(tmodel, tparams, batch, 2)
    with pytest.raises((RuntimeError, AssertionError)):
        tmodel.init(torch.Generator().manual_seed(0))     # cuda by default
    with pytest.raises((RuntimeError, AssertionError)):
        tmodel.init_cache(1, 4)
    out = TS.generate(tmodel, tparams, batch, 3, device="cpu")
    assert tuple(out.shape) == (B, 3) and out.device.type == "cpu"


def test_non_dividing_config_runs_the_reference_blocks():
    """``n_layers % attn_every != 0`` (ROADMAP C16): the reference runs
    only the first ``(n_layers // attn_every) * attn_every`` mamba blocks;
    so does the port — the same loss and prefill, the last block's
    parameters get no gradient, and its cache slot stays zero."""
    extra = {"n_layers": 5}
    rmodel, rparams, tmodel, tparams = pair_of("three_segments", "float32",
                                               **extra)
    batch = batch_of(9)
    vg = jax.value_and_grad(rmodel.loss, has_aux=True)
    with jax.disable_jit():
        (want, _), grads = vg(rparams, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    loss, _, tgrads = port_loss_and_grads(tmodel, tparams, batch)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for name, g in tgrads.items():
        leaf_close(g, ref_leaf(grads, name), 1e-4, f"d{name}")
        if name.startswith("language_model.blocks.4."):
            assert not g.any(), name
    want, wcache, got, gcache = _prefill_both("three_segments", tokens(SEQ, 2),
                                              **extra)
    close(got, want, "prefill logits")
    _cache_close(gcache, wcache, "prefill", n_run=4)
    assert gcache["blocks"]["ssm"].shape[0] == 5
    assert not gcache["blocks"]["ssm"][4].any()
    assert not gcache["blocks"]["conv"][4].any()
