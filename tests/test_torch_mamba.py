"""Port of the pure-SSM serving path (``repro_torch.models.mamba`` /
``ssm_lm``) against the reference package, on the CPU, for mamba2-1.3b's
reduced config (2 layers, d_model 64, d_state 16, head dim 16, chunk 32).

The reference's parameters (``reduced_zoo``: PRNGKey(0)) are carried
across with ``params_from_numpy``; token batches are made with numpy from
a seed and handed to both sides.  The reference runs eagerly
(``jax.disable_jit``), its program op for op; the port's prefill takes the
SSD's plain version where the reference takes its lax twin
``ssd_chunked``.  Tolerance: ``|port - ref| <= 2e-2 * max(1, max|ref|)``
of the compared tensor, as in tests/test_torch_serve.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as RM
from repro.models import param as RPM
from repro.serve import generate as ref_generate
from repro.serve import pad_cache as ref_pad_cache
from repro_torch.configs import get_config
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ssd as SSD
from repro_torch.models import build_model
from repro_torch.models import mamba as TM
from repro_torch.models import param as TPM
from repro_torch.serve import serve_step as TS

ARCH = "mamba2-1.3b"
TOL = 2e-2
B = 2
S_PROMPT = 40                    # one full chunk of 32 and a ragged rest
N_DECODE = 16


def to_torch(a) -> torch.Tensor:
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, what: str) -> None:
    want = f32(want)
    tol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(f32(got), want, rtol=0, atol=tol,
                               err_msg=what)


@pytest.fixture(scope="module")
def pair(reduced_zoo):
    """(ref cfg, ref model, ref params, port model, port params)."""
    cfg, model, params = reduced_zoo(ARCH)
    tmodel = build_model(get_config(ARCH).reduced())
    tparams = tmodel.from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, model, params, tmodel, tparams


def tokens(cfg, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)


@pytest.fixture(scope="module")
def prefilled(pair):
    """Both sides' prefill of one prompt: (ref logits, ref cache, port
    logits, port cache)."""
    cfg, model, params, tmodel, tparams = pair
    toks = tokens(cfg, S_PROMPT, 1)
    with jax.disable_jit():
        want, wcache = model.prefill(params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, gcache = tmodel.prefill(tparams,
                                     {"tokens": torch.from_numpy(toks)})
    return want, wcache, got, gcache


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def test_params_carry_across_with_fp32_ssm_leaves(pair):
    cfg, model, params, tmodel, tparams = pair
    ref = params["language_model"]["blocks"]["mixer"]
    for i, bp in enumerate(tparams.language_model.blocks):
        for name in ("A_log", "D", "dt_bias"):
            got = bp.mixer[name]
            assert got.dtype == torch.float32, name
            assert np.array_equal(got.numpy(), np.asarray(ref[name][i]))
        assert bp.mixer.in_proj.dtype == torch.bfloat16
    assert TPM.count_params(tparams) == RPM.count_params(params)
    assert len(tparams.language_model.blocks) == cfg.n_layers


def test_init_follows_the_reference_rules(pair):
    cfg, model, params, tmodel, _ = pair
    p1 = tmodel.init(torch.Generator().manual_seed(0), "cpu")
    p2 = tmodel.init(torch.Generator().manual_seed(0), "cpu")
    for (name, a), (_, b) in zip(p1.named_parameters(),
                                 p2.named_parameters()):
        assert torch.equal(a, b), name                   # seeded
        assert not a.requires_grad
    # the reference's ranges, on both sides: A = -exp(A_log) in [-16, -1),
    # softplus(dt_bias) in [1e-3, 1e-1], D ones
    ref = params["language_model"]["blocks"]["mixer"]
    ref_a = np.asarray(ref["A_log"])
    ref_dt = np.log1p(np.exp(np.asarray(ref["dt_bias"], np.float64)))
    assert ref_a.min() >= 0 and ref_a.max() < np.log(16.0)
    assert ref_dt.min() >= 1e-3 * (1 - 1e-5) and ref_dt.max() <= 0.1001
    a_log = torch.stack([bp.mixer.A_log for bp in
                         p1.language_model.blocks]).double()
    dt = torch.nn.functional.softplus(torch.stack(
        [bp.mixer.dt_bias for bp in p1.language_model.blocks]).double())
    for bp in p1.language_model.blocks:
        assert bp.mixer.A_log.dtype == bp.mixer.dt_bias.dtype \
            == torch.float32
        assert torch.equal(bp.mixer.D, torch.ones_like(bp.mixer.D))
        assert not bp.mixer.conv_b.any()
    assert float(a_log.min()) >= 0 and float(a_log.max()) < np.log(16.0)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1001
    # spread over the range: log-uniform dt puts about half below 1e-2
    wide = tmodel.init(torch.Generator().manual_seed(1), "cpu")
    dts = torch.nn.functional.softplus(torch.cat(
        [bp.mixer.dt_bias for bp in wide.language_model.blocks]))
    assert 0.1 < float((dts < 1e-2).float().mean()) < 0.9


# ---------------------------------------------------------------------------
# the block's pieces
# ---------------------------------------------------------------------------


def test_softplus_and_causal_conv_match_the_reference():
    rng = np.random.default_rng(2)
    v = np.concatenate([rng.standard_normal(1000).astype(np.float32) * 8,
                        np.array([-100, -30, -20.5, 0, 20.5, 30, 100],
                                 np.float32)])
    got = TM.softplus(torch.from_numpy(v)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(v)))
    # XLA flushes denormals to zero (softplus(-100) = 3.7e-44)
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-37)
    x = rng.standard_normal((2, 11, 24), np.float32).astype(jnp.bfloat16)
    w = rng.standard_normal((4, 24), np.float32).astype(jnp.bfloat16)
    b = rng.standard_normal(24, np.float32).astype(jnp.bfloat16)
    with jax.disable_jit():
        want = RM._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b))
    got = TM.causal_conv(to_torch(x), to_torch(w), to_torch(b))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(f32(got), f32(want))


def test_prefill_calls_the_kernels_once_per_norm_and_layer(pair,
                                                           monkeypatch):
    """The reference's program: one SSD per layer, and RMSNorm twice per
    layer (block norm, gated norm) plus the final norm, in prefill and in
    each decode step; the SSD gets the views the CUDA kernel takes."""
    cfg, model, params, tmodel, tparams = pair
    calls = {"ssd": 0, "rmsnorm": 0}
    ssd, rmsnorm = SSD.ssd_scan, TO._rn.rmsnorm_fwd

    def count_ssd(x, dt, A, Bm, Cm, chunk):
        calls["ssd"] += 1
        SSD.check_kernel_operands(x, dt, A, Bm, Cm, min(chunk, x.shape[1]))
        assert not x.is_contiguous()          # read in place, not copied
        return ssd(x, dt, A, Bm, Cm, chunk)

    def count_rmsnorm(x, scale, eps=1e-5):
        calls["rmsnorm"] += 1
        return rmsnorm(x, scale, eps)
    monkeypatch.setattr(SSD, "ssd_scan", count_ssd)
    monkeypatch.setattr(TO._rn, "rmsnorm_fwd", count_rmsnorm)
    toks = torch.from_numpy(tokens(cfg, 12, 3))
    with torch.inference_mode():
        _, cache = tmodel.prefill(tparams, {"tokens": toks})
    assert calls == {"ssd": cfg.n_layers, "rmsnorm": 2 * cfg.n_layers + 1}
    with torch.inference_mode():
        tmodel.decode_step(tparams, toks[:, :1], cache)
    assert calls == {"ssd": cfg.n_layers, "rmsnorm": 4 * cfg.n_layers + 2}


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def test_prefill_logits_and_cache_match_the_reference(pair, prefilled):
    cfg = pair[0]
    want, wcache, got, gcache = prefilled
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape \
        == (B, 1, cfg.vocab)
    close(got, want, "prefill logits")
    blocks = gcache["blocks"]
    assert set(blocks) == set(wcache["blocks"]) == {"ssm", "conv"}
    assert blocks["ssm"].dtype == torch.float32
    assert blocks["conv"].dtype == torch.bfloat16
    for key in ("ssm", "conv"):
        assert tuple(blocks[key].shape) == wcache["blocks"][key].shape
        close(blocks[key], wcache["blocks"][key], f"prefill cache {key}")
    assert gcache["len"].dtype == torch.int32
    assert np.array_equal(gcache["len"].numpy(), np.asarray(wcache["len"]))


def test_teacher_forced_decode_matches_the_reference(pair, prefilled):
    cfg, model, params, tmodel, tparams = pair
    _, wcache, _, gcache = prefilled
    wcache = ref_pad_cache(wcache, N_DECODE)
    gcache = TS.pad_cache(gcache, N_DECODE)
    ssm_ptr = gcache["blocks"]["ssm"].data_ptr()
    toks = tokens(cfg, N_DECODE, 4)
    for step in range(N_DECODE):
        tok = toks[:, step:step + 1]
        with jax.disable_jit():
            want, wcache = model.decode_step(params, jnp.asarray(tok),
                                             wcache)
        with torch.inference_mode():
            got, gcache = tmodel.decode_step(tparams, torch.from_numpy(tok),
                                             gcache)
        close(got, want, f"decode step {step} logits")
    for key in ("ssm", "conv"):
        close(gcache["blocks"][key], wcache["blocks"][key],
              f"cache {key} after decode")
    assert gcache["blocks"]["ssm"].data_ptr() == ssm_ptr    # in place
    assert np.array_equal(gcache["len"].numpy(), np.asarray(wcache["len"]))


def test_decode_reproduces_prefill(pair):
    """The port's own token-by-token decode from an empty cache gives the
    logits of its own prefill over the same tokens (the check of
    tests/test_models.py::test_decode_matches_forward)."""
    cfg, model, params, tmodel, tparams = pair
    S = 16
    toks = torch.from_numpy(tokens(cfg, S, 5)[:1])
    with torch.inference_mode():
        full, pcache = tmodel.prefill(tparams, {"tokens": toks})
        cache = tmodel.init_cache(1, S, "cpu")
        for t in range(S):
            step, cache = tmodel.decode_step(tparams, toks[:, t:t + 1],
                                             cache)
    np.testing.assert_allclose(f32(full[:, -1]).ravel(),
                               f32(step[:, 0]).ravel(), atol=TOL, rtol=TOL)
    assert int(cache["len"][0]) == S
    # the two caches hold the same state; the first layer's conv window
    # holds the same bf16 projections, the deeper ones those of inputs a
    # rounding apart
    close(cache["blocks"]["ssm"], pcache["blocks"]["ssm"], "ssm state")
    assert torch.equal(cache["blocks"]["conv"][0], pcache["blocks"]["conv"][0])
    close(cache["blocks"]["conv"], pcache["blocks"]["conv"], "conv window")


def test_pad_cache_leaves_the_ssm_cache_unchanged(pair):
    cfg, model, params, tmodel, tparams = pair
    cache = tmodel.init_cache(B, 6, "cpu")
    cache["blocks"]["ssm"].fill_(1.0)
    grown = TS.pad_cache(cache, 5)
    want = ref_pad_cache(model.init_cache(B, 6), 5)
    for key in ("ssm", "conv"):
        assert tuple(grown["blocks"][key].shape) == want["blocks"][key].shape
        assert grown["blocks"][key] is cache["blocks"][key]
    assert grown["len"] is cache["len"]
    assert tuple(cache["blocks"]["ssm"].shape) == (
        cfg.n_layers, B, cfg.ssm.n_heads(cfg.d_model), cfg.ssm.head_dim,
        cfg.ssm.d_state)


def test_short_prompt_keeps_the_conv_window_causal(pair):
    """A prompt shorter than the conv window: the cache's window holds the
    prompt at its end and zeros before it — the same window a decode of
    those tokens from an empty cache leaves."""
    cfg, model, params, tmodel, tparams = pair
    toks = torch.from_numpy(tokens(cfg, 2, 6))
    with torch.inference_mode():
        _, pcache = tmodel.prefill(tparams, {"tokens": toks})
        cache = tmodel.init_cache(B, 2, "cpu")
        for t in range(2):
            _, cache = tmodel.decode_step(tparams, toks[:, t:t + 1], cache)
    conv = pcache["blocks"]["conv"]
    assert not conv[:, :, 0].any()            # before the prompt: zeros
    assert torch.equal(conv[0], cache["blocks"]["conv"][0])
    close(conv, cache["blocks"]["conv"], "conv window")
    close(pcache["blocks"]["ssm"], cache["blocks"]["ssm"], "ssm state")


def test_generate_matches_the_reference_where_the_margin_is_clear(pair):
    """Greedy tokens equal the reference's at every step whose top-2 logit
    margin exceeds twice the tolerance; past the first step that does not,
    the two contexts may differ and nothing more is compared."""
    cfg, model, params, tmodel, tparams = pair
    batch = {"tokens": tokens(cfg, 24, 7)}
    n_new = 6
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(ref_generate(model, params, jb, n_new))
    with jax.disable_jit():
        logits, cache = model.prefill(params, jb)
        cache = ref_pad_cache(cache, n_new)
        steps = [np.asarray(logits[:, -1], np.float32)]
        for i in range(n_new - 1):
            logits, cache = model.decode_step(
                params, jnp.asarray(want[:, i:i + 1]), cache)
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


def test_generate_and_init_run_on_cuda_by_default(pair, monkeypatch):
    cfg, model, params, tmodel, tparams = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = {"tokens": tokens(cfg, 4, 8)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.generate(tmodel, tparams, batch, 2)
    with pytest.raises((RuntimeError, AssertionError)):
        tmodel.init(torch.Generator().manual_seed(0))     # cuda by default
    out = TS.generate(tmodel, tparams, batch, 3, device="cpu")
    assert tuple(out.shape) == (B, 3) and out.device.type == "cpu"


def test_training_is_not_ported(pair):
    """Once the check that training raised; training is ported now (the
    SSM training slice; tests/test_torch_ssm_train.py holds it to the
    reference): ``Model.loss`` of the reduced mamba2 runs on the CPU and
    its gradients reach every leaf."""
    cfg, tmodel, tparams = pair[0], pair[3], pair[4]
    toks = torch.tensor(tokens(cfg, 8, 9))
    for p in tparams.parameters():
        p.requires_grad_(True)
    try:
        loss, metrics = tmodel.loss(tparams, {"tokens": toks,
                                              "labels": toks})
        grads = torch.autograd.grad(loss, list(tparams.parameters()))
    finally:
        for p in tparams.parameters():
            p.requires_grad_(False)
    assert loss.dim() == 0 and bool(torch.isfinite(loss))
    assert float(metrics["n_tok"]) == B * 8
    assert all(bool(torch.isfinite(g).all()) for g in grads)
