"""Port of the encoder-decoder family (``repro_torch.models.encdec``:
seamless-m4t-large-v2) against the reference package, on the CPU, at the
reduced config.

The reference's parameters (PRNGKey(0)) are carried across with
``Model.from_numpy``; inputs are made with numpy from a seed and handed to
both sides.  The reference runs eagerly (``jax.disable_jit``): that is its
program op for op (ROADMAP C6).  Tolerances:

* modules and serving in bf16: ``|port - ref| <= 2e-2 * max(1,
  max|ref|)``, the dense models' serving tolerance
  (tests/test_torch_serve.py);
* the loss and its gradients in fp32: the loss within 1e-5 relative,
  each gradient leaf within 1e-4 of its scale (the frames' bf16 frontend
  weight, rounded once to bf16 on each side, within one bf16 ulp);
* in bf16: the loss within 2e-2, each gradient leaf within the larger of
  2e-2 of its scale and 1.5x that leaf's own jitted-vs-eager spread in
  the reference, a spread held under ``SPREAD_CAP``
  (tests/test_torch_train.py's rule).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as RShape
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.models import encdec as RE
from repro.models import param as RPM
from repro.serve import generate as ref_generate
from repro.serve import pad_cache as ref_pad_cache
from repro_torch.configs import get_config
from repro_torch.core.spec import FULL_TRAIN
from repro_torch.models import build_model
from repro_torch.models import encdec as TE
from repro_torch.models import param as TPM
from repro_torch.serve import serve_step as TS

ARCH = "seamless-m4t-large-v2"
TOL = 2e-2
SPREAD_CAP = 5e-2
B, SEQ, N_DECODE = 2, 12, 4


def to_torch(a) -> torch.Tensor:
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, what: str, tol: float = TOL) -> None:
    want = f32(want)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(f32(got), want, rtol=0, atol=atol,
                               err_msg=what)


def ref_leaf(tree, name: str) -> np.ndarray:
    node, idx = tree, None
    for part in name.split("."):
        if part.isdigit():
            idx = int(part)
        else:
            node = node[part]
    a = np.asarray(node, np.float32)
    return a if idx is None else a[idx]


def leaf_close(got: torch.Tensor, want: np.ndarray, tol: float, what: str):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(f32(got), want, rtol=0, atol=tol * scale,
                               err_msg=what)


@pytest.fixture(scope="module")
def pair():
    """dtype -> (ref cfg, ref model, ref params, port model, port params)
    of the reduced config in that type."""
    cache = {}

    def get(dtype="bfloat16"):
        if dtype not in cache:
            rcfg = dataclasses.replace(ref_config(ARCH).reduced(),
                                       dtype=dtype)
            rmodel = ref_build(rcfg)
            rparams = rmodel.init(jax.random.PRNGKey(0))
            tmodel = build_model(dataclasses.replace(
                get_config(ARCH).reduced(), dtype=dtype))
            tparams = tmodel.from_numpy(jax.tree.map(np.asarray, rparams),
                                        "cpu")
            cache[dtype] = (rcfg, rmodel, rparams, tmodel, tparams)
        return cache[dtype]
    return get


def make_batch(rmodel, kind: str = "train", seed: int = 1) -> dict:
    """A batch of the reference model's batch_spec as numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, sd in rmodel.batch_spec(RShape("t", SEQ, B, kind)).items():
        if np.issubdtype(sd.dtype, np.integer):
            out[name] = rng.integers(0, rmodel.cfg.vocab, sd.shape) \
                .astype(np.int32)
        else:
            out[name] = (rng.standard_normal(sd.shape, np.float32) * 0.5) \
                .astype(sd.dtype)
    return out


def port_loss_and_grads(tmodel, tparams, batch, remat=None):
    TPM.set_trainable(tparams, FULL_TRAIN)
    named = TPM.trainable_params(tparams)
    loss, metrics = tmodel.loss(tparams, {k: to_torch(v)
                                          for k, v in batch.items()},
                                remat=remat)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss, metrics, dict(zip([n for n, _ in named], grads))


# ---------------------------------------------------------------------------
# parameters and modules
# ---------------------------------------------------------------------------


def _port_leaf(params, keys) -> torch.Tensor:
    node = params
    for i, key in enumerate(keys):
        if isinstance(node, torch.nn.ModuleList):    # a stacked module
            return torch.stack([_port_leaf(m, keys[i:]) for m in node])
        node = node[key]
    return node.detach()


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_numpy_is_bit_exact(pair, dtype):
    rcfg, rmodel, rparams, tmodel, tparams = pair(dtype)
    leaves = jax.tree_util.tree_flatten_with_path(rparams)[0]
    for path, leaf in leaves:
        keys = [p.key for p in path]
        got = _port_leaf(tparams, keys)
        want = np.asarray(leaf)
        assert tuple(got.shape) == want.shape, keys
        assert str(got.dtype).split(".")[-1] == want.dtype.name, keys
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16).numpy().view(jnp.bfloat16)
        else:
            got = got.numpy()
        assert np.array_equal(_bits(got), _bits(want)), keys
    assert TPM.count_params(tparams) == RPM.count_params(rparams)
    assert len(tparams.encdec.speech_encoder.encoder_blocks) \
        == rcfg.encdec.n_enc_layers
    assert len(tparams.encdec.text_decoder.decoder_blocks) == rcfg.n_layers


def test_encode_matches_the_eager_reference(pair):
    rcfg, rmodel, rparams, tmodel, tparams = pair()
    frames = make_batch(rmodel, "prefill", seed=2)["frames"]
    with jax.disable_jit():
        want = RE.encode(rcfg, rparams["encdec"], jnp.asarray(frames))
    with torch.inference_mode():
        got = TE.encode(tmodel.cfg, tparams.encdec, to_torch(frames))
    assert tuple(got.shape) == want.shape and got.dtype == torch.bfloat16
    close(got, want, "encode")


def test_decoder_block_matches_the_eager_reference(pair):
    """One decoder block: causal self-attention over the decoder length,
    cross-attention with Sq (decoder) != Skv (encoder)."""
    rcfg, rmodel, rparams, tmodel, tparams = pair()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 7, rcfg.d_model), np.float32) \
        .astype(jnp.bfloat16)
    memory = rng.standard_normal((B, 11, rcfg.d_model), np.float32) \
        .astype(jnp.bfloat16)
    bp = jax.tree.map(lambda a: a[0],
                      rparams["encdec"]["text_decoder"]["decoder_blocks"])
    with jax.disable_jit():
        want = RE._decoder_block(rcfg, bp, jnp.asarray(x),
                                 jnp.asarray(memory), None)
    with torch.inference_mode():
        got = TE._decoder_block(
            tmodel.cfg, tparams.encdec.text_decoder.decoder_blocks[0],
            to_torch(x), to_torch(memory))
    assert tuple(got.shape) == want.shape
    close(got, want, "_decoder_block")
    with jax.disable_jit():
        wk, wv = RE._cross_kv(rcfg, bp["cross_attn"], jnp.asarray(memory))
    gk, gv = TE._cross_kv(tmodel.cfg,
                          tparams.encdec.text_decoder.decoder_blocks[0]
                          .cross_attn, to_torch(memory))
    assert tuple(gk.shape) == wk.shape == (B, 11, rcfg.n_kv_heads,
                                           rcfg.resolved_head_dim)
    close(gk, wk, "_cross_kv k")
    close(gv, wv, "_cross_kv v")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_loss_and_grads_match_the_eager_reference_fp32(pair):
    rcfg, rmodel, rparams, tmodel, tparams = pair("float32")
    batch = make_batch(rmodel)
    vg = jax.value_and_grad(rmodel.loss, has_aux=True)
    with jax.disable_jit():
        (want, metrics), grads = vg(rparams, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
    loss, tmetrics, tgrads = port_loss_and_grads(tmodel, tparams, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics["xent"]),
                               float(metrics["xent"]), rtol=1e-5)
    assert float(tmetrics["n_tok"]) == float(metrics["n_tok"])
    # every parameter of the model trains under FULL_TRAIN
    assert len(tgrads) == len(list(tparams.parameters()))
    for name, g in tgrads.items():
        p = dict(tparams.named_parameters())[name]
        assert g.dtype == p.dtype and g.shape == p.shape, name
        tol = 2 ** -8 if p.dtype == torch.bfloat16 else 1e-4
        leaf_close(g, ref_leaf(grads, name), tol, f"d{name}")


def test_loss_and_grads_match_the_eager_reference_bf16(pair):
    rcfg, rmodel, rparams, tmodel, tparams = pair()
    batch = make_batch(rmodel, seed=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vg = jax.value_and_grad(rmodel.loss, has_aux=True)
    with jax.disable_jit():
        (want, _), grads = vg(rparams, jb)
    (_, _), jit_grads = jax.jit(vg)(rparams, jb)
    loss, _, tgrads = port_loss_and_grads(tmodel, tparams, batch)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=2e-2)

    def rel(a, name):
        w = ref_leaf(grads, name)
        return float(np.abs(a - w).max()) / max(float(np.abs(w).max()),
                                                1e-30)
    for name, g in tgrads.items():
        spread = rel(ref_leaf(jit_grads, name), name)
        assert spread <= SPREAD_CAP, (name, spread)
        leaf_close(g, ref_leaf(grads, name), max(2e-2, 1.5 * spread),
                   f"d{name} (reference jit-vs-eager spread {spread:.3g})")


def test_remat_policies_give_the_same_loss_and_grads(pair):
    """none / block / dots recompute the same ops on the CPU, the encoder's
    and the decoder's blocks alike: the loss and every gradient bit-equal
    across policies."""
    rcfg, rmodel, rparams, tmodel, tparams = pair("float32")
    batch = make_batch(rmodel, seed=2)
    runs = {r: port_loss_and_grads(tmodel, tparams, batch, remat=r)
            for r in ("none", "block", "dots")}
    loss0, _, grads0 = runs["none"]
    for remat in ("block", "dots"):
        loss, _, grads = runs[remat]
        assert torch.equal(loss, loss0), remat
        for name in grads0:
            assert torch.equal(grads[name], grads0[name]), (remat, name)


def test_remat_block_reruns_encoder_and_decoder_blocks(pair, monkeypatch):
    """Under "block" each encoder and decoder block runs twice per step
    (the recompute in the backward), under "none" once."""
    rcfg, rmodel, rparams, tmodel, tparams = pair("float32")
    batch = make_batch(rmodel, seed=3)
    calls = []
    enc, dec = TE._encoder_block, TE._decoder_block
    monkeypatch.setattr(TE, "_encoder_block",
                        lambda *a, **k: calls.append("enc") or enc(*a, **k))
    monkeypatch.setattr(TE, "_decoder_block",
                        lambda *a, **k: calls.append("dec") or dec(*a, **k))
    for remat, want in (("none", 1), ("block", 2)):
        calls.clear()
        port_loss_and_grads(tmodel, tparams, batch, remat=remat)
        assert calls.count("enc") == want * rcfg.encdec.n_enc_layers, remat
        assert calls.count("dec") == want * rcfg.n_layers, remat


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prefill_then_teacher_forced_decode(pair, dtype):
    """Prefill, the cache's four leaves, then teacher-forced decode steps
    against the eager reference.  The reference's cache is bf16 whatever
    the model's type: the fp32 case holds the port to that too."""
    rcfg, rmodel, rparams, tmodel, tparams = pair(dtype)
    batch = make_batch(rmodel, "prefill", seed=5)
    with jax.disable_jit():
        want, wcache = rmodel.prefill(
            rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        got, gcache = tmodel.prefill(
            tparams, {k: to_torch(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    close(got, want, "prefill logits")
    for key in ("k", "v", "cross_k", "cross_v"):
        assert gcache["blocks"][key].dtype == torch.bfloat16, key
        assert wcache["blocks"][key].dtype == jnp.bfloat16, key
        assert tuple(gcache["blocks"][key].shape) == \
            wcache["blocks"][key].shape, key
        close(gcache["blocks"][key], wcache["blocks"][key],
              f"prefill cache {key}")
    assert np.array_equal(gcache["len"].numpy(), np.asarray(wcache["len"]))

    wcache = ref_pad_cache(wcache, N_DECODE)
    gcache = TS.pad_cache(gcache, N_DECODE)
    rng = np.random.default_rng(6)
    for step in range(N_DECODE):
        tok = rng.integers(0, rcfg.vocab, (B, 1)).astype(np.int32)
        with jax.disable_jit():
            want, wcache = rmodel.decode_step(rparams, jnp.asarray(tok),
                                              wcache)
        with torch.inference_mode():
            got, gcache = tmodel.decode_step(tparams, to_torch(tok), gcache)
        close(got, want, f"decode step {step} logits")
    for key in ("k", "v", "cross_k", "cross_v"):
        assert tuple(gcache["blocks"][key].shape) == \
            wcache["blocks"][key].shape, key
        close(gcache["blocks"][key], wcache["blocks"][key],
              f"cache {key} after decode")
    assert np.array_equal(gcache["len"].numpy(), np.asarray(wcache["len"]))


@pytest.mark.parametrize("enc_len", [None, 5])
def test_init_cache_is_bf16_with_the_references_shapes(pair, enc_len):
    rcfg, rmodel, rparams, tmodel, tparams = pair("float32")
    got = tmodel.init_cache(B, 9, "cpu", enc_len=enc_len)
    want = rmodel.init_cache(B, 9, enc_len)
    L, H, D = rcfg.n_layers, rcfg.n_kv_heads, rcfg.resolved_head_dim
    for key, n in (("k", 9), ("v", 9), ("cross_k", enc_len or 9),
                   ("cross_v", enc_len or 9)):
        t = got["blocks"][key]
        assert t.dtype == torch.bfloat16 and not t.any(), key
        assert tuple(t.shape) == (L, B, n, H, D) == \
            want["blocks"][key].shape, key
    assert got["len"].dtype == torch.int32 and not got["len"].any()


def test_pad_cache_grows_self_kv_and_leaves_cross_kv(pair):
    rcfg, rmodel, rparams, tmodel, tparams = pair()
    cache = tmodel.init_cache(B, 6, "cpu", enc_len=4)
    for t in cache["blocks"].values():
        t.fill_(1.0)
    grown = TS.pad_cache(cache, 3)
    want = ref_pad_cache(rmodel.init_cache(B, 6, 4), 3)
    for key in ("k", "v", "cross_k", "cross_v"):
        assert tuple(grown["blocks"][key].shape) == \
            want["blocks"][key].shape, key
    assert tuple(grown["blocks"]["k"].shape)[2] == 9
    assert torch.equal(grown["blocks"]["k"][:, :, :6], cache["blocks"]["k"])
    assert not grown["blocks"]["k"][:, :, 6:].any()
    for key in ("cross_k", "cross_v"):
        assert grown["blocks"][key] is cache["blocks"][key], key
    assert grown["len"] is cache["len"]


def test_generate_on_the_cpu_matches_where_the_margin_is_clear(pair):
    """Greedy tokens equal the reference's at every step whose top-2 logit
    margin exceeds twice the tolerance; past the first step that does not,
    nothing more is compared."""
    rcfg, rmodel, rparams, tmodel, tparams = pair()
    batch = make_batch(rmodel, "prefill", seed=8)
    n_new = 5
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.disable_jit():
        want = np.asarray(ref_generate(rmodel, rparams, jb, n_new))
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
    assert compared >= B          # at least the first token of each row
