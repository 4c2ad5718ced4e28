"""Port of multi-head latent attention (``repro_torch.models.attention``:
``_mla_qkv``, ``_mla_expand_kv``, ``mla_forward``, ``mla_decode``) and of
the runnable MLA family (deepseek-v2-lite-16b: MLA + MoE + a leading dense
block; minicpm3-4b: dense MLA with a q rank and tied embeddings) against
the reference package, on the CPU, at reduced size.

Inputs and weights are made with numpy from a seed and handed to both
sides; a reduced model's parameters are the reference's (PRNGKey(0)),
carried across with ``Model.from_numpy``.  Tolerances:

* the MLA functions in fp32: within 1e-5 of the compared tensor's scale
  (its largest magnitude) — the same fp32 formulas, products summed in
  another order; in bf16 within 2e-2 of it (each side rounds every
  product's output once to bf16, at the same points);
* the reduced models in fp32 (the jitted reference, as
  tests/test_torch_train.py): the loss within 1e-5 relative, each
  gradient leaf within 1e-4 of its scale;
* prefill and teacher-forced decode in bf16 against the eager reference
  (``jax.disable_jit``, C6's rule), the serving tests' tolerance: logits
  and cache leaves within 2e-2 of their scale (max(1, max |ref|) for
  logits); the cache's leaves, shapes and types equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import attention as RA
from repro.models import build_model as ref_build
from repro.serve import pad_cache as ref_pad
from repro_torch.configs import MLAConfig, get_config
from repro_torch.kernels import ops as TOPS
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.models import param as TPM
from repro_torch.models import transformer as TT
from repro_torch.serve import generate, pad_cache
from tests.test_torch_train import (leaf_close, make_batch,
                                    port_loss_and_grads, ref_leaf, to_torch)

ARCHS = ["deepseek-v2-lite-16b", "minicpm3-4b"]
D_MODEL, H = 32, 4
# the reduced configs' MLA: qk_nope 16 + qk_rope 8 -> v 16, kv rank 32
MLA = MLAConfig(q_lora_rank=0, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16)
DTYPES = {"float32": (np.float32, 1e-5), "bfloat16": (jnp.bfloat16, 2e-2)}


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol: float, what: str) -> None:
    want = f32(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(f32(got), want, rtol=0, atol=tol * scale,
                               err_msg=what)


def mla_of(q_lora: int) -> MLAConfig:
    return dataclasses.replace(MLA, q_lora_rank=q_lora)


def layer(mla: MLAConfig, np_dtype, seed: int = 0) -> dict:
    """One MLA layer's weights as numpy in ``np_dtype`` (the norm scales
    near 1), the reference's leaf names and shapes."""
    rng = np.random.default_rng(seed)
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np_dtype)
    scale = lambda n: (1 + 0.1 * rng.standard_normal(n)).astype(np_dtype)
    qk = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    p = {}
    if mla.q_lora_rank:
        p.update(wq_a=w(D_MODEL, mla.q_lora_rank),
                 q_norm=scale(mla.q_lora_rank),
                 wq_b=w(mla.q_lora_rank, H * qk))
    else:
        p["wq"] = w(D_MODEL, H * qk)
    p.update(wkv_a=w(D_MODEL, mla.kv_lora_rank + mla.qk_rope_head_dim),
             kv_norm=scale(mla.kv_lora_rank),
             wkv_b=w(mla.kv_lora_rank,
                     H * (mla.qk_nope_head_dim + mla.v_head_dim)),
             wo=w(H * mla.v_head_dim, D_MODEL))
    return p


def port_layer(p: dict) -> TPM.LayerParams:
    return TPM.LayerParams({k: to_torch(v) for k, v in p.items()})


def ref_layer(p: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in p.items()}


def x_of(shape, np_dtype, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape, np.float32).astype(np_dtype)


CASES = [(q_lora, dt) for q_lora in (0, 24) for dt in DTYPES]
IDS = [f"q_lora{q}-{dt}" for q, dt in CASES]


@pytest.mark.parametrize("q_lora,dtype", CASES, ids=IDS)
def test_mla_qkv_matches_the_reference(q_lora, dtype):
    np_dtype, tol = DTYPES[dtype]
    mla = mla_of(q_lora)
    p = layer(mla, np_dtype)
    x = x_of((2, 9, D_MODEL), np_dtype)
    want = RA._mla_qkv(ref_layer(p), jnp.asarray(x), mla, H, 1e-5)
    got = TA._mla_qkv(port_layer(p), to_torch(x), mla, H, 1e-5)
    for what, g, w in zip(("q", "latent", "k_rope"), got, want):
        assert tuple(g.shape) == w.shape and g.dtype == to_torch(x).dtype
        close(g, w, tol, what)


@pytest.mark.parametrize("q_lora,dtype", CASES, ids=IDS)
def test_mla_expand_kv_matches_the_reference(q_lora, dtype):
    """k (the rope key roped with theta 10,000 and broadcast over the
    heads, a real tensor) and v, at shifted positions; and a bf16 latent
    and rope key (the cache's) against fp32 weights, which both sides
    promote to fp32."""
    np_dtype, tol = DTYPES[dtype]
    mla = mla_of(q_lora)
    p = layer(mla, np_dtype)
    latent = x_of((2, 11, mla.kv_lora_rank), np_dtype, seed=2)
    k_rope = x_of((2, 11, mla.qk_rope_head_dim), np_dtype, seed=3)
    pos = np.broadcast_to(np.arange(11) + 5, (2, 11)).astype(np.int32)
    for lat, kr in ((latent, k_rope),
                    (latent.astype(jnp.bfloat16), k_rope.astype(jnp.bfloat16))):
        wk, wv = RA._mla_expand_kv(ref_layer(p), jnp.asarray(lat),
                                   jnp.asarray(kr), jnp.asarray(pos), mla, H)
        gk, gv = TA._mla_expand_kv(port_layer(p), to_torch(lat),
                                   to_torch(kr), torch.from_numpy(pos), mla, H)
        assert gk.is_contiguous()
        for what, g, w in (("k", gk, wk), ("v", gv, wv)):
            assert tuple(g.shape) == w.shape
            assert f32(g).dtype == np.float32 and str(g.dtype).endswith(
                str(w.dtype))
            close(g, w, tol, what)


@pytest.mark.parametrize("q_lora,dtype", CASES, ids=IDS)
def test_mla_forward_matches_the_reference(q_lora, dtype):
    """Causal MLA through the flash op (its plain version on the CPU) at
    the reduced pair (24, 16): the softmax scale is 24 ** -0.5."""
    np_dtype, tol = DTYPES[dtype]
    mla = mla_of(q_lora)
    p = layer(mla, np_dtype)
    x = x_of((2, 13, D_MODEL), np_dtype)
    want = RA.mla_forward(ref_layer(p), jnp.asarray(x), n_heads=H, mla=mla)
    got = TA.mla_forward(port_layer(p), to_torch(x), n_heads=H, mla=mla)
    assert tuple(got.shape) == want.shape
    close(got, want, tol, "mla_forward")


@pytest.mark.parametrize("q_lora,dtype", CASES, ids=IDS)
def test_mla_decode_matches_the_reference(q_lora, dtype):
    """One token against a bf16 latent cache holding 6 of 10 positions:
    the output, and the new latent and rope key written at position 6 (in
    place in the port), the rest of the cache unchanged."""
    np_dtype, tol = DTYPES[dtype]
    mla = mla_of(q_lora)
    p = layer(mla, np_dtype)
    x = x_of((2, 1, D_MODEL), np_dtype)
    lat = x_of((2, 10, mla.kv_lora_rank), jnp.bfloat16, seed=4)
    kr = x_of((2, 10, mla.qk_rope_head_dim), jnp.bfloat16, seed=5)
    lat[:, 6:] = 0
    kr[:, 6:] = 0
    length = np.full((2,), 6, np.int32)
    want, wcache = RA.mla_decode(
        ref_layer(p), jnp.asarray(x),
        {"latent": jnp.asarray(lat), "k_rope": jnp.asarray(kr),
         "len": jnp.asarray(length)}, n_heads=H, mla=mla)
    cache = {"latent": to_torch(lat), "k_rope": to_torch(kr),
             "len": torch.from_numpy(length)}
    got, gcache = TA.mla_decode(port_layer(p), to_torch(x), cache,
                                n_heads=H, mla=mla)
    close(got, want, tol, "mla_decode out")
    assert gcache["latent"] is cache["latent"]          # written in place
    assert gcache["len"].tolist() == [7, 7]
    for key in ("latent", "k_rope"):
        assert gcache[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(f32(gcache[key])[:, :6],
                                      f32(wcache[key])[:, :6])
        close(gcache[key], wcache[key], tol, key)


def test_the_kernels_are_built_for_the_mla_pairs_not_the_reduced_one():
    """The MLA archs' pairs are kernel instances, each its own; the
    reduced MLA pair (24, 16) is no instance but reaches one through
    ``instance_for``: on the card it runs zero-padded on (32, 32) with
    the scale of its true D (``chip_smoke.py`` phase 2 and the reduced
    MLA archs' card-vs-CPU runs), on the CPU the plain version takes it
    (the tests above) and nothing is launched."""
    from repro_torch.kernels import flash_attention as TFA
    assert (24, 16) not in TFA.HEAD_DIMS
    assert TFA.instance_for(24, 16) == (32, 32)
    for pair in ((192, 128), (96, 64), (80, 80)):
        assert pair in TFA.HEAD_DIMS and TFA.instance_for(*pair) == pair
    q = torch.zeros(1, 4, 2, 24)
    v = torch.zeros(1, 4, 2, 16)
    qp, kp, vp, scale = TFA.pad_operands(q, q, v)
    assert (qp.shape[3], vp.shape[3]) == (32, 32) and scale == 24 ** -0.5
    before = TFA.launches
    out, lse = TFA.flash_fwd(q, q, v)
    assert tuple(out.shape) == (1, 4, 2, 16) and TFA.launches == before


# ---------------------------------------------------------------------------
# the reduced MLA archs end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pairs():
    """(arch, dtype) -> (ref model, ref params, port model, port params)."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            rcfg = dataclasses.replace(ref_config(arch).reduced(),
                                       dtype=dtype)
            rmodel = ref_build(rcfg)
            rparams = rmodel.init(jax.random.PRNGKey(0))
            tmodel = build_model(dataclasses.replace(
                get_config(arch).reduced(), dtype=dtype))
            tparams = tmodel.from_numpy(jax.tree.map(np.asarray, rparams),
                                        "cpu")
            cache[(arch, dtype)] = (rmodel, rparams, tmodel, tparams)
        return cache[(arch, dtype)]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_leaves_come_across_bit_for_bit(arch, pairs):
    rmodel, rparams, tmodel, tparams = pairs(arch, "bfloat16")
    attn = tparams.language_model.blocks[0].attn
    want = {"wq_a", "q_norm", "wq_b"} if tmodel.cfg.mla.q_lora_rank \
        else {"wq"}
    assert set(dict(attn.named_parameters())) == want | {
        "wkv_a", "kv_norm", "wkv_b", "wo"}
    for name, t in tparams.named_parameters():
        if ".attn." in name:
            got = t.view(torch.int16).numpy()
            ref = _ref_raw(rparams, name)
            np.testing.assert_array_equal(got, ref.view(np.int16), name)


def _ref_raw(tree, name: str) -> np.ndarray:
    """The reference's leaf of a port parameter name, in its own type."""
    node, idx = tree, None
    for part in name.split("."):
        if part.isdigit():
            idx = int(part)
        else:
            node = node[part]
    a = np.asarray(node)
    return a if idx is None else a[idx]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference_fp32(arch, pairs):
    """fp32, no mesh (the MoE's dense path in both): the loss and every
    gradient leaf against the jitted reference."""
    rmodel, rparams, tmodel, tparams = pairs(arch, "float32")
    batch = make_batch(rmodel)
    (want, _), grads = jax.jit(jax.value_and_grad(
        lambda p: rmodel.loss(p, {k: jnp.asarray(v)
                                  for k, v in batch.items()}),
        has_aux=True))(rparams)
    loss, _, tgrads = port_loss_and_grads(tmodel, tparams, batch)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert any(".attn.wkv_b" in n for n in tgrads)
    for name, g in tgrads.items():
        leaf_close(g, ref_leaf(grads, name), 1e-4, f"d{name}")


@pytest.mark.parametrize("remat", ["block", "dots"])
def test_remat_policies_keep_the_mla_gradients(remat, pairs):
    _, _, tmodel, tparams = pairs("minicpm3-4b", "float32")
    batch = make_batch(ref_build(dataclasses.replace(
        ref_config("minicpm3-4b").reduced(), dtype="float32")), seed=3)
    _, _, want = port_loss_and_grads(tmodel, tparams, batch, remat="none")
    _, _, got = port_loss_and_grads(tmodel, tparams, batch, remat=remat)
    for name, g in got.items():
        leaf_close(g, f32(want[name]), 1e-5, f"{remat} d{name}")


def logits_close(got, want, what: str) -> None:
    want = f32(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(f32(got), want, rtol=0, atol=2e-2 * scale,
                               err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode_match_the_reference(arch, pairs):
    """bf16, the eager reference: the prefill's logits, the cache's leaves
    (latent and raw rope key per stack, the dense block's stack included),
    their shapes and types; then decode steps fed the same tokens."""
    rmodel, rparams, tmodel, tparams = pairs(arch, "bfloat16")
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 256, (2, 14)).astype(np.int32)
    feed = rng.integers(0, 256, (2, 4)).astype(np.int32)
    with jax.disable_jit():
        want, wcache = rmodel.prefill(rparams,
                                      {"tokens": jnp.asarray(prompt)})
    with torch.inference_mode():
        got, cache = tmodel.prefill(tparams, {"tokens": torch.tensor(prompt)})
    logits_close(got, want, "prefill")
    stacks = [k for k in wcache if k != "len"]
    assert set(cache) == set(wcache)
    for key in stacks:
        assert set(cache[key]) == set(wcache[key]) == {"latent", "k_rope"}
        for leaf in ("latent", "k_rope"):
            g, w = cache[key][leaf], wcache[key][leaf]
            assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16 \
                and w.dtype == jnp.bfloat16, (key, leaf)
            close(g, w, 2e-2, f"{key}.{leaf}")
    wcache, cache = ref_pad(wcache, 4), pad_cache(cache, 4)
    for t in range(4):
        tok = feed[:, t:t + 1]
        with jax.disable_jit():
            want, wcache = rmodel.decode_step(rparams, jnp.asarray(tok),
                                              wcache)
        with torch.inference_mode():
            got, cache = tmodel.decode_step(tparams, torch.tensor(tok), cache)
        logits_close(got, want, f"decode {t}")
    assert cache["len"].tolist() == [18, 18]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_is_the_references(arch, pairs):
    rmodel, _, tmodel, _ = pairs(arch, "bfloat16")
    from repro.models.transformer import init_kv_cache as ref_init
    want = ref_init(rmodel.cfg, 3, 9)
    got = tmodel.init_cache(3, 9, "cpu")
    assert set(got) == set(want)
    for key in (k for k in want if k != "len"):
        for leaf, w in want[key].items():
            g = got[key][leaf]
            assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
            assert not bool(g.any())
    assert got["len"].dtype == torch.int32 and tuple(got["len"].shape) == (3,)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_program_norms(arch, pairs, monkeypatch):
    """The prefill's RMSNorm calls: each block's norm1 twice (its
    ``_prefill_kv`` and the block), norm2, kv_norm twice (``_prefill_kv``
    and the attention) and, with a q rank, q_norm once (``_prefill_kv``
    makes no q); the final norm; a decode step's: norm1, norm2, kv_norm,
    q_norm, and the final norm."""
    _, _, tmodel, tparams = pairs(arch, "bfloat16")
    cfg = tmodel.cfg
    calls = []
    real = TOPS.rmsnorm

    def counting(x, scale, eps=1e-5):
        calls.append(scale)
        return real(x, scale, eps)
    monkeypatch.setattr(TOPS, "rmsnorm", counting)
    toks = torch.zeros((2, 6), dtype=torch.int32)
    with torch.inference_mode():
        _, cache = tmodel.prefill(tparams, {"tokens": toks})
        per_block = 5 + (1 if cfg.mla.q_lora_rank else 0)
        assert len(calls) == per_block * cfg.n_layers + 1
        kv_norms = [bp.attn.kv_norm for _, stack, _ in
                    TT._stacks(cfg, tparams.language_model) for bp in stack]
        assert sum(any(c is k for k in kv_norms) for c in calls) \
            == 2 * cfg.n_layers
        calls.clear()
        tmodel.decode_step(tparams, toks[:, :1], pad_cache(cache, 1))
        assert len(calls) == (per_block - 2) * cfg.n_layers + 1


def test_generate_runs_on_the_cpu(pairs):
    _, _, tmodel, tparams = pairs("deepseek-v2-lite-16b", "bfloat16")
    toks = np.random.default_rng(2).integers(0, 256, (2, 7)).astype(np.int32)
    out = generate(tmodel, tparams, {"tokens": toks}, 3, device="cpu")
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 3)


def test_deepseek_under_the_mesh_matches_the_reference(pairs):
    """bf16 under the 1 x 1 mesh (the MoE's expert-parallel dispatch, the
    path the card serves deepseek-v2-lite-16b by): the prefill and two
    teacher-forced decode steps against the eager reference under its
    1 x 1 mesh."""
    from repro.launch.mesh import make_smoke_mesh
    from repro.mesh_ctx import mesh_context as ref_mesh_context
    from repro_torch.mesh_ctx import mesh_context
    rmodel, rparams, tmodel, tparams = pairs("deepseek-v2-lite-16b",
                                             "bfloat16")
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, 256, (2, 10)).astype(np.int32)
    feed = rng.integers(0, 256, (2, 2)).astype(np.int32)
    with ref_mesh_context(make_smoke_mesh()), jax.disable_jit():
        want, wcache = rmodel.prefill(rparams,
                                      {"tokens": jnp.asarray(prompt)})
        wcache = ref_pad(wcache, 2)
        steps = []
        for t in range(2):
            w, wcache = rmodel.decode_step(
                rparams, jnp.asarray(feed[:, t:t + 1]), wcache)
            steps.append(w)
    with mesh_context({"data": 1, "model": 1}), torch.inference_mode():
        got, cache = tmodel.prefill(tparams, {"tokens": torch.tensor(prompt)})
        logits_close(got, want, "prefill under the mesh")
        cache = pad_cache(cache, 2)
        for t in range(2):
            got, cache = tmodel.decode_step(
                tparams, torch.tensor(feed[:, t:t + 1]), cache)
            logits_close(got, steps[t], f"decode {t} under the mesh")
