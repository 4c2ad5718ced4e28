"""Port of the serving path (repro_torch.models + repro_torch.serve) against
the reference package, on the CPU, for the six supported archs' reduced
configs.

The reference's parameters (``reduced_zoo``: PRNGKey(0)) are carried
across with ``params_from_numpy``; batches are made with numpy from a seed
and handed to both sides.  Both sides compute in the models' working type,
bf16.  The reference runs eagerly (``jax.disable_jit``): that is its
program op for op, and the port follows it op for op (the dense models
agree bit for bit).  XLA's fused rewrites of the jitted program round
elsewhere — the jitted and the eager reference differ by up to 1 % of
the logits' scale — and XLA's tanh approximation flips a few bf16
roundings of the VLMs' GELU, so the tolerance is the reference's
cross-path 2e-2 (tests/test_models.py), taken against the scale of the
compared tensor: ``|port - ref| <= 2e-2 * max(1, max|ref|)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro.models import transformer as RT
from repro.models import param as RPM
from repro.models import vit as RV
from repro.models import vlm as RVLM
from repro.serve import generate as ref_generate
from repro.serve import pad_cache as ref_pad_cache
from repro_torch.configs import get_config
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.models import param as TPM
from repro_torch.models import transformer as TT
from repro_torch.models import vit as TV
from repro_torch.models import vlm as TVLM
from repro_torch.serve import serve_step as TS

ARCHS = ["llava15-7b", "llava-next-mistral-7b", "llama3.1-8b",
         "llama3.2-3b", "smollm-360m", "qwen3-32b"]
TOL = 2e-2
B, S_TEXT, N_DECODE = 2, 8, 4


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
    """arch -> (ref cfg, ref model, ref params, port model, port params)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg, model, params = reduced_zoo(arch)
            tmodel = build_model(get_config(arch).reduced())
            tparams = tmodel.from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")
            cache[arch] = (cfg, model, params, tmodel, tparams)
        return cache[arch]
    return get


def make_batch(cfg, seed: int = 1) -> dict:
    """Prompt batch as numpy arrays (bf16 images, int32 tokens)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S_TEXT))
             .astype(np.int32)}
    if cfg.family == "vlm":
        v = cfg.vlm
        if v.vision_tower:
            shape = (B, (v.vit_image_size // v.vit_patch) ** 2,
                     3 * v.vit_patch ** 2)
            key = "patches"
        else:
            shape, key = (B, v.n_image_tokens, v.d_vision), "patch_embeds"
        batch[key] = (rng.standard_normal(shape, np.float32) * 0.3) \
            .astype(jnp.bfloat16)
    return batch


# ---------------------------------------------------------------------------
# parameters
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


def test_params_from_numpy_is_bit_exact(pair):
    cfg, model, params, tmodel, tparams = pair("llava15-7b")
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in leaves:
        keys = [p.key for p in path]
        got = _port_leaf(tparams, keys)
        want = np.asarray(leaf)
        assert tuple(got.shape) == want.shape, keys
        assert str(got.dtype).split(".")[-1] == want.dtype.name, keys
        assert np.array_equal(_bits(to_np(got)), _bits(want)), keys
    # one tensor per block of a stack: L tensors where the reference has one
    assert len(list(tparams.parameters())) == sum(
        np.shape(leaf)[0] if "blocks" in [p.key for p in path] else 1
        for path, leaf in leaves)
    assert TPM.count_params(tparams) == RPM.count_params(params)
    # per-layer modules: a stack of L blocks is L modules, not one tensor
    assert len(tparams.vlm.language_model.blocks) == cfg.n_layers
    assert len(tparams.vlm.vision_tower.blocks) == cfg.vlm.vit_layers


def to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def test_params_from_numpy_rejects_a_wrong_shape(pair):
    cfg, model, params, tmodel, _ = pair("smollm-360m")
    tree = jax.tree.map(np.asarray, params)
    tree["language_model"]["head"]["final_norm"]["scale"] = np.ones(3)
    with pytest.raises(ValueError, match="final_norm"):
        tmodel.from_numpy(tree, "cpu")


@pytest.mark.parametrize("arch", ["llava15-7b", "qwen3-32b"])
def test_init_params_follows_the_reference_rules(arch, pair):
    cfg, model, params, tmodel, _ = pair(arch)
    p1 = tmodel.init(torch.Generator().manual_seed(0), "cpu")
    p2 = tmodel.init(torch.Generator().manual_seed(0), "cpu")
    assert TPM.count_params(p1) == RPM.count_params(params)
    specs = jax.tree_util.tree_flatten_with_path(model.param_specs())[0]
    for path, sd in specs:
        keys = [p.key for p in path]
        got = _port_leaf(p1, keys)
        assert tuple(got.shape) == sd.shape, keys
        assert str(got.dtype).split(".")[-1] == sd.dtype.name, keys
        assert torch.equal(got, _port_leaf(p2, keys)), keys     # seeded
    for mod in p1.modules():
        if isinstance(mod, TPM.LayerParams):
            for name, t in mod.named_parameters():
                assert not t.requires_grad
    lm = next(iter(p1.children()))
    if "language_model" in lm:
        lm = lm.language_model
    assert torch.equal(lm.head.final_norm.scale,
                       torch.ones_like(lm.head.final_norm.scale))  # "ones"
    w = lm.blocks[0].ffn.wd.float()                                # normal
    assert abs(w.std().item() * np.sqrt(cfg.d_ff) - 1.0) < 0.1
    e = lm.embed.tok.w.float()                                     # embed
    assert abs(e.std().item() / 0.02 - 1.0) < 0.1


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-32b", "llava-next-mistral-7b"])
def test_gqa_forward_and_decode_parity(arch, pair):
    cfg, model, params, tmodel, tparams = pair(arch)
    root = next(iter(params))
    jlm = params[root] if "language_model" not in params[root] \
        else params[root]["language_model"]
    tlm = tparams[root] if "language_model" not in tparams[root] \
        else tparams[root].language_model
    ja = jax.tree.map(lambda a: a[0], jlm["blocks"]["attn"])
    ta = tlm.blocks[0].attn
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta,
              qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 10, cfg.d_model), np.float32) \
        .astype(jnp.bfloat16)
    with jax.disable_jit():
        want = RA.gqa_forward(ja, jnp.asarray(x), **kw)
    with torch.inference_mode():
        got = TA.gqa_forward(ta, to_torch(x), **kw)
    close(got, want, "gqa_forward")

    # decode: a cache with 5 valid positions of 12
    hd = cfg.resolved_head_dim
    kc = rng.standard_normal((B, 12, cfg.n_kv_heads, hd), np.float32) \
        .astype(jnp.bfloat16)
    vc = rng.standard_normal((B, 12, cfg.n_kv_heads, hd), np.float32) \
        .astype(jnp.bfloat16)
    ln = np.full((B,), 5, np.int32)
    x1 = x[:, :1]
    with jax.disable_jit():
        want, wc = RA.gqa_decode(ja, jnp.asarray(x1),
                                 {"k": jnp.asarray(kc), "v": jnp.asarray(vc),
                                  "len": jnp.asarray(ln)}, **kw)
    tk, tv = to_torch(kc), to_torch(vc)
    with torch.inference_mode():
        got, gc = TA.gqa_decode(ta, to_torch(x1),
                                {"k": tk, "v": tv,
                                 "len": torch.from_numpy(ln)}, **kw)
    close(got, want, "gqa_decode out")
    close(gc["k"], wc["k"], "gqa_decode k cache")
    close(gc["v"], wc["v"], "gqa_decode v cache")
    assert np.array_equal(gc["len"].numpy(), np.asarray(wc["len"]))
    assert gc["k"].data_ptr() == tk.data_ptr()       # written in place
    # only position 5 changed
    assert np.array_equal(f32(gc["k"])[:, :5], f32(kc)[:, :5])
    assert np.array_equal(f32(gc["k"])[:, 6:], f32(kc)[:, 6:])


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-32b"])
def test_lm_backbone_parity(arch, pair):
    cfg, model, params, tmodel, tparams = pair(arch)
    x = (np.random.default_rng(5).standard_normal((B, 6, cfg.d_model),
                                                   np.float32) * 0.02) \
        .astype(jnp.bfloat16)
    with jax.disable_jit():
        want, _ = RT.lm_backbone(cfg, params["language_model"],
                                 jnp.asarray(x))
        want_logits = RT.lm_logits(cfg, params["language_model"], want)
    with torch.inference_mode():
        got, aux = TT.lm_backbone(cfg, tparams.language_model,
                                  to_torch(x))
        got_logits = TT.lm_logits(cfg, tparams.language_model, got)
    assert aux == 0.0                  # a dense model: no aux tensor
    close(got, want, f"{arch} lm_backbone")
    close(got_logits, want_logits, f"{arch} lm_logits")


def test_vit_and_projector_parity(pair):
    cfg, model, params, tmodel, tparams = pair("llava15-7b")
    batch = make_batch(cfg, seed=2)
    with jax.disable_jit():
        want = RV.vit_forward(params["vlm"], jnp.asarray(batch["patches"]),
                              cfg.vlm, cfg.norm_eps)
        want_img = RVLM.project_image(cfg, params["vlm"], want)
    with torch.inference_mode():
        got = TV.vit_forward(tparams.vlm, to_torch(batch["patches"]),
                             cfg.vlm, cfg.norm_eps)
        got_img = TVLM.project_image(cfg, tparams.vlm, got)
    assert tuple(got.shape) == want.shape
    close(got, want, "vit_forward")
    close(got_img, want_img, "project_image")


def test_project_image_parity_stub_frontend(pair):
    cfg, model, params, tmodel, tparams = pair("llava-next-mistral-7b")
    feats = make_batch(cfg, seed=3)["patch_embeds"]
    with jax.disable_jit():
        want = RVLM.project_image(cfg, params["vlm"], jnp.asarray(feats))
    with torch.inference_mode():
        got = TVLM.project_image(cfg, tparams.vlm, to_torch(feats))
    close(got, want, "project_image")


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_teacher_forced_decode(arch, pair):
    cfg, model, params, tmodel, tparams = pair(arch)
    batch = make_batch(cfg)
    with jax.disable_jit():
        want, wcache = model.prefill(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        got, gcache = tmodel.prefill(
            tparams, {k: to_torch(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    close(got, want, f"{arch} prefill logits")
    for key in ("k", "v"):
        assert gcache["blocks"][key].dtype == torch.bfloat16
        assert tuple(gcache["blocks"][key].shape) == \
            wcache["blocks"][key].shape
        close(gcache["blocks"][key], wcache["blocks"][key],
              f"{arch} prefill cache {key}")
    assert np.array_equal(gcache["len"].numpy(), np.asarray(wcache["len"]))

    wcache = ref_pad_cache(wcache, N_DECODE)
    gcache = TS.pad_cache(gcache, N_DECODE)
    rng = np.random.default_rng(6)
    for step in range(N_DECODE):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        with jax.disable_jit():
            want, wcache = model.decode_step(params, jnp.asarray(tok),
                                             wcache)
        with torch.inference_mode():
            got, gcache = tmodel.decode_step(tparams, to_torch(tok), gcache)
        close(got, want, f"{arch} decode step {step} logits")
    for key in ("k", "v"):
        close(gcache["blocks"][key], wcache["blocks"][key],
              f"{arch} cache {key} after decode")
    assert np.array_equal(gcache["len"].numpy(), np.asarray(wcache["len"]))


def test_pad_cache_grows_only_sequence_leaves(pair):
    cfg, model, params, tmodel, tparams = pair("smollm-360m")
    cache = tmodel.init_cache(B, 6, "cpu")
    cache["blocks"]["k"].fill_(1.0)
    grown = TS.pad_cache(cache, 3)
    want = ref_pad_cache(model.init_cache(B, 6), 3)
    for key in ("k", "v"):
        assert tuple(grown["blocks"][key].shape) == want["blocks"][key].shape
    assert torch.equal(grown["blocks"]["k"][:, :, :6],
                       cache["blocks"]["k"])
    assert not grown["blocks"]["k"][:, :, 6:].any()
    assert grown["len"] is cache["len"]


def test_generate_matches_the_reference_where_the_margin_is_clear(pair):
    """Greedy tokens equal the reference's at every step whose top-2 logit
    margin exceeds twice the tolerance (each of the two logits may move by
    the tolerance); past the first step that does not, the two contexts
    may differ and nothing more is compared."""
    cfg, model, params, tmodel, tparams = pair("llava15-7b")
    batch = make_batch(cfg, seed=8)
    n_new = 6
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.disable_jit():
        want = np.asarray(ref_generate(model, params, jb, n_new))
        # the reference's logits along its own tokens
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
    assert compared >= B          # at least the first token of each row


def test_generate_runs_on_cuda_by_default(pair, monkeypatch):
    cfg, model, params, tmodel, tparams = pair("smollm-360m")
    batch = make_batch(cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TS.generate(tmodel, tparams, batch, 2, device=device)
    with pytest.raises(ValueError, match="parameter lives on cpu"):
        TS.generate(tmodel, tparams, batch, 2, device="meta")
    out = TS.generate(tmodel, tparams, batch, 3, device="cpu")
    assert tuple(out.shape) == (B, 3) and out.device.type == "cpu"


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "minicpm3-4b",
                                  "mamba2-1.3b", "zamba2-2.7b"])
def test_unported_families_raise(arch):
    if arch == "mamba2-1.3b":    # serves (test_torch_mamba.py) and, from
        # the SSM training slice, trains: its loss runs on the CPU
        model = build_model(get_config(arch).reduced())
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        toks = torch.zeros((1, 8), dtype=torch.int32)
        loss, _ = model.loss(params, {"tokens": toks, "labels": toks})
        assert bool(torch.isfinite(loss))
        return
    # the MLA slice (test_torch_mla.py) and the hybrid slice
    # (test_torch_hybrid.py): every entry point of the reduced config runs
    # on the CPU, and generate serves
    model = build_model(get_config(arch).reduced())
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    loss, _ = model.loss(params, {"tokens": toks, "labels": toks})
    logits, cache = model.prefill(params, {"tokens": toks})
    logits, _ = model.decode_step(params, toks[:, :1],
                                  model.init_cache(1, 4, "cpu"))
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(logits).all())
    assert set(cache["blocks"]) == ({"ssm", "conv"} if arch == "zamba2-2.7b"
                                    else {"latent", "k_rope"})
    out = TS.generate(model, params, {"tokens": toks}, 2, device="cpu")
    assert tuple(out.shape) == (1, 2)
