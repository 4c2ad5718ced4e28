"""Port of the flash-attention backward (repro_torch.kernels.flash_attention
``flash_bwd`` and the autograd Function of ``kernels.ops``) against the
reference package's Pallas backward in interpret mode and against
``jax.grad`` of its naive oracle, on the CPU, where the wrappers take the
plain versions.

Inputs (q, k, v and the output gradient) are made with numpy from a seed;
``out`` and ``lse`` come from the port's plain forward and are handed to
both sides as numpy arrays.  Tolerances: 5e-4 in fp32, the reference's own
gradient tolerance (tests/test_kernels.py: sums over a whole sequence in
another order); 2e-2 of the compared tensor's scale in bf16, where each
gradient is rounded once to bf16 on each side and the Pallas kernel and
the oracle read bf16 inputs at different points.  Rounding models of the
bf16 tensor-core dq and dk / dv kernels (dS, and for dk / dv also P,
rounded to bf16 before their products) are held to the Pallas backward at
the same bf16 tolerance.  The
kernels themselves are held against the plain version on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as RREF
from repro.kernels.flash_attention import flash_bwd as pallas_flash_bwd
from repro_torch.configs import get_config
from repro_torch.core.spec import LLAVA_STAGE2
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import ops as TOPS
from repro_torch.models import build_model
from repro_torch.models import param as TPM
from repro_torch.train import OptimizerConfig, train_state
from tests.test_torch_flash_attention import (split_bf16,
                                              tensor_core_forward_model)

# the cases of tests/test_kernels.py: (B, Sq, Skv, H, Hkv, D, Dv, causal,
# block) — ragged seq, decode-shaped q, MQA with Dq != Dv, off-by-two
# padding, q continuation (offset); then the enc-dec's cross-attention
FLASH_CASES = [
    (2, 256, 256, 4, 2, 64, 64, True, 128),
    (1, 200, 200, 6, 3, 32, 32, True, 128),
    (2, 1, 384, 4, 4, 64, 64, False, 128),
    (1, 256, 256, 8, 1, 128, 64, True, 128),
    (1, 130, 130, 2, 2, 64, 64, True, 128),
    (2, 128, 256, 4, 2, 64, 64, True, 128),
    # the enc-dec's cross-attention: non-causal, Sq (decoder) != Skv
    # (encoder)
    (2, 192, 320, 4, 4, 64, 64, False, 128),
    # the MLA pairs (H = Hkv): deepseek-v2-lite-16b's (192, 128) causal
    # at a ragged S, minicpm3-4b's (96, 64) as a causal continuation;
    # zamba2-2.7b's (80, 80) non-causal with GQA
    (1, 130, 130, 2, 2, 192, 128, True, 128),
    (1, 64, 192, 3, 3, 96, 64, True, 128),
    (2, 100, 100, 4, 2, 80, 80, False, 128),
]
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def to_torch(a) -> torch.Tensor:
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, dtype: str, what: str) -> None:
    want = f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(f32(got), want, atol=5e-4, rtol=5e-4,
                                   err_msg=what)
    else:
        tol = 2e-2 * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(f32(got), want, rtol=0, atol=tol,
                                   err_msg=what)


def make(case, np_dtype, seed=7):
    """q, k, v, dout (numpy, in np_dtype) and the q offset of a case."""
    B, Sq, Skv, H, Hkv, D, Dv, causal, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D), np.float32).astype(np_dtype)
    k = rng.standard_normal((B, Skv, Hkv, D), np.float32).astype(np_dtype)
    v = rng.standard_normal((B, Skv, Hkv, Dv), np.float32).astype(np_dtype)
    do = rng.standard_normal((B, Sq, H, Dv), np.float32).astype(np_dtype)
    return q, k, v, do, (Skv - Sq if causal else 0)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_pallas_backward_and_oracle_grad(case, dtype):
    np_dtype, _ = DTYPES[dtype]
    causal, block = case[7], case[8]
    q, k, v, do, qoff = make(case, np_dtype)
    tq, tk, tv, tdo = map(to_torch, (q, k, v, do))
    out, lse = TFA.flash_fwd_plain(tq, tk, tv, causal=causal, q_offset=qoff)
    got = TFA.flash_bwd_plain(tq, tk, tv, out, lse, tdo, causal=causal,
                              q_offset=qoff)
    for g, t in zip(got, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape

    # the Pallas kernels on the very same out / lse
    kernel = pallas_flash_bwd(*map(jnp.asarray, (q, k, v, to_np(out),
                                                 lse.numpy(), do)),
                              causal=causal, block_q=block, block_k=block,
                              q_offset=qoff, interpret=True)
    # autodiff of the naive oracle: d/d(q,k,v) of sum(out * dout)
    oracle = jax.grad(
        lambda q, k, v: (RREF.attention_ref(q, k, v, causal, qoff)[0]
                         .astype(jnp.float32)
                         * jnp.asarray(do, jnp.float32)).sum(),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for name, g, want_k, want_o in zip(("dq", "dk", "dv"), got, kernel,
                                       oracle):
        close(g, want_k, dtype, f"{name} vs Pallas _dq/_dkv_kernel")
        close(g, want_o, dtype, f"{name} vs jax.grad(attention_ref)")


@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[3],
                                  FLASH_CASES[5]])
def test_ops_autograd_on_cpu_is_the_plain_backward(case):
    """The autograd Function on CPU tensors runs the plain forward and the
    plain backward: its gradients are flash_bwd_plain's, bit for bit, and
    nothing is launched."""
    q, k, v, do, qoff = make(case, np.float32, seed=3)
    tq, tk, tv, tdo = map(to_torch, (q, k, v, do))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    before = (TFA.launches, TFA.dq_launches, TFA.dkv_launches)
    out = TOPS.flash_attention(*leaves, case[7], qoff)
    grads = torch.autograd.grad(out, leaves, tdo)
    p_out, p_lse = TFA.flash_fwd_plain(tq, tk, tv, causal=case[7],
                                       q_offset=qoff)
    want = TFA.flash_bwd_plain(tq, tk, tv, p_out, p_lse, tdo,
                               causal=case[7], q_offset=qoff)
    assert torch.equal(out.detach(), p_out)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    assert (TFA.launches, TFA.dq_launches, TFA.dkv_launches) == before
    # the wrapper on CPU tensors is the plain version too
    for g, w in zip(TFA.flash_bwd(tq, tk, tv, p_out, p_lse, tdo,
                                  causal=case[7], q_offset=qoff), want):
        assert torch.equal(g, w)


def test_ragged_vit_sequence_and_offset_grads():
    """The vision tower's 577-token non-causal sequence and a causal
    continuation (q_offset > 0 against a ragged kv length): the plain
    backward against jax.grad of the oracle."""
    for case in ((1, 577, 577, 2, 2, 64, 64, False, 128),
                 (1, 65, 577, 2, 1, 64, 64, True, 128)):
        q, k, v, do, qoff = make(case, np.float32, seed=11)
        tq, tk, tv, tdo = map(to_torch, (q, k, v, do))
        out, lse = TFA.flash_fwd_plain(tq, tk, tv, causal=case[7],
                                       q_offset=qoff)
        got = TFA.flash_bwd_plain(tq, tk, tv, out, lse, tdo, causal=case[7],
                                  q_offset=qoff)
        want = jax.grad(
            lambda q, k, v: (RREF.attention_ref(q, k, v, case[7], qoff)[0]
                             * jnp.asarray(do)).sum(),
            argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            close(g, w, "float32", f"{name} {case}")


def _bad_calls():
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    lse = torch.zeros(1, 4, 8)
    bwd = TFA.flash_bwd
    yield "float16", lambda: bwd(q.half(), k.half(), k.half(), q.half(),
                                 lse, q.half())
    yield "out type", lambda: bwd(q, k, k, q.bfloat16(), lse, q)
    yield "dout shape", lambda: bwd(q, k, k, q, lse, q[:, :7])
    yield "out width", lambda: bwd(q, k, torch.zeros(1, 8, 2, 16), q, lse, q)
    yield "lse type", lambda: bwd(q, k, k, q, lse.bfloat16(), q)
    yield "lse shape", lambda: bwd(q, k, k, q, lse.transpose(1, 2), q)
    yield "lse numpy", lambda: bwd(q, k, k, q, lse.numpy(), q)
    yield "H % Hkv", lambda: bwd(torch.zeros(1, 8, 3, 32), k, k,
                                 torch.zeros(1, 8, 3, 32),
                                 torch.zeros(1, 3, 8), torch.zeros(1, 8, 3,
                                                                   32))
    yield "negative offset", lambda: bwd(q, k, k, q, lse, q, q_offset=-1)
    yield "meta device", lambda: bwd(*(t.to("meta") for t in
                                       (q, k, k, q, lse, q)))
    # the two passes alone launch kernels: CPU tensors raise
    yield "dq pass on cpu", lambda: TFA.flash_bwd_dq(q, k, k, q, lse, q)
    yield "dkv pass on cpu", lambda: TFA.flash_bwd_dkv(q, k, k, lse, q, lse)
    yield "dkv delta shape", lambda: TFA.flash_bwd_dkv(q, k, k, lse, q,
                                                       lse[:, :2])


@pytest.mark.parametrize("name,call", list(_bad_calls()),
                         ids=[n for n, _ in _bad_calls()])
def test_backward_wrapper_refuses_what_the_kernels_do_not_take(name, call):
    with pytest.raises((TypeError, ValueError)):
        call()


# ---------------------------------------------------------------------------
# the bf16 tensor-core backward kernels' roundings
# (flash_bwd_dq_kernel_wgmma, flash_bwd_dkv_kernel_wgmma)
# ---------------------------------------------------------------------------

def tensor_core_dkv_model(q, k, v, out, lse, dout, causal, q_offset):
    """A rounding model of ``flash_bwd_dkv_kernel_wgmma`` in plain torch:
    scores from bf16 products summed in fp32, the scale on the fp32
    scores, ``P = exp(scale s - lse)`` in fp32, rounded to bf16 for ``dV
    = P^T dO``; ``dS = P (dP - delta)`` from the fp32 P, rounded to bf16
    for ``dK = scale dS^T q``; every product of bf16 operands summed in
    fp32, one rounding of dk and dv."""
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    do = dout.float().reshape(B, Sq, Hkv, G, Dv)
    delta = (do * out.float().reshape(B, Sq, Hkv, G, Dv)).sum(-1)
    s = torch.einsum("bshgd,bthd->bhgst", qf, k.float()) * D ** -0.5
    p = torch.exp(s - lse.reshape(B, Hkv, G, Sq, 1))
    if causal:
        keep = torch.arange(Skv)[None, :] <= q_offset + torch.arange(Sq)[:, None]
        p = p.masked_fill(~keep, 0.0)
    dv = torch.einsum("bhgst,bshgd->bthd", p.to(torch.bfloat16).float(), do)
    dp = torch.einsum("bshgd,bthd->bhgst", do, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dk = torch.einsum("bhgst,bshgd->bthd", ds.to(torch.bfloat16).float(),
                      qf) * D ** -0.5
    return dk.to(k.dtype), dv.to(v.dtype)


def tensor_core_dq_model(q, k, v, out, lse, dout, causal, q_offset,
                         split_ds=False):
    """A rounding model of ``flash_bwd_dq_kernel_wgmma`` in plain torch: S =
    q k^T and dP = dO v^T from bf16 products summed in fp32, the scale on
    the fp32 scores, ``P = exp(scale s - lse)`` and ``dS = P (dP -
    delta)`` in fp32, ``delta = sum(dO * out)`` in fp32; dS rounded to
    bf16 once before ``dQ = scale dS k`` (what the kernel does), or with
    ``split_ds`` carried as two bf16 parts, hi = bf16(dS) plus lo =
    bf16(dS - hi); the products summed in fp32, one rounding of dq."""
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    do = dout.float().reshape(B, Sq, Hkv, G, Dv)
    delta = (do * out.float().reshape(B, Sq, Hkv, G, Dv)).sum(-1)
    s = torch.einsum("bshgd,bthd->bhgst", q.float().reshape(B, Sq, Hkv, G, D),
                     k.float()) * D ** -0.5
    p = torch.exp(s - lse.reshape(B, Hkv, G, Sq, 1))
    if causal:
        keep = torch.arange(Skv)[None, :] <= q_offset + torch.arange(Sq)[:, None]
        p = p.masked_fill(~keep, 0.0)
    dp = torch.einsum("bshgd,bthd->bhgst", do, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    ds = split_bf16(ds) if split_ds else ds.to(torch.bfloat16).float()
    dq = torch.einsum("bhgst,bthd->bshgd", ds, k.float()) * D ** -0.5
    return dq.reshape(B, Sq, H, D).to(q.dtype)


# the reference's cases, the vision tower's ragged 577, a causal
# continuation against a ragged kv length, and the reduced configs' D = 16
TENSOR_CORE_CASES = FLASH_CASES + [
    (1, 577, 577, 2, 2, 64, 64, False, 128),
    (1, 65, 577, 2, 1, 64, 64, True, 128),
    (2, 70, 70, 2, 2, 16, 16, True, 128),
]


@pytest.mark.parametrize("case", TENSOR_CORE_CASES,
                         ids=["x".join(map(str, c[:8])) for c in
                              TENSOR_CORE_CASES])
def test_tensor_core_dkv_roundings_fit_the_bf16_tolerance(case):
    """Rounding P and dS to bf16 before the products that make dv and dk,
    as the tensor-core kernel does, stays within 2e-2 of each gradient's
    scale of the reference's Pallas backward (interpret mode) on the same
    out and lse."""
    causal, block = case[7], case[8]
    q, k, v, do, qoff = make(case, jnp.bfloat16, seed=5)
    tq, tk, tv, tdo = map(to_torch, (q, k, v, do))
    out, lse = TFA.flash_fwd_plain(tq, tk, tv, causal=causal, q_offset=qoff)
    dk, dv = tensor_core_dkv_model(tq, tk, tv, out, lse, tdo, causal, qoff)
    assert dk.dtype == dv.dtype == torch.bfloat16
    _, want_dk, want_dv = pallas_flash_bwd(
        *map(jnp.asarray, (q, k, v, to_np(out), lse.numpy(), do)),
        causal=causal, block_q=block, block_k=block, q_offset=qoff,
        interpret=True)
    close(dk, want_dk, "bfloat16", "dk vs Pallas _dkv_kernel")
    close(dv, want_dv, "bfloat16", "dv vs Pallas _dkv_kernel")


@pytest.mark.parametrize("case", TENSOR_CORE_CASES,
                         ids=["x".join(map(str, c[:8])) for c in
                              TENSOR_CORE_CASES])
def test_tensor_core_dq_roundings_fit_the_bf16_tolerance(case):
    """Rounding dS to bf16 once before dq = dS k, as the wgmma dq kernel
    does (dS packed from the fp32 accumulators into the A operand of
    ``dQ += dS K``), with P and dS in fp32 and every product summed in
    fp32, stays within 2e-2 of dq's scale of the reference's Pallas
    backward (interpret mode) on the same out and lse."""
    causal, block = case[7], case[8]
    q, k, v, do, qoff = make(case, jnp.bfloat16, seed=5)
    tq, tk, tv, tdo = map(to_torch, (q, k, v, do))
    out, lse = TFA.flash_fwd_plain(tq, tk, tv, causal=causal, q_offset=qoff)
    dq = tensor_core_dq_model(tq, tk, tv, out, lse, tdo, causal, qoff)
    assert dq.dtype == torch.bfloat16 and dq.shape == tq.shape
    want_dq, _, _ = pallas_flash_bwd(
        *map(jnp.asarray, (q, k, v, to_np(out), lse.numpy(), do)),
        causal=causal, block_q=block, block_k=block, q_offset=qoff,
        interpret=True)
    close(dq, want_dq, "bfloat16", "dq vs Pallas _dq_kernel")


def reduced_vlm_gradient_spread(monkeypatch, split_ds=False) -> dict:
    """The reduced llava15-7b's LLaVA stage-2 loss and gradients (bf16,
    remat "block") with attention through the rounding models of the three
    tensor-core kernels (forward, dq with ``split_ds``, dk / dv), against
    the same step through the plain versions: ``{"loss": (got, want),
    leaf name: max |got - want| / max |want|}``."""
    cfg = get_config("llava15-7b").reduced()
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(20260811)
    params = model.init(gen, "cpu")
    v = cfg.vlm
    n_patch = (v.vit_image_size // v.vit_patch) ** 2
    batch = {"patches": (torch.randn(2, n_patch, 3 * v.vit_patch ** 2,
                                     generator=gen) * 0.3).bfloat16(),
             "tokens": torch.randint(0, cfg.vocab, (2, 8), generator=gen,
                                     dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab, (2, 8), generator=gen,
                                     dtype=torch.int32)}
    state = train_state(params, LLAVA_STAGE2, OptimizerConfig(name="adamw"))
    named = TPM.trainable_params(state.params)

    def loss_and_grads():
        loss, _ = model.loss(state.params, batch, remat="block")
        return float(loss.detach()), torch.autograd.grad(
            loss, [p for _, p in named])

    want_loss, want = loss_and_grads()

    def fwd(q, k, v, *, causal=True, q_offset=0):
        return tensor_core_forward_model(q, k, v, causal, q_offset)

    def bwd(q, k, v, out, lse, dout, *, causal=True, q_offset=0):
        return (tensor_core_dq_model(q, k, v, out, lse, dout, causal,
                                     q_offset, split_ds),
                *tensor_core_dkv_model(q, k, v, out, lse, dout, causal,
                                       q_offset))

    with monkeypatch.context() as m:
        m.setattr(TFA, "flash_fwd", fwd)
        m.setattr(TFA, "flash_bwd", bwd)
        got_loss, got = loss_and_grads()
    spread = {"loss": (got_loss, want_loss)}
    for (name, _), g, w in zip(named, got, want):
        spread[name] = float((g.float() - w.float()).abs().max()) / max(
            float(w.float().abs().max()), 1e-30)
    return spread


def _hold_reduced_vlm_gate(monkeypatch, split_ds: bool) -> None:
    spread = reduced_vlm_gradient_spread(monkeypatch, split_ds)
    got_loss, want_loss = spread.pop("loss")
    assert abs(got_loss - want_loss) <= 2e-2 * max(1.0, abs(want_loss))
    assert len(spread) > 1
    for name, rel in spread.items():
        assert rel <= 2e-2, f"{name}: {rel:.4g} of its scale"


def test_tensor_core_roundings_keep_the_reduced_vlm_gradients(monkeypatch):
    """The slice as a whole: the reduced llava15-7b's LLaVA stage-2 loss
    and gradients (bf16, remat "block"), with attention through the
    rounding models of the three tensor-core kernels (forward, dq with dS
    rounded to bf16 once, dk / dv), within 2e-2 of each trainable leaf's
    scale of the same step through the plain versions: the gate
    chip_smoke.py holds the card's kernel path to against the CPU."""
    _hold_reduced_vlm_gate(monkeypatch, split_ds=False)


def test_split_ds_in_the_dq_pass_keeps_the_reduced_vlm_gradients(
        monkeypatch):
    """The alternative the dq kernel was weighed against: dS carried into
    dq as two bf16 parts (as the forward carries P) holds the same gate;
    one rounding holds it too, so the kernel takes the cheaper one."""
    _hold_reduced_vlm_gate(monkeypatch, split_ds=True)


@pytest.mark.parametrize("pair,sweeps,bq,cols", [
    ((128, 128), 1, 32, (128, 128)), ((192, 128), 2, 64, (192, 128)),
    ((256, 256), 4, 32, (128, 128)), ((96, 64), 1, 64, (96, 64)),
    ((80, 80), 1, 64, (80, 80)), ((64, 64), 1, 64, (64, 64))],
    ids=["128x128", "192x128", "256x256", "96x64", "80x80", "64x64"])
def test_wgmma_dkv_plan_sweeps_and_steps(pair, sweeps, bq, cols):
    """The wgmma dk / dv pass's sweeps over the q tiles and its q rows a
    step: one sweep up to D + Dv = 256, two (dV, then dK) to 384, four
    (dV's and dK's column halves) above; 32-row steps where a sweep holds
    128 accumulator registers ((128, 128)) or two 64-row stages would pass
    the opt-in ((256, 256)).  The dk and dv products of a sweep span the
    columns it accumulates, and the sweeps' accumulators with S^T and dP^T
    stay under the consumer's registers."""
    plan = TFA.wgmma_plan("dkv", *pair)
    assert plan["sweeps"] == sweeps and plan["tile"] == (128, bq)
    n = {name.split(" ")[0]: n for name, _, n, _, _, _ in plan["products"]}
    assert (n["dk"], n["dv"]) == cols
    assert n["s^T"] == n["dp^T"] == bq
    assert plan["live_registers"] <= plan["registers"]["consumer"] - 32


@pytest.mark.parametrize("pair,bk,stages,smem", [
    ((128, 128), 64, 3, 164920), ((192, 128), 64, 3, 205880),
    ((256, 256), 32, 3, 230456), ((96, 64), 64, 3, 103480),
    ((80, 80), 64, 3, 103480), ((64, 64), 64, 3, 83000),
    ((128, 64), 64, 3, 123960), ((32, 32), 64, 3, 42040),
    ((16, 16), 64, 3, 21560)],
    ids=["128x128", "192x128", "256x256", "96x64", "80x80", "64x64",
         "128x64", "32x32", "16x16"])
def test_wgmma_dq_plan_tiles_and_steps(pair, bk, stages, smem):
    """The wgmma dq pass's tile and ring: 128 q rows a block, kv steps of
    64 rows where D + Dv <= 384 and 32 at (256, 256) (dQ's D / 2
    accumulator registers and the step's S and dP, BK / 2 each, under the
    consumer's 232), 3 stages of K and V beside the q and dO tiles within
    the opt-in.  S = q k^T and dP = dO v^T span the step's kv rows, dQ +=
    dS k spans D with K MN-major, and the live registers leave 32 for the
    rest."""
    D, Dv = pair
    plan = TFA.wgmma_plan("dq", *pair)
    assert plan["tile"] == (128, bk) and plan["stages"] == stages
    assert plan["sweeps"] == 1 and plan["smem_bytes"] == smem <= 232448
    prods = {p[0].split(" ")[0]: list(p[1:]) for p in plan["products"]}
    assert prods["s"] == [64, bk, D, "smem", "K"]
    assert prods["dp"] == [64, bk, Dv, "smem", "K"]
    assert prods["dq"] == [64, D, bk, "registers", "MN"]
    assert plan["live_registers"] == D // 2 + bk
    assert plan["live_registers"] <= plan["registers"]["consumer"] - 32
    assert set(plan["operands"]) == {"q", "dout", "k", "v"}
    assert plan["operands"]["k"]["rows"] == bk
    assert plan["operands"]["q"]["rows"] == 128
