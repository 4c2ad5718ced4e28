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
the oracle read bf16 inputs at different points.  The kernels themselves
are held against the plain version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as RREF
from repro.kernels.flash_attention import flash_bwd as pallas_flash_bwd
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import ops as TOPS

# the cases of tests/test_kernels.py: (B, Sq, Skv, H, Hkv, D, Dv, causal,
# block) — ragged seq, decode-shaped q, MQA with Dq != Dv, off-by-two
# padding, q continuation (offset)
FLASH_CASES = [
    (2, 256, 256, 4, 2, 64, 64, True, 128),
    (1, 200, 200, 6, 3, 32, 32, True, 128),
    (2, 1, 384, 4, 4, 64, 64, False, 128),
    (1, 256, 256, 8, 1, 128, 64, True, 128),
    (1, 130, 130, 2, 2, 64, 64, True, 128),
    (2, 128, 256, 4, 2, 64, 64, True, 128),
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
