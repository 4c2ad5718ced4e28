"""Port of the flash-attention forward (repro_torch.kernels.flash_attention)
against the reference package's Pallas kernel in interpret mode and its
naive oracle, on the CPU, where the wrapper takes the plain version.

Inputs are made with numpy from a seed and handed to both sides (bf16 by
the same round-to-nearest-even cast).  Tolerances are the reference's own
kernel tolerances (tests/test_kernels.py): 2e-5 in fp32 — both sides do
the whole computation in fp32, only the summation order differs — and
2e-2 in bf16, where the output is rounded once to bf16 on each side.  A
rounding model of the bf16 tensor-core kernel (probabilities split into
two bf16 parts before the second product) is held to the Pallas kernel at
the same bf16 tolerance, which shows that the kernel's roundings fit it.
The
kernels themselves are held against the plain version on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_fwd as pallas_flash_fwd
from repro.kernels import ref as RREF
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF

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
DTYPES = {"float32": (np.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def make_qkv(case, np_dtype, seed=7):
    B, Sq, Skv, H, Hkv, D, Dv, causal, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D), np.float32).astype(np_dtype)
    k = rng.standard_normal((B, Skv, Hkv, D), np.float32).astype(np_dtype)
    v = rng.standard_normal((B, Skv, Hkv, Dv), np.float32).astype(np_dtype)
    return q, k, v, (Skv - Sq if causal else 0)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_pallas_kernel_and_oracle(case, dtype):
    np_dtype, _, tol = DTYPES[dtype]
    causal, block = case[7], case[8]
    q, k, v, qoff = make_qkv(case, np_dtype)
    out, lse = TFA.flash_fwd_plain(to_torch(q), to_torch(k), to_torch(v),
                                   causal=causal, q_offset=qoff)
    assert out.dtype == to_torch(q).dtype and lse.dtype == torch.float32
    assert tuple(out.shape) == q.shape[:3] + (v.shape[3],)
    assert tuple(lse.shape) == (q.shape[0], q.shape[2], q.shape[1])
    k_out, k_lse = pallas_flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    block_q=block, block_k=block,
                                    q_offset=qoff, interpret=True)
    r_out, r_lse = RREF.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal, qoff)
    for want_out, want_lse in ((k_out, k_lse), (r_out, r_lse)):
        np.testing.assert_allclose(as_f32(out), as_f32(want_out),
                                   atol=tol, rtol=tol)
        # lse is fp32 on every side, whatever the inputs' type
        np.testing.assert_allclose(as_f32(lse), as_f32(want_lse),
                                   atol=2e-5, rtol=2e-5)
    # the port's own oracle agrees with the reference's
    t_out, t_lse = TREF.attention_ref(to_torch(q), to_torch(k), to_torch(v),
                                      causal, qoff)
    np.testing.assert_allclose(as_f32(t_out), as_f32(r_out), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(as_f32(t_lse), as_f32(r_lse), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("case", [FLASH_CASES[1], FLASH_CASES[5]])
def test_wrapper_takes_plain_version_on_cpu(case):
    q, k, v, qoff = make_qkv(case, np.float32, seed=3)
    tq, tk, tv = to_torch(q), to_torch(k), to_torch(v)
    before = TFA.launches
    out, lse = TFA.flash_fwd(tq, tk, tv, causal=case[7], q_offset=qoff)
    p_out, p_lse = TFA.flash_fwd_plain(tq, tk, tv, causal=case[7],
                                       q_offset=qoff)
    assert torch.equal(out, p_out) and torch.equal(lse, p_lse)
    assert TFA.launches == before           # nothing was launched
    assert torch.equal(TOPS.flash_attention(tq, tk, tv, case[7], qoff),
                       p_out)


def test_ragged_vit_sequence_and_offset_masks():
    """The vision tower's 577-token sequence (ragged against any tile)
    and a causal continuation: plain version against the oracle."""
    for case in ((1, 577, 577, 2, 2, 64, 64, False, 128),
                 (1, 65, 577, 2, 1, 64, 64, True, 128)):
        q, k, v, qoff = make_qkv(case, np.float32, seed=11)
        out, lse = TFA.flash_fwd_plain(to_torch(q), to_torch(k),
                                       to_torch(v), causal=case[7],
                                       q_offset=qoff)
        r_out, r_lse = RREF.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), case[7], qoff)
        np.testing.assert_allclose(as_f32(out), as_f32(r_out), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(as_f32(lse), as_f32(r_lse), atol=2e-5,
                                   rtol=2e-5)


def _bad_calls():
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    yield "float16", lambda: TFA.flash_fwd(q.half(), k.half(), k.half())
    yield "mixed types", lambda: TFA.flash_fwd(q, k.bfloat16(), k)
    yield "3-D q", lambda: TFA.flash_fwd(q[0], k, k)
    yield "H % Hkv", lambda: TFA.flash_fwd(torch.zeros(1, 8, 3, 32), k, k)
    yield "D mismatch", lambda: TFA.flash_fwd(torch.zeros(1, 8, 4, 16), k, k)
    yield "batch mismatch", lambda: TFA.flash_fwd(
        torch.zeros(2, 8, 4, 32), k, k)
    yield "v length", lambda: TFA.flash_fwd(q, k, torch.zeros(1, 7, 2, 32))
    yield "empty", lambda: TFA.flash_fwd(torch.zeros(1, 0, 4, 32), k, k)
    yield "negative offset", lambda: TFA.flash_fwd(q, k, k, q_offset=-1)
    yield "float offset", lambda: TFA.flash_fwd(q, k, k, q_offset=1.0)
    yield "meta device", lambda: TFA.flash_fwd(
        q.to("meta"), k.to("meta"), k.to("meta"))


@pytest.mark.parametrize("name,call", list(_bad_calls()),
                         ids=[n for n, _ in _bad_calls()])
def test_wrapper_refuses_what_the_kernel_does_not_take(name, call):
    with pytest.raises((TypeError, ValueError)):
        call()


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernels' roundings (flash_fwd_kernel_wgmma, and
# flash_fwd_kernel_mma at (16, 16): the same roundings)
# ---------------------------------------------------------------------------

def split_bf16(x: torch.Tensor) -> torch.Tensor:
    """x as the kernel carries it into a product: hi = bf16(x) plus lo =
    bf16(x - hi), each an exact bf16 operand."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def tensor_core_forward_model(q, k, v, causal, q_offset):
    """A rounding model of ``flash_fwd_kernel_wgmma`` (and of
    ``flash_fwd_kernel_mma``, which rounds at the same points) in plain
    torch: the products of bf16 q and k summed in fp32, the scale applied to the fp32
    scores, the probabilities split into two bf16 parts before ``P v``
    (products of bf16 summed in fp32), the row sums and lse from the fp32
    probabilities, one rounding of out.  (The kernel splits ``exp(s - m)``
    against its running max and rescales in fp32; the model takes the
    final max: the same roundings at other points of the same size.)"""
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    s = torch.einsum("bshgd,bthd->bhgst", q.float().reshape(B, Sq, Hkv, G, D),
                     k.float()) * D ** -0.5
    if causal:
        keep = torch.arange(Skv)[None, :] <= q_offset + torch.arange(Sq)[:, None]
        s = s.masked_fill(~keep, TFA.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgst,bthd->bshgd", split_bf16(p), v.float())
    o = o / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l))[..., 0]
    return (o.reshape(B, Sq, H, Dv).to(torch.bfloat16),
            lse.reshape(B, H, Sq))


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
def test_tensor_core_roundings_fit_the_bf16_tolerance(case):
    """Carrying the probabilities as two bf16 parts into the second
    product, as the tensor-core kernel does, stays within the bf16
    tolerance of the reference's Pallas kernel (interpret mode): 2e-2, as
    allclose(atol=rtol), on out, and lse within 2e-5."""
    causal, block = case[7], case[8]
    q, k, v, qoff = make_qkv(case, jnp.bfloat16, seed=5)
    out, lse = tensor_core_forward_model(to_torch(q), to_torch(k),
                                         to_torch(v), causal, qoff)
    k_out, k_lse = pallas_flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    block_q=block, block_k=block,
                                    q_offset=qoff, interpret=True)
    np.testing.assert_allclose(as_f32(out), as_f32(k_out), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(as_f32(lse), as_f32(k_lse), atol=2e-5,
                               rtol=2e-5)


def test_bf16_kernel_refuses_tensors_off_the_16_byte_grid():
    """The tensor-core kernel copies 16 bytes at a time: the launch's guard
    refuses a bf16 view at a 2-byte offset (the wrappers hand the launch a
    fresh copy of one, ``pad_operands``); fp32 (the FMA kernel) and fresh
    bf16 tensors pass."""
    base = torch.zeros(1 * 8 * 4 * 64 + 8, dtype=torch.bfloat16)
    odd = base[1:1 + 8 * 4 * 64].view(1, 8, 4, 64)
    even = base[8:].view(1, 8, 4, 64)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        TFA._check_aligned("flash_fwd", (odd, even, even))
    TFA._check_aligned("flash_fwd", (even, even, even))
    TFA._check_aligned("flash_fwd", (torch.zeros(9)[1:],))
    assert smem_bytes("fwd", (128, 128)) == 230504
    assert smem_bytes("dkv", (128, 128)) == 116536
    assert smem_bytes("dq", (128, 128)) == 164920


def smem_bytes(kernel: str, pair: tuple) -> int:
    """Dynamic shared memory per block of the bf16 pass's wgmma kernel at
    a compiled pair."""
    return TFA.wgmma_plan(kernel, *pair)["smem_bytes"]


# the wide instances' dynamic shared memory per block, each under the
# H100's 232,448-byte opt-in: the wgmma forward's 128-row q tile and 3 (2
# at (192, 128), (256, 256)) stages of K and V tiles of 128 kv rows (64 at
# (256, 256)); the wgmma dq pass's 128-row q and dO tiles and 3 stages of
# K and V tiles of 64 kv rows (32 at (256, 256)); the wgmma dk / dv pass's
# 128 rows of K and V and 3 stages of q and dO tiles with their lse and
# delta rows (64 q rows a step, 32 at (256, 256)); each with its
# mbarriers and 1,024 bytes to align the base
WIDE_SMEM = {(192, 128): {"fwd": 214088, "dq": 205880, "dkv": 207416},
             (96, 64): {"fwd": 148584, "dq": 103480, "dkv": 105016},
             (80, 80): {"fwd": 144488, "dq": 103480, "dkv": 105016},
             (256, 256): {"fwd": 197704, "dq": 230456, "dkv": 231224}}


@pytest.mark.parametrize("pair", list(WIDE_SMEM),
                         ids=[f"{d}x{dv}" for d, dv in WIDE_SMEM])
def test_new_instances_fit_the_shared_memory_opt_in(pair):
    assert pair in TFA.HEAD_DIMS
    for kernel, want in WIDE_SMEM[pair].items():
        got = smem_bytes(kernel, pair)
        assert got == want and got <= 232448, (kernel, got)


def test_design_table_covers_every_compiled_pair():
    """Each bf16 pass has one design at every compiled pair, wgmma: the
    forward, the dq and the dk / dv pass each have a wgmma plan at every
    pair (the mma.sync designs are gone), and a pass that is none of the
    three has none."""
    for pair in TFA.HEAD_DIMS:
        for kernel in ("fwd", "dq", "dkv"):
            assert TFA.wgmma_plan(kernel, *pair)["design"] == "wgmma"
    with pytest.raises(ValueError, match="no wgmma kernel"):
        TFA.wgmma_plan("dx", 128, 128)


@pytest.mark.parametrize("pair,boxes", [
    ((128, 128), {"q": (64, 2), "k": (64, 2), "v": (64, 2)}),
    ((80, 80), {"q": (16, 5), "k": (16, 5), "v": (16, 5)}),
    ((96, 64), {"q": (32, 3), "k": (32, 3), "v": (64, 1)}),
    ((192, 128), {"q": (64, 3), "k": (64, 3), "v": (64, 2)})],
    ids=["128x128", "80x80", "96x64", "192x128"])
def test_wgmma_swizzle_and_boxes_per_operand(pair, boxes):
    """The swizzle each operand takes: the widest of 64, 32 and 16 columns
    dividing its width (128-, 64-, 32-byte swizzle), the width cut into
    boxes of it — an 80-column row five 16-column boxes of 32-byte
    swizzle, a 96-column one three of 64-byte — and the output stored as
    one unswizzled box of its whole width."""
    for kernel in ("fwd", "dq", "dkv"):
        ops = TFA.wgmma_plan(kernel, *pair)["operands"]
        for name, (w, n) in boxes.items():
            op = ops[{"v": "v", "q": "q", "k": "k"}[name]]
            assert (op["box"][0], op["boxes"]) == (w, n), (kernel, name)
            assert op["swizzle_bytes"] == 2 * w
    out = TFA.wgmma_plan("fwd", *pair)["operands"]["out"]
    assert out["box"] == (pair[1], 1, 64, 1) and out["swizzle_bytes"] == 0
