"""The shapes the port's kernels take beyond their compiled instances,
against the reference package's Pallas kernels in interpret mode, on the
CPU.

On the card the wrappers run a shape the kernels are not compiled for as
a padded or cut problem: flash attention zero-padded to
``instance_for``'s pair with the true ``D ** -0.5`` as an explicit scale,
the SSD as ``kernel_plan``'s P slabs and N pieces over
``kernel_operands``' padded operands, the RMSNorm backward at any D over
the same partial rows.  Here that exact problem goes through the plain
versions and is held to the Pallas kernels at the unpadded inputs, made
with numpy from a seed.  Tolerances are tests/test_kernels.py's: 2e-5 in
fp32 and 2e-2 in bf16 forward, 5e-4 for the attention gradients (2e-2 of
the tensor's scale in bf16), 1e-4 for the SSD and the RMSNorm gradients.
The kernels themselves are held to the plain versions at these shapes on
the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as RO
from repro.kernels.flash_attention import flash_bwd as pallas_flash_bwd
from repro.kernels.flash_attention import flash_fwd as pallas_flash_fwd
from repro.kernels.rmsnorm import rmsnorm_bwd as pallas_rmsnorm_bwd
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import rmsnorm as TRN
from repro_torch.kernels import ssd as SSD

MAX_SMEM = 232448


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


# ---------------------------------------------------------------------------
# flash attention: the instance a pair runs on
# ---------------------------------------------------------------------------


def test_instance_for_covers_every_pair_up_to_256():
    """Every 1 <= D, Dv <= 256 reaches a compiled pair that dominates it,
    no dominating pair has fewer columns, a compiled pair is its own, and
    every instance's tensor-core kernels fit the H100's shared-memory
    opt-in; past 256 the pair is refused."""
    pairs = set(TFA.HEAD_DIMS)
    for D in range(1, 257):
        for Dv in range(1, 257):
            Di, Dvi = TFA.instance_for(D, Dv)
            assert (Di, Dvi) in pairs and Di >= D and Dvi >= Dv
            assert all(p[0] + p[1] >= Di + Dvi for p in pairs
                       if p[0] >= D and p[1] >= Dv)
    for pair in pairs:
        assert TFA.instance_for(*pair) == pair
        for kernel in ("fwd", "dq", "dkv"):
            assert TFA.wgmma_plan(kernel, *pair)["smem_bytes"] <= MAX_SMEM
    assert TFA.instance_for(24, 16) == (32, 32)
    assert TFA.instance_for(256, 128) == (256, 256)
    for bad in ((257, 16), (16, 257), (0, 16), (16, 0)):
        with pytest.raises(ValueError, match="256"):
            TFA.instance_for(*bad)


# every compiled wgmma instance, per pass
WGMMA_INSTANCES = [(kernel, pair) for kernel in ("fwd", "dq", "dkv")
                   for pair in TFA.HEAD_DIMS]


@pytest.mark.parametrize("kernel,pair", WGMMA_INSTANCES,
                         ids=[f"{k}-{d}x{dv}" for k, (d, dv) in
                              WGMMA_INSTANCES])
def test_wgmma_plan_obeys_the_hardware_rules(kernel, pair):
    """The plan of each wgmma instance keeps Hopper's rules: every product
    a 64-row warpgroup tile (two consumer warpgroups cover the block's
    128 rows) with N a multiple of 8 in [8, 256] and K in steps of 16;
    every TMA box at most 256 a dim, its inner extent a multiple of 16
    bytes and, swizzled, exactly the swizzle span (so one descriptor
    layout serves the operand), the boxes tiling the operand's columns
    and each a whole number of 1,024-byte swizzle atoms (their starts
    stay aligned); the shared memory within the 232,448-byte opt-in; the
    registers setmaxnreg moves within the SM's 65,536, and the consumer's
    live accumulators and register operands leaving 32 for the rest."""
    plan = TFA.wgmma_plan(kernel, *pair)
    assert plan["tile"][0] == 2 * 64 and plan["threads"] == 3 * 128
    for name, m, n, k, a_from, b_major in plan["products"]:
        assert m == 64, name
        assert n % 8 == 0 and 8 <= n <= 256, (name, n)
        assert k % 16 == 0 and k >= 16, (name, k)
        assert a_from in ("smem", "registers") and b_major in ("K", "MN")
    for name, op in plan["operands"].items():
        box = op["box"]
        assert all(1 <= d <= 256 for d in box), (name, box)
        assert (2 * box[0]) % 16 == 0, (name, box)
        assert op["boxes"] * box[0] == op["cols"], (name, op)
        if op["swizzle_bytes"]:
            assert 2 * box[0] == op["swizzle_bytes"] in (32, 64, 128), name
            assert (2 * box[0] * box[2]) % 1024 == 0, (name, box)
    assert plan["smem_bytes"] <= MAX_SMEM
    regs = plan["registers"]
    assert 128 * regs["producer"] + 256 * regs["consumer"] <= 65536
    assert all(r % 8 == 0 and 24 <= r <= 256 for r in regs.values())
    assert plan["live_registers"] + 32 <= regs["consumer"]


# (B, Sq, Skv, H, Hkv, D, Dv, causal): the reduced MLA archs' pair (qk 16 +
# rope 8, v 16), a pair off the 16-byte grid in bf16, and a pair between
# two instances, with GQA, causal as a continuation and not
PAD_CASES = [
    (1, 40, 40, 4, 2, 24, 16, True),
    (2, 33, 57, 2, 1, 20, 12, True),
    (1, 48, 48, 4, 2, 112, 112, False),
]
FWD_DTYPES = {"float32": (np.float32, 2e-5),
              "bfloat16": (jnp.bfloat16, 2e-2)}


def make_attention(case, np_dtype, seed=17):
    B, Sq, Skv, H, Hkv, D, Dv, causal = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D), np.float32).astype(np_dtype)
    k = rng.standard_normal((B, Skv, Hkv, D), np.float32).astype(np_dtype)
    v = rng.standard_normal((B, Skv, Hkv, Dv), np.float32).astype(np_dtype)
    do = rng.standard_normal((B, Sq, H, Dv), np.float32).astype(np_dtype)
    return q, k, v, do, (Skv - Sq if causal else 0)


def ids(case) -> str:
    return "x".join(str(int(c)) for c in case)


@pytest.mark.parametrize("case", PAD_CASES, ids=ids)
@pytest.mark.parametrize("dtype", list(FWD_DTYPES))
def test_padded_forward_matches_pallas_kernel(case, dtype):
    np_dtype, tol = FWD_DTYPES[dtype]
    causal = case[7]
    q, k, v, _, qoff = make_attention(case, np_dtype)
    qp, kp, vp, scale = TFA.pad_operands(*map(to_torch, (q, k, v)))
    assert (qp.shape[3], vp.shape[3]) == TFA.instance_for(case[5], case[6])
    assert scale == case[5] ** -0.5
    out_p, lse = TFA.flash_fwd_plain(qp, kp, vp, causal=causal,
                                     q_offset=qoff, scale=scale)
    # the instance's extra output columns are zero, and dropped
    assert out_p[..., case[6]:].float().abs().sum() == 0
    out = out_p[..., :case[6]]
    want_out, want_lse = pallas_flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=128, block_k=128, q_offset=qoff, interpret=True)
    np.testing.assert_allclose(f32(out), f32(want_out), atol=tol, rtol=tol)
    np.testing.assert_allclose(f32(lse), f32(want_lse), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("case", PAD_CASES, ids=ids)
@pytest.mark.parametrize("dtype", list(FWD_DTYPES))
def test_padded_backward_matches_pallas_kernel(case, dtype):
    np_dtype, _ = FWD_DTYPES[dtype]
    causal, D, Dv = case[7], case[5], case[6]
    q, k, v, do, qoff = make_attention(case, np_dtype, seed=19)
    tq, tk, tv, tdo = map(to_torch, (q, k, v, do))
    out, lse = TFA.flash_fwd_plain(tq, tk, tv, causal=causal, q_offset=qoff)
    qp, kp, vp, outp, dop, scale = TFA.pad_operands(tq, tk, tv, out, tdo)
    dq_p, dk_p, dv_p = TFA.flash_bwd_plain(qp, kp, vp, outp, lse, dop,
                                           causal=causal, q_offset=qoff,
                                           scale=scale)
    for g, w in ((dq_p, D), (dk_p, D), (dv_p, Dv)):
        assert g[..., w:].float().abs().sum() == 0
    got = (dq_p[..., :D], dk_p[..., :D], dv_p[..., :Dv])
    want = pallas_flash_bwd(*map(jnp.asarray, (q, k, v, to_np(out),
                                               lse.numpy(), do)),
                            causal=causal, block_q=128, block_k=128,
                            q_offset=qoff, interpret=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = f32(w)
        if dtype == "float32":
            np.testing.assert_allclose(f32(g), w, atol=5e-4, rtol=5e-4,
                                       err_msg=name)
        else:
            tol = 2e-2 * max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(f32(g), w, atol=tol, rtol=0,
                                       err_msg=name)


def test_wrapper_scale_is_the_true_head_dim_on_cpu():
    """The scale is D ** -0.5 of the given q: the wrappers equal the plain
    versions at that explicit scale, and a scale passed to the plain
    version multiplies q."""
    q, k, v, do, _ = make_attention(PAD_CASES[0], np.float32, seed=3)
    tq, tk, tv, tdo = map(to_torch, (q, k, v, do))
    out, lse = TFA.flash_fwd(tq, tk, tv)
    want = TFA.flash_fwd_plain(tq, tk, tv, scale=24 ** -0.5)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    half = TFA.flash_fwd_plain(tq, tk, tv, scale=0.5)
    assert not torch.equal(half[0], out)
    assert torch.allclose(half[0], TFA.flash_fwd_plain(
        tq * 0.5 * 24 ** 0.5, tk, tv)[0], atol=1e-5, rtol=1e-5)
    g = TFA.flash_bwd(tq, tk, tv, out, lse, tdo)
    w = TFA.flash_bwd_plain(tq, tk, tv, out, lse, tdo, scale=24 ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(g, w))


# ---------------------------------------------------------------------------
# the SSD: P slabs, N pieces
# ---------------------------------------------------------------------------


def ssd_inputs(case, seed=0):
    b, S, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P), np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H), np.float32)))
    A = -np.exp(rng.standard_normal(H).astype(np.float32) * 0.3)
    B = rng.standard_normal((b, S, N), np.float32) * 0.5
    C = rng.standard_normal((b, S, N), np.float32) * 0.5
    return x, dt.astype(np.float32), A.astype(np.float32), B, C


def planned_plain(x, dt, A, B, C, chunk, plan):
    """The plan's launches, each through the plain version on its slab and
    piece of the padded operands: y summed over the pieces, each piece's
    state columns written -> y, state at the plan's widths."""
    xk, dtk, Ak, Bk, Ck = SSD.kernel_operands(x, dt, A, B, C, plan)
    b, S, H, _ = x.shape
    y = torch.zeros((b, S, H, plan.P))
    state = torch.zeros((b, H, plan.P, plan.N))
    for n0, nw in plan.pieces:
        for p0, w, count in plan.slabs:
            for s in range(count):
                cols = slice(p0 + s * w, p0 + (s + 1) * w)
                ys, sts = SSD.ssd_scan_plain(
                    xk[..., cols], dtk, Ak, Bk[..., n0:n0 + nw],
                    Ck[..., n0:n0 + nw], chunk)
                y[..., cols] += ys.float()
                state[:, :, cols, n0:n0 + nw] = sts
    return y, state


# (b, S, H, P, N, chunk): P and N off every instance (P padded to 32); a
# P cut into two slabs of different widths; a state cut into two pieces;
# and two slabs of one width in one launch
SSD_CASES = [
    (2, 40, 2, 24, 12, 16),
    (1, 50, 2, 80, 20, 32),
    (1, 40, 1, 16, 512, 32),
    (1, 36, 2, 256, 8, 16),
]


@pytest.mark.parametrize("case", SSD_CASES, ids=ids)
def test_planned_ssd_matches_pallas_kernel(case):
    b, S, H, P, N, chunk = case
    arrs = ssd_inputs(case, seed=P + N)
    plan = SSD.kernel_plan(P, N, torch.float32)
    y, state = planned_plain(*map(to_torch, arrs), chunk, plan)
    assert y[..., P:].abs().sum() == 0
    assert state[:, :, P:].abs().sum() == 0
    want_y, want_st = RO.ssd_scan(*map(jnp.asarray, arrs), chunk=chunk,
                                  interpret=True)
    np.testing.assert_allclose(f32(y[..., :P]), f32(want_y), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(f32(state[:, :, :P, :N]), f32(want_st),
                               atol=1e-4, rtol=1e-4)


def test_ssd_plans():
    """The launches each shape gets: a compiled (P, N) that fits keeps its
    one launch (mamba2's and zamba2's heads, both types); the odd shapes
    are padded and cut as the tests above run them; a state too wide for
    one launch is walked in pieces (N 512 in bf16, N 256 at P 64 in fp32
    narrows the slab instead); past P 256 or N 512 the plan is refused;
    the chunk limit is the planned instance's."""
    f32_, bf16 = torch.float32, torch.bfloat16
    for P, N in ((64, 128), (64, 64), (16, 16), (128, 20)):
        for dt in (f32_, bf16):
            assert SSD.kernel_plan(P, N, dt) == SSD.Plan(
                P, N, ((0, P, 1),), ((0, N),))
    assert SSD.kernel_plan(24, 12, f32_) == SSD.Plan(
        32, 12, ((0, 32, 1),), ((0, 12),))
    assert SSD.kernel_plan(80, 20, f32_).slabs == ((0, 64, 1), (64, 16, 1))
    assert SSD.kernel_plan(256, 128, bf16).slabs == ((0, 128, 2),)
    assert SSD.kernel_plan(256, 128, f32_).slabs == ((0, 128, 2),)
    assert SSD.kernel_plan(64, 256, f32_) == SSD.Plan(
        64, 256, ((0, 32, 2),), ((0, 256),))
    walk = SSD.kernel_plan(16, 512, bf16)
    assert walk.pieces == ((0, 256), (256, 256)) and walk.launches == 2
    assert SSD.kernel_plan(16, 512, f32_).pieces == ((0, 256), (256, 256))
    assert SSD.kernel_plan(3, 2, f32_) == SSD.Plan(
        16, 4, ((0, 16, 1),), ((0, 4),))
    for dt in (f32_, bf16):
        for P, N in ((256, 512), (200, 300), (1, 1)):
            plan = SSD.kernel_plan(P, N, dt)
            assert SSD.plan_smem(plan, SSD.PLAN_CHUNK, dt) <= MAX_SMEM
        for P, N in ((257, 16), (16, 513), (0, 16)):
            with pytest.raises(ValueError, match="256|512"):
                SSD.kernel_plan(P, N, dt)
    mamba = SSD.kernel_plan(64, 128, bf16)
    assert SSD.plan_smem(mamba, 7872, bf16) <= MAX_SMEM < \
        SSD.plan_smem(mamba, 7936, bf16)


def test_ssd_operands_are_copied_only_where_needed():
    """The model's in-place views stay views; a padded head, a padded
    state, a strided head dim and a bf16 view off the 16-byte grid become
    fresh tensors the launch takes."""
    b, S, H, P, N = 2, 40, 4, 64, 128
    conv = torch.zeros((b, S, H * P + 2 * N))
    x = conv[..., :H * P].reshape(b, S, H, P)
    B, C = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    dt, A = torch.ones((b, S, H)), -torch.ones(H)
    plan = SSD.kernel_plan(P, N, torch.float32)
    xk, dtk, Ak, Bk, Ck = SSD.kernel_operands(x, dt, A, B, C, plan)
    assert xk is x and Bk is B and Ck is C
    SSD.check_kernel_operands(xk[..., :64], dtk, Ak, Bk, Ck, 40)
    odd = torch.zeros(b * S * H * P + 1, dtype=torch.bfloat16)[1:] \
        .view(b, S, H, P)
    for xs in (x.transpose(2, 3).contiguous().transpose(2, 3),
               odd.float(), odd):
        Bs, Cs = (t.to(xs.dtype) for t in (B, C))
        got = SSD.kernel_operands(xs, dt, A, Bs, Cs,
                                  SSD.kernel_plan(P, N, xs.dtype))
        assert torch.equal(got[0].float(), xs.float())
        SSD.check_kernel_operands(got[0], *got[1:], 40)
    small = SSD.kernel_plan(24, 6, torch.float32)
    xk, _, _, Bk, Ck = SSD.kernel_operands(
        x[..., :24], dt, A, B[..., :6], C[..., :6], small)
    assert xk.shape[3] == 32 and Bk.shape[2] == Ck.shape[2] == 8


# ---------------------------------------------------------------------------
# RMSNorm backward above the shared-memory row
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_past_the_shared_memory_row(dtype):
    """D = 16,384 (past BWD_SMEM_D, where the kernel sums each block's
    partial dscale row in device memory over the same partial rows): the
    plain version against the Pallas kernel, 3 rows."""
    np_dtype, tol = {"float32": (np.float32, 1e-4),
                     "bfloat16": (jnp.bfloat16, 2e-2)}[dtype]
    D = 16384
    assert D > TRN.BWD_SMEM_D
    rng = np.random.default_rng(23)
    x, dy = (rng.standard_normal((3, D), np.float32).astype(np_dtype)
             for _ in range(2))
    s = rng.standard_normal(D, np.float32).astype(np_dtype)
    dx, dscale = TRN.rmsnorm_bwd(to_torch(x), to_torch(s), to_torch(dy),
                                 1e-5)
    want_dx, want_ds = pallas_rmsnorm_bwd(jnp.asarray(x), jnp.asarray(s),
                                          jnp.asarray(dy), eps=1e-5,
                                          interpret=True)
    np.testing.assert_allclose(f32(dx), f32(want_dx), atol=tol, rtol=tol)
    ds_tol = tol * max(1.0, float(np.abs(f32(want_ds)).max()))
    np.testing.assert_allclose(f32(dscale), f32(want_ds), atol=ds_tol,
                               rtol=tol)
