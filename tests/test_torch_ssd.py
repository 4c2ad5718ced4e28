"""The SSD scan of the port (``repro_torch.kernels.ssd``) against the
reference package, on the CPU: the plain version against the reference's
Pallas kernel in interpret mode (``repro.kernels.ops.ssd_scan``), its
sequential recurrence (``repro.kernels.ref.ssd_ref``) and its lax twin
(``repro.models.mamba.ssd_chunked``); the port's own ``ref.ssd_ref``
against the reference's; the wrapper's checks and the forward-only entry
point; a rounding model of the bf16 tensor-core kernel
(``ssd_scan_kernel_mma``) against the plain version, alone and inside the
reduced mamba2's prefill.  Inputs are made with numpy from a seed and
handed to both sides.

Tolerances: 1e-4 in fp32 (the reference's own, tests/test_kernels.py);
with bf16 x, B and C the y (rounded to bf16) within 2e-2 of its scale and
the fp32 state within 1e-4 of its scale.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as RO
from repro.kernels import ref as RR
from repro.models.mamba import ssd_chunked
from repro_torch.configs import get_config
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.kernels import ssd as SSD
from repro_torch.models import build_model

# (b, S, H, P, N, chunk): the reference's three kernel cases, a prompt
# shorter than the chunk, a ragged final chunk, and the full config's
# head dim / state width / chunk at a short length
CASES = [
    (2, 128, 4, 16, 32, 32),
    (1, 96, 2, 32, 16, 32),
    (1, 64, 1, 64, 64, 64),
    (2, 40, 3, 16, 16, 64),        # S < chunk
    (2, 75, 2, 16, 32, 32),        # ragged final chunk (75 = 2 x 32 + 11)
    (1, 300, 2, 64, 128, 256),     # P 64, N 128, chunk 256, ragged
]
TOL = 1e-4
BF16_TOL = 2e-2


def inputs(case, seed=0, dtype=np.float32, shift=0.0):
    """x, dt (post-softplus of N(0, 1) - shift), A (< 0), B, C as numpy
    arrays."""
    b, S, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P), np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H), np.float32)
                         - shift))
    A = -np.exp(rng.standard_normal(H).astype(np.float32) * 0.3)
    B = rng.standard_normal((b, S, N), np.float32) * 0.5
    C = rng.standard_normal((b, S, N), np.float32) * 0.5
    if dtype is not np.float32:
        x, B, C = (a.astype(dtype) for a in (x, B, C))
    return x, dt.astype(np.float32), A.astype(np.float32), B, C


def to_torch(a) -> torch.Tensor:
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def plain(case, arrs):
    return SSD.ssd_scan_plain(*map(to_torch, arrs), chunk=case[-1])


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_matches_reference_kernel_and_recurrence(case):
    arrs = inputs(case)
    y, st = plain(case, arrs)
    assert y.dtype == torch.float32 and tuple(y.shape) == case[:4]
    assert st.dtype == torch.float32 and tuple(st.shape) == \
        (case[0], case[2], case[3], case[4])
    jarrs = [jnp.asarray(a) for a in arrs]
    yk, stk = RO.ssd_scan(*jarrs, chunk=case[-1], interpret=True)
    yr, str_ = RR.ssd_ref(*jarrs)
    for want_y, want_st, what in ((yk, stk, "kernel"), (yr, str_, "ref")):
        np.testing.assert_allclose(f32(y), f32(want_y), atol=TOL, rtol=TOL,
                                   err_msg=f"y vs {what}")
        np.testing.assert_allclose(f32(st), f32(want_st), atol=TOL,
                                   rtol=TOL, err_msg=f"state vs {what}")


@pytest.mark.parametrize("case", CASES[:5],
                         ids=lambda c: "x".join(map(str, c)))
def test_plain_matches_the_lax_twin(case):
    x, dt, A, B, C = inputs(case, seed=1)
    y, st = plain(case, (x, dt, A, B, C))
    ym, stm = ssd_chunked(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
                          jnp.asarray(B)[:, :, None],
                          jnp.asarray(C)[:, :, None], chunk=case[-1])
    np.testing.assert_allclose(f32(y), f32(ym), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(f32(st), f32(stm), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", [CASES[0], CASES[4], CASES[5]],
                         ids=lambda c: "x".join(map(str, c)))
def test_plain_matches_reference_kernel_in_bf16(case):
    arrs = inputs(case, seed=2, dtype=jnp.bfloat16)
    y, st = plain(case, arrs)
    assert y.dtype == torch.bfloat16
    yk, stk = RO.ssd_scan(*[jnp.asarray(a) for a in arrs], chunk=case[-1],
                          interpret=True)
    assert yk.dtype == jnp.bfloat16
    y_scale = max(1.0, float(np.abs(f32(yk)).max()))
    st_scale = max(1.0, float(np.abs(f32(stk)).max()))
    assert np.abs(f32(y) - f32(yk)).max() <= BF16_TOL * y_scale
    assert np.abs(f32(st) - f32(stk)).max() <= TOL * st_scale


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["float32", "bfloat16"])
def test_port_oracle_matches_reference_oracle(dtype):
    case = CASES[4]
    arrs = inputs(case, seed=3, dtype=dtype)
    y, st = TR.ssd_ref(*map(to_torch, arrs))
    yr, str_ = RR.ssd_ref(*[jnp.asarray(a) for a in arrs])
    assert str(y.dtype).split(".")[-1] == yr.dtype.name
    tol = TOL if dtype is np.float32 else BF16_TOL
    np.testing.assert_allclose(f32(y), f32(yr), atol=tol, rtol=tol)
    np.testing.assert_allclose(f32(st), f32(str_), atol=TOL, rtol=TOL)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    case = CASES[1]
    arrs = [to_torch(a) for a in inputs(case, seed=4)]
    before = SSD.launches
    y, st = SSD.ssd_scan(*arrs, chunk=case[-1])
    yp, stp = SSD.ssd_scan_plain(*arrs, chunk=case[-1])
    assert torch.equal(y, yp) and torch.equal(st, stp)
    assert SSD.launches == before            # nothing launched on the host
    # chunk larger than S is cut to S
    y2, st2 = SSD.ssd_scan(*arrs, chunk=10 ** 6)
    y3, st3 = SSD.ssd_scan_plain(*arrs, chunk=case[1])
    assert torch.equal(y2, y3) and torch.equal(st2, st3)


def test_wrapper_refuses_what_it_does_not_take():
    x, dt, A, B, C = (to_torch(a) for a in inputs(CASES[1], seed=5))
    bad = [
        dict(x=x[0]),                                   # not 4-D
        dict(dt=dt[:, :-1]),                            # dt shape
        dict(A=A[:1]),                                  # A shape
        dict(B=B[..., :-1]),                            # B / C disagree
        dict(dt=dt.double()),                           # dt type
        dict(A=A.bfloat16()),                           # A type
        dict(x=x.half(), B=B.half(), C=C.half()),       # fp16
        dict(B=B.bfloat16()),                           # x / B types differ
        dict(chunk=0),
        dict(chunk=2.0),
        dict(x=x[:, :0], dt=dt[:, :0], B=B[:, :0], C=C[:, :0]),   # S = 0
        dict(x=x.to("meta"), dt=dt.to("meta"), A=A.to("meta"),
             B=B.to("meta"), C=C.to("meta")),           # neither cpu nor cuda
    ]
    for kw in bad:
        args = dict(x=x, dt=dt, A=A, B=B, C=C, chunk=32)
        args.update(kw)
        with pytest.raises((TypeError, ValueError)):
            SSD.ssd_scan(**args)
    with pytest.raises(TypeError):
        SSD.ssd_scan(x.numpy(), dt, A, B, C)


def test_kernel_operand_checks():
    """The layout and size limits the CUDA kernel takes, checked on host
    tensors: views with a token stride are taken, a strided head dim, an
    odd state width, an untaken head dim or too much shared memory are
    not."""
    b, S, H, P, N = 2, 40, 4, 64, 128
    conv = torch.zeros((b, S, H * P + 2 * N))       # the conv output
    x = conv[..., :H * P].reshape(b, S, H, P)       # a view, token stride
    B, C = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    dt, A = torch.ones((b, S, H)), -torch.ones(H)
    need = SSD.check_kernel_operands(x, dt, A, B, C, 40)
    assert need == SSD.smem_bytes(P, N, 40) <= SSD.MAX_SMEM
    # the full config: P 64, N 128, chunk 256
    assert SSD.smem_bytes(64, 128, 256) == 137216
    for args in ((x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B,
                  C),
                 (x, dt.transpose(0, 1).contiguous().transpose(0, 1), A, B,
                  C),
                 (x[..., :48], dt, A, B, C),
                 (x, dt, A, B[..., :-2], C[..., :-2])):
        with pytest.raises(ValueError):
            SSD.check_kernel_operands(*args, 40)
    with pytest.raises(ValueError, match="shared memory"):
        SSD.check_kernel_operands(x, dt, A, B, C, 40000)


def test_entry_point_is_forward_only():
    x, dt, A, B, C = (to_torch(a) for a in inputs(CASES[1], seed=6))
    y, st = TO.ssd_scan(x, dt, A, B, C, chunk=32)
    assert torch.equal(y, SSD.ssd_scan_plain(x, dt, A, B, C, 32)[0])
    for leaf in range(5):
        args = [t.clone() for t in (x, dt, A, B, C)]
        args[leaf].requires_grad_()
        with pytest.raises(NotImplementedError, match="forward only"):
            TO.ssd_scan(*args, chunk=32)
        with torch.no_grad():                       # no gradient asked
            TO.ssd_scan(*args, chunk=32)


def test_forward_only_refusal_names_the_training_path():
    """The refusal names the path that runs under autograd: the chunked
    SSD in plain ops (``models/mamba.ssd_chunked``), which SSM training
    takes."""
    x, dt, A, B, C = (to_torch(a) for a in inputs(CASES[1], seed=6))
    with pytest.raises(NotImplementedError,
                       match=r"models/mamba\.ssd_chunked") as err:
        TO.ssd_scan(x.requires_grad_(), dt, A, B, C, chunk=32)
    assert "not ported" not in str(err.value)


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernel's roundings (ssd_scan_kernel_mma)
# ---------------------------------------------------------------------------

def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _split_bf16(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel carries it into a product: hi = bf16(t) plus lo =
    bf16(t - hi), each an exact bf16 operand."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def tensor_core_ssd_model(x, dt, A, B, C, chunk, split_state=True):
    """A rounding model of ``ssd_scan_kernel_mma`` in plain torch: the
    kernel's chunks and 64-row sub-tiles, every product of bf16 operands
    summed in fp32; x, B and C go in exact; per query sub-tile i, ``C_i
    bf16(state)^T`` scaled by exp(a_cum_i), then for each key sub-tile j
    <= i ``bf16((L o C_i B_j^T) dt_j) x_j``; one rounding of y; the state
    update ``(x w)^T B`` with w = dt exp(a_tot - a_cum), ``x w`` split into
    two bf16 parts (what the kernel does) or, without ``split_state``,
    rounded to bf16 once."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    chunk = min(chunk, S)
    xf, Bf, Cf = x.float(), B.float(), C.float()
    a = dt * A
    st = torch.zeros((b, H, P, N))
    y = torch.empty((b, S, H, P))
    sub = SSD.TQ
    for c0 in range(0, S, chunk):
        q = min(chunk, S - c0)
        acum = a[:, c0:c0 + q].cumsum(1)                 # (b, q, H)
        a_tot = acum[:, -1]
        st_op = _bf16(st)
        for i0 in range(0, q, sub):
            qi = min(sub, q - i0)
            Ci, ai = Cf[:, c0 + i0:c0 + i0 + qi], acum[:, i0:i0 + qi]
            yi = torch.einsum("bin,bhpn->bihp", Ci, st_op) * \
                torch.exp(ai)[..., None]
            for j0 in range(0, i0 + 1, sub):
                qj = min(sub, q - j0)
                rj = slice(c0 + j0, c0 + j0 + qj)
                s = torch.einsum("bin,bjn->bij", Ci, Bf[:, rj])
                seg = ai[:, :, None] - acum[:, None, j0:j0 + qj]
                keep = (i0 + torch.arange(qi))[:, None] >= \
                    (j0 + torch.arange(qj))[None, :]
                L = torch.exp(seg.masked_fill(~keep[None, :, :, None],
                                              float("-inf")))
                p = _bf16(L * s[..., None] * dt[:, None, rj])
                yi = yi + torch.einsum("bijh,bjhp->bihp", p, xf[:, rj])
            y[:, c0 + i0:c0 + i0 + qi] = yi
        w = dt[:, c0:c0 + q] * torch.exp(a_tot[:, None] - acum)
        xw = xf[:, c0:c0 + q] * w[..., None]
        xw = _split_bf16(xw) if split_state else _bf16(xw)
        st = st * torch.exp(a_tot)[..., None, None] + torch.einsum(
            "bqhp,bqn->bhpn", xw, Bf[:, c0:c0 + q])
    return y.to(x.dtype), st


# the cases above, mamba2-1.3b's serving width at batch 1 (its dt as
# chip_smoke.py draws it there: softplus(N(0, 1) - 3)), and a state width
# that is not a multiple of 16 (the kernel pads it) at head dim 128
SERVE_B1 = (1, 2000, 64, 64, 128, 256)
TENSOR_CORE_CASES = CASES + [SERVE_B1, (2, 75, 3, 128, 20, 32)]


def _tc_readings(case, split_state):
    """(y's and the state's max |model - plain| over their scales)."""
    shift = 3.0 if case == SERVE_B1 else 0.0
    args = [to_torch(a) for a in inputs(case, seed=7, dtype=jnp.bfloat16,
                                        shift=shift)]
    y, st = tensor_core_ssd_model(*args, chunk=case[-1],
                                  split_state=split_state)
    py, pst = SSD.ssd_scan_plain(*args, chunk=case[-1])
    assert y.dtype == torch.bfloat16 and y.shape == py.shape
    assert st.dtype == torch.float32 and st.shape == pst.shape
    return (float((y.float() - py.float()).abs().max()
                  / py.float().abs().max()),
            float((st - pst).abs().max() / pst.abs().max()))


@pytest.mark.parametrize("case", TENSOR_CORE_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_tensor_core_roundings_fit_the_bf16_tolerance(case):
    """The kernel's roundings, with the state update's x w split in two
    bf16 parts, keep y within 2e-2 and the state within 1e-4 of their
    scales (max |plain|) of the plain version: the gates chip_smoke.py
    holds the kernel to on the card."""
    y_err, st_err = _tc_readings(case, split_state=True)
    assert y_err <= BF16_TOL, y_err
    assert st_err <= TOL, st_err


@pytest.mark.parametrize("case", TENSOR_CORE_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_one_rounding_of_the_state_update_misses_the_state_gate(case):
    """Why the kernel splits x w: rounded to bf16 once, the state lands
    more than 1e-4 of its scale from the plain version (2^-9 per term)."""
    _, st_err = _tc_readings(case, split_state=False)
    assert st_err > TOL, st_err


def _mamba_prefill(model, params, tokens):
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": tokens})
    return logits[:, -1].float(), cache["blocks"]["ssm"].float()


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def reduced_mamba2_prefill_spread(split_state=True) -> dict:
    """The reduced mamba2's bf16 prefill (2 layers, 2 x 100 tokens = 3
    chunks of 32 and a ragged 4) with the SSD through the rounding model
    and through the plain version, each against the fp32 plain prefill
    (weights cast): ``{"logits" / "states": (model's distance, plain's
    distance)}``, max |diff| over max(1, max |fp32|), last logits and final
    states."""
    cfg = get_config("mamba2-1.3b").reduced()
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(20260811)
    params = model.init(gen, "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 100), generator=gen,
                           dtype=torch.int32)
    plain = _mamba_prefill(model, params, tokens)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(TO, "ssd_scan",
                  lambda x, dt, A, B, C, chunk=256: tensor_core_ssd_model(
                      x, dt, A, B, C, chunk, split_state))
        kernels = _mamba_prefill(model, params, tokens)
    fp32 = _mamba_prefill(build_model(dataclasses.replace(
        cfg, dtype="float32")), copy.deepcopy(params).float(), tokens)
    assert not any(torch.equal(k, p) for k, p in zip(kernels, plain))
    return {what: (_rel(k, f), _rel(p, f)) for what, k, p, f in
            zip(("logits", "states"), kernels, plain, fp32)}


def test_tensor_core_roundings_keep_the_reduced_mamba2_prefill():
    """The slice as a whole: the reduced mamba2's bf16 prefill with the SSD
    through the rounding model is no further from the fp32 plain prefill
    than 1.5x the bf16 plain prefill is, in the last logits and the final
    states: the gate chip_smoke.py holds the full-size prefill to."""
    for what, (got, plain) in reduced_mamba2_prefill_spread().items():
        assert got <= 1.5 * plain, f"{what}: {got:.4g} vs plain {plain:.4g}"


def test_bf16_kernel_operand_checks():
    """The tensor-core kernel copies x in 16-byte and B, C in 8-byte
    pieces: bf16 operands off those grids are refused before any launch
    (fp32 ones, for the FMA kernel, are not); a state width that is not a
    multiple of 16 is taken (padded in shared memory); the serving config
    needs at most 113 KB, so two blocks share an SM."""
    b, S, H, P, N = 2, 40, 2, 64, 20
    base = torch.zeros(b * S * H * P + 8, dtype=torch.bfloat16)
    x = base[8:].view(b, S, H, P)
    x_odd = base[1:1 + b * S * H * P].view(b, S, H, P)
    bc = torch.zeros(b * S * N + 4, dtype=torch.bfloat16)
    B, B_odd = bc[4:].view(b, S, N), bc[1:1 + b * S * N].view(b, S, N)
    dt, A = torch.ones((b, S, H)), -torch.ones(H)
    assert x_odd.is_contiguous() and x_odd.data_ptr() % 16
    need = SSD.check_kernel_operands(x, dt, A, B, B, 32)
    assert need == SSD.mma_smem_bytes(P, N, 32)
    for args in ((x_odd, dt, A, B, B), (x, dt, A, B_odd, B),
                 (x, dt, A, B, B_odd)):
        with pytest.raises(ValueError, match="grid"):
            SSD.check_kernel_operands(*args, 32)
    # a token stride off the grid: x (b, S, H, P) inside rows of H P + 4
    wide = torch.zeros((b, S, H * P + 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="grid"):
        SSD.check_kernel_operands(wide[..., :H * P].view(b, S, H, P), dt, A,
                                  B, B, 32)
    SSD.check_kernel_operands(x_odd.float(), dt, A, B_odd.float(),
                              B_odd.float(), 32)
    assert SSD.mma_smem_bytes(64, 128, 256) == 109584 <= 113 * 1024
    assert SSD.mma_smem_bytes(64, 20, 256) == SSD.mma_smem_bytes(64, 32, 256)
    with pytest.raises(ValueError, match="shared memory"):
        SSD.check_kernel_operands(x, dt, A, B, B, 30000)
