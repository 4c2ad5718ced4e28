"""The SSD scan of the port (``repro_torch.kernels.ssd``) against the
reference package, on the CPU: the plain version against the reference's
Pallas kernel in interpret mode (``repro.kernels.ops.ssd_scan``), its
sequential recurrence (``repro.kernels.ref.ssd_ref``) and its lax twin
(``repro.models.mamba.ssd_chunked``); the port's own ``ref.ssd_ref``
against the reference's; the wrapper's checks and the forward-only entry
point.  Inputs are made with numpy from a seed and handed to both sides.

Tolerances: 1e-4 in fp32 (the reference's own, tests/test_kernels.py);
with bf16 x, B and C the y (rounded to bf16) within 2e-2 of its scale and
the fp32 state within 1e-4 of its scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as RO
from repro.kernels import ref as RR
from repro.models.mamba import ssd_chunked
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.kernels import ssd as SSD

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


def inputs(case, seed=0, dtype=np.float32):
    """x, dt (post-softplus), A (< 0), B, C as numpy arrays."""
    b, S, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P), np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H), np.float32)))
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
