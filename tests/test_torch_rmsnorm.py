"""Port of the RMSNorm forward and backward (repro_torch.kernels.rmsnorm
and the autograd Function of ``kernels.ops``) against the reference
package's Pallas kernels in interpret mode and its oracle, on the CPU,
where the wrappers take the plain versions.

Inputs are made with numpy from a seed.  Tolerances are the reference's
kernel tolerances (tests/test_kernels.py): 2e-5 in fp32 forward and 1e-4
for the gradients (the statistics are fp32 on both sides; the reduction
order differs, and dscale sums over every row) and 2e-2 in bf16 (one
rounding of each output).  The kernels themselves are held against the
plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ROPS
from repro.kernels import ref as RREF
from repro.kernels.rmsnorm import rmsnorm_bwd as pallas_rmsnorm_bwd
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import rmsnorm as TRN

# the shapes of tests/test_kernels.py, plus a d_model-wide row and a
# Qwen3 q-norm-shaped (B, S, H, head_dim) tensor
SHAPES = [(64, 128), (3, 50, 96), (2, 7, 33, 64), (3, 4096), (2, 5, 8, 128)]
DTYPES = {"float32": (np.float32, 2e-5), "bfloat16": (jnp.bfloat16, 2e-2)}


def to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def make(shape, np_dtype, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, np.float32).astype(np_dtype)
    s = rng.standard_normal(shape[-1:], np.float32).astype(np_dtype)
    return x, s


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_pallas_kernel_and_oracle(shape, dtype):
    np_dtype, tol = DTYPES[dtype]
    x, s = make(shape, np_dtype)
    got = TRN.rmsnorm_fwd_plain(to_torch(x), to_torch(s), 1e-5)
    assert got.dtype == to_torch(x).dtype and tuple(got.shape) == shape
    kernel = ROPS.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-5, True)
    oracle = RREF.rmsnorm_ref(jnp.asarray(x), jnp.asarray(s))
    for want in (kernel, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    mine = TREF.rmsnorm_ref(to_torch(x), to_torch(s))
    np.testing.assert_allclose(mine.float().numpy(),
                               np.asarray(oracle, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("eps", [1e-5, 1e-6, 0.5])
def test_wrapper_takes_plain_version_on_cpu(eps):
    x, s = make((4, 3, 96), np.float32, seed=9)
    before = TRN.launches
    got = TRN.rmsnorm_fwd(to_torch(x), to_torch(s), eps)
    want = TRN.rmsnorm_fwd_plain(to_torch(x), to_torch(s), eps)
    assert torch.equal(got, want) and TRN.launches == before
    assert torch.equal(TOPS.rmsnorm(to_torch(x), to_torch(s), eps), want)
    oracle = ROPS.rmsnorm(jnp.asarray(x), jnp.asarray(s), eps, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=2e-5,
                               rtol=2e-5)


def _bad_calls():
    x = torch.zeros(4, 16)
    s = torch.ones(16)
    yield "float16", lambda: TRN.rmsnorm_fwd(x.half(), s.half())
    yield "mixed types", lambda: TRN.rmsnorm_fwd(x, s.bfloat16())
    yield "scale width", lambda: TRN.rmsnorm_fwd(x, torch.ones(15))
    yield "2-D scale", lambda: TRN.rmsnorm_fwd(x, torch.ones(1, 16))
    yield "scalar x", lambda: TRN.rmsnorm_fwd(torch.tensor(1.0), s[:1])
    yield "numpy x", lambda: TRN.rmsnorm_fwd(np.zeros((4, 16)), s)
    yield "meta device", lambda: TRN.rmsnorm_fwd(x.to("meta"), s.to("meta"))


@pytest.mark.parametrize("name,call", list(_bad_calls()),
                         ids=[n for n, _ in _bad_calls()])
def test_wrapper_refuses_what_the_kernel_does_not_take(name, call):
    with pytest.raises((TypeError, ValueError)):
        call()


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

BWD_DTYPES = {"float32": (np.float32, 1e-4), "bfloat16": (jnp.bfloat16, 2e-2)}


@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("dtype", list(BWD_DTYPES))
def test_bwd_plain_matches_pallas_kernel(shape, dtype):
    np_dtype, tol = BWD_DTYPES[dtype]
    x, s = make(shape, np_dtype)
    dy = np.random.default_rng(6).standard_normal(shape, np.float32) \
        .astype(np_dtype)
    dx, dscale = TRN.rmsnorm_bwd_plain(to_torch(x), to_torch(s),
                                       to_torch(dy), 1e-5)
    assert dx.dtype == to_torch(x).dtype and tuple(dx.shape) == shape
    assert dscale.dtype == to_torch(s).dtype and tuple(dscale.shape) == \
        shape[-1:]
    want_dx, want_ds = pallas_rmsnorm_bwd(jnp.asarray(x), jnp.asarray(s),
                                          jnp.asarray(dy), eps=1e-5,
                                          interpret=True)
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(want_dx, np.float32),
                               atol=tol, rtol=tol)
    # dscale sums over every row: its scale is the rows' count
    ds_tol = tol * max(1.0, float(np.abs(np.asarray(want_ds,
                                                    np.float32)).max()))
    np.testing.assert_allclose(dscale.float().numpy(),
                               np.asarray(want_ds, np.float32),
                               atol=ds_tol, rtol=tol)


@pytest.mark.parametrize("rows", [1, 7, 511, 512, 513, 1500, 4096])
def test_dscale_from_partial_rows_equals_one_pass_sum(rows):
    per, n = TRN.bwd_partition(rows)
    assert n <= TRN.BWD_BLOCKS and per * n >= rows > per * (n - 1)
    x, s = make((rows, 64), np.float32, seed=rows)
    dy = np.random.default_rng(rows + 1).standard_normal((rows, 64),
                                                         np.float32)
    tx, ts, tdy = to_torch(x), to_torch(s), to_torch(dy)
    _, dscale = TRN.rmsnorm_bwd_plain(tx, ts, tdy, 1e-5)
    xhat = tx * torch.rsqrt((tx * tx).mean(-1, keepdim=True) + 1e-5)
    one_pass = (tdy * xhat).sum(0)
    np.testing.assert_allclose(dscale.numpy(), one_pass.numpy(),
                               atol=1e-5 * np.sqrt(rows), rtol=1e-5)


@pytest.mark.parametrize("scale_trains", [True, False])
def test_ops_autograd_on_cpu_is_the_plain_backward(scale_trains):
    x, s = make((4, 3, 96), np.float32, seed=9)
    dy = np.random.default_rng(10).standard_normal((4, 3, 96), np.float32)
    tx = to_torch(x).requires_grad_()
    ts = to_torch(s).requires_grad_(scale_trains)
    before = (TRN.launches, TRN.bwd_launches)
    y = TOPS.rmsnorm(tx, ts, 1e-5)
    y.backward(to_torch(dy))
    want_dx, want_ds = TRN.rmsnorm_bwd_plain(to_torch(x), to_torch(s),
                                             to_torch(dy), 1e-5)
    assert torch.equal(tx.grad, want_dx)
    if scale_trains:
        assert torch.equal(ts.grad, want_ds)
    else:
        assert ts.grad is None
    assert (TRN.launches, TRN.bwd_launches) == before
    got = TRN.rmsnorm_bwd(to_torch(x), to_torch(s), to_torch(dy), 1e-5)
    assert torch.equal(got[0], want_dx) and torch.equal(got[1], want_ds)
    # the Function's gradients against jax.grad of the reference's
    # custom_vjp over its Pallas kernels (interpret mode)
    gx, gs = jax.grad(lambda x, s: (ROPS.rmsnorm(x, s, 1e-5, True)
                                    * jnp.asarray(dy)).sum(),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(want_ds.numpy(), np.asarray(gs), atol=1e-4,
                               rtol=1e-4)


def _bad_bwd_calls():
    x = torch.zeros(4, 16)
    s = torch.ones(16)
    bwd = TRN.rmsnorm_bwd
    yield "float16", lambda: bwd(x.half(), s.half(), x.half())
    yield "dy type", lambda: bwd(x, s, x.bfloat16())
    yield "dy shape", lambda: bwd(x, s, x[:3])
    yield "scale width", lambda: bwd(x, torch.ones(15), x)
    yield "numpy dy", lambda: bwd(x, s, x.numpy())
    yield "meta device", lambda: bwd(x.to("meta"), s.to("meta"),
                                     x.to("meta"))


@pytest.mark.parametrize("name,call", list(_bad_bwd_calls()),
                         ids=[n for n, _ in _bad_bwd_calls()])
def test_bwd_wrapper_refuses_what_the_kernel_does_not_take(name, call):
    with pytest.raises((TypeError, ValueError)):
        call()
