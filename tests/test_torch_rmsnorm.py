"""Port of the RMSNorm forward (repro_torch.kernels.rmsnorm) against the
reference package's Pallas kernel in interpret mode and its oracle, on the
CPU, where the wrapper takes the plain version.

Inputs are made with numpy from a seed.  Tolerances are the reference's
kernel tolerances (tests/test_kernels.py): 2e-5 in fp32 (the statistics
are fp32 on both sides; the reduction order differs) and 2e-2 in bf16
(one rounding of the output).  The kernel itself is held against the
plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ROPS
from repro.kernels import ref as RREF
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
