"""Port of the segmented-cummax kernel module
(repro_torch.kernels.segmented_cummax) against the reference package's
numpy reduction and its scalar event replay, on the CPU (where the wrapper
takes the plain version).  Integers throughout: tolerance 0."""

import numpy as np
import pytest
import torch

from repro.core import batch as RB
from repro.core import liveness as RLV
from repro_torch.core import batch as TB
from repro_torch.core import liveness as TLV
from repro_torch.kernels import segmented_cummax as TK


@pytest.mark.parametrize("n_events", range(1, 13))
def test_random_stacks(n_events):
    rng = np.random.default_rng(n_events)
    for n in (1, 7, 256, int(rng.integers(2, 1000)), 1000):
        d = rng.integers(-(1 << 40), 1 << 40, size=(n_events, n),
                         dtype=np.int64)
        want = np.cumsum(d, axis=0).max(axis=0)
        t = torch.from_numpy(d)
        got = TK.segmented_cummax(t)
        assert got.dtype == torch.int64 and tuple(got.shape) == (n,)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(TK.segmented_cummax_plain(t).numpy(), want)
        assert np.array_equal(RB.liveness_peak_batch(d), want)
        assert np.array_equal(TB.liveness_peak_batch(d), want)


def test_all_negative_deltas_peak_at_first_event():
    d = -np.arange(1, 41, dtype=np.int64).reshape(10, 4)
    assert np.array_equal(TK.segmented_cummax(torch.from_numpy(d)).numpy(),
                          d[0])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_semantic_parity_with_event_replay(kind):
    """On real-looking component values the reduction of the port's delta
    stack equals the reference's scalar ``liveness.replay(...).peak`` per
    cell — the check the reference never had for this kernel."""
    rng = np.random.default_rng(hash(kind) % 1000)
    n = 64
    comps = {name: rng.integers(0, 1 << 34, size=n, dtype=np.int64)
             for name in RLV.COMPONENTS}
    assert TLV.COMPONENTS == RLV.COMPONENTS
    prog = RLV.compile_program(kind)
    assert TLV.compile_program(kind).delta_matrix() == prog.delta_matrix()
    deltas = TB._liveness_deltas(kind, comps, n)
    assert np.array_equal(deltas, RB._liveness_deltas(kind, comps, n))
    got = TK.segmented_cummax(torch.from_numpy(deltas)).numpy()
    for i in range(n):
        values = {k: int(v[i]) for k, v in comps.items()}
        assert int(got[i]) == RLV.replay(prog, values).peak
        assert int(got[i]) == TLV.replay(TLV.compile_program(kind),
                                         values).peak


def test_wrapper_rejects_what_the_kernel_does_not_take():
    d = torch.zeros((3, 5), dtype=torch.int64)
    with pytest.raises(TypeError):
        TK.segmented_cummax(d.to(torch.int32))
    with pytest.raises(TypeError):
        TK.segmented_cummax(d.numpy())
    with pytest.raises(ValueError):
        TK.segmented_cummax(d[0])
    with pytest.raises(ValueError):
        TK.segmented_cummax(torch.zeros((0, 5), dtype=torch.int64))


def test_cpu_tensors_never_count_as_launches():
    before = TK.launches
    TK.segmented_cummax(torch.ones((2, 3), dtype=torch.int64))
    assert TK.launches == before


def test_use_backend_routes_and_restores():
    rng = np.random.default_rng(3)
    d = rng.integers(-99, 99, size=(10, 33), dtype=np.int64)
    assert TB._liveness_peak_impl is None
    with TK.use_backend("cpu"):
        assert TB._liveness_peak_impl is not None
        assert np.array_equal(TB.liveness_peak_batch(d),
                              np.cumsum(d, 0).max(0))
    assert TB._liveness_peak_impl is None
    with pytest.raises(RuntimeError):
        with TK.use_backend("cpu"):
            raise RuntimeError("boom")
    assert TB._liveness_peak_impl is None
