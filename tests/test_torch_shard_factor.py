"""Port of the shard-factor kernel module (repro_torch.kernels.shard_factor)
against the reference package, on the CPU (where the wrapper takes the
plain version).  Same numpy inputs go to both sides; every quantity is an
integer, so the tolerance is 0 (``np.array_equal`` on int64)."""

import numpy as np
import pytest
import torch

from repro import mesh_ctx as RM
from repro.core import batch as RB
from repro.kernels import shard_factor as RK
from repro_torch.core import batch as TB
from repro_torch.kernels import shard_factor as TK

MESH_AXES = ("data", "model", "expert", "context", "pipe")
LOGICAL = ("batch", "heads", "dmodel", "seq", "experts", "layers")


def random_program(rng, n_cells):
    """One randomized (dims, axes, sizes, rules, extra) instance with
    the reference's edge cases reachable: pipe in rules (never shards),
    the layers stack dim (excluded from the extra pass), multi-axis
    rules, size-1 (dead) axes, and dims with no rule at all."""
    rules = {}
    for name in LOGICAL:
        k = rng.integers(0, 3)
        rules[name] = tuple(
            rng.choice(MESH_AXES, size=k, replace=False)) if k else ()
    n_dims = int(rng.integers(1, 5))
    axes = tuple(rng.choice(LOGICAL + (None,)) for _ in range(n_dims))
    dims = [rng.choice([1, 2, 3, 4, 6, 8, 12, 16, 24, 64],
                       size=n_cells).astype(np.int64)
            for _ in range(n_dims)]
    sizes = {a: rng.choice([1, 1, 2, 4, 8], size=n_cells).astype(np.int64)
             for a in MESH_AXES}
    extra = tuple(rng.choice(MESH_AXES,
                             size=int(rng.integers(0, 3)),
                             replace=False))
    return dims, axes, sizes, rules, extra


@pytest.mark.parametrize("n_cells", [1, 17, 257, 1000])
def test_randomized_program_parity(n_cells):
    """Host-callable twin (plain version on the CPU) and the port's numpy
    path == the reference numpy path, over 25 random programs each."""
    rng = np.random.default_rng(20260808 + n_cells)
    for trial in range(25):
        dims, axes, sizes, rules, extra = random_program(rng, n_cells)
        ref = RB.batch_shard_factor(dims, axes, sizes, rules, extra)
        got = TK.shard_factor(dims, axes, sizes, rules, extra, device="cpu")
        host = TB.batch_shard_factor(dims, axes, sizes, rules, extra)
        msg = f"trial {trial}: {axes} rules={rules} extra={extra}"
        assert got.dtype == np.int64 and got.shape == ref.shape, msg
        assert np.array_equal(got, ref), msg
        assert np.array_equal(host, ref), msg


@pytest.mark.parametrize("seed", range(4))
def test_plain_version_matches_scalar_shard_factor(seed):
    """Per element, the packed program evaluated by the plain version ==
    the reference's scalar ``mesh_ctx.shard_factor`` — with EVERY mesh
    axis kept in the program (size-1 axes included, no live filter)."""
    rng = np.random.default_rng(seed)
    for _ in range(10):
        n = int(rng.integers(1, 40))
        dims, axes, sizes, rules, extra = random_program(rng, n)
        steps, names = TK.pack_program(axes, rules, extra,
                                       axis_names=MESH_AXES)
        if not steps:
            continue
        d = torch.from_numpy(np.stack(dims))
        s = torch.from_numpy(np.stack([sizes[a] for a in names]))
        got = TK.shard_factor_plain(d, s, steps).numpy()
        assert np.array_equal(TK.shard_factor_tensors(d, s, steps).numpy(),
                              got)
        for i in range(n):
            want = RM.shard_factor(
                [int(x[i]) for x in dims], axes,
                {a: int(v[i]) for a, v in sizes.items()}, rules, extra)
            assert int(got[i]) == want


@pytest.mark.parametrize("seed", range(3))
def test_pack_program_equals_reference(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(30):
        _, axes, sizes, rules, extra = random_program(rng, 3)
        live = [a for a, v in sizes.items() if np.any(v > 1)]
        assert TK.pack_program(axes, rules, extra, axis_names=live) \
            == RK.pack_program(axes, rules, extra, axis_names=live)
    assert TK.pack_program(("batch",), {"batch": ("data",)}, (), ()) \
        == ((), [])


def test_scalar_and_broadcast_inputs():
    """Int dims and mixed scalar/array sizes broadcast like the
    reference; an empty program returns ones of the broadcast shape."""
    dims = [8, np.array([4, 8, 16], dtype=np.int64)]
    axes = ("batch", "heads")
    rules = {"batch": ("data",), "heads": ("model",)}
    sizes = {"data": 2, "model": np.array([1, 2, 4], dtype=np.int64)}
    for extra in ((), ("data",), ("model", "data")):
        ref = RB.batch_shard_factor(dims, axes, sizes, rules, extra)
        got = TK.shard_factor(dims, axes, sizes, rules, extra, device="cpu")
        assert np.array_equal(got, ref)
    ones = TK.shard_factor([4, np.array([[2], [3]])], (None, None),
                           {"data": 2}, rules, (), device="cpu")
    assert ones.shape == (2, 1) and (ones == 1).all()
    col = TK.shard_factor([np.array([[8], [12]]), 4], axes,
                          {"data": np.array([2, 4, 1]), "model": 2},
                          rules, (), device="cpu")
    assert np.array_equal(col, RB.batch_shard_factor(
        [np.array([[8], [12]]), 4], axes,
        {"data": np.array([2, 4, 1]), "model": 2}, rules, ()))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    d = torch.ones((2, 5), dtype=torch.int64)
    with pytest.raises(TypeError):
        TK.shard_factor_tensors(d.to(torch.int32), d, [(0, 0, 0)])
    with pytest.raises(TypeError):
        TK.shard_factor_tensors(d.numpy(), d, [(0, 0, 0)])
    with pytest.raises(ValueError):
        TK.shard_factor_tensors(d[0], d, [(0, 0, 0)])
    with pytest.raises(ValueError):
        TK.shard_factor_tensors(d, d[:, :3], [(0, 0, 0)])
    with pytest.raises(ValueError):
        TK.shard_factor_tensors(d, d, [])
    with pytest.raises(ValueError):                 # dim id out of range
        TK.shard_factor_tensors(d, d, [(2, 0, 0)])
    with pytest.raises(ValueError):                 # flag out of range
        TK.shard_factor_tensors(d, d, [(0, 0, 3)])


def test_cpu_tensors_never_count_as_launches():
    before = TK.launches
    d = torch.full((1, 4), 8, dtype=torch.int64)
    s = torch.full((1, 4), 2, dtype=torch.int64)
    assert TK.shard_factor_tensors(d, s, [(0, 0, 0)]).tolist() == [2] * 4
    assert TK.launches == before


def test_use_backend_restores_impl():
    assert TB._shard_factor_impl is None
    with TK.use_backend("cpu"):
        assert TB._shard_factor_impl is not None
        dims, axes, sizes, rules, extra = random_program(
            np.random.default_rng(5), 9)
        assert np.array_equal(
            TB.batch_shard_factor(dims, axes, sizes, rules, extra),
            RB.batch_shard_factor(dims, axes, sizes, rules, extra))
    assert TB._shard_factor_impl is None
    with pytest.raises(RuntimeError):
        with TK.use_backend("cpu"):
            assert TB._shard_factor_impl is not None
            raise RuntimeError("boom")
    assert TB._shard_factor_impl is None
