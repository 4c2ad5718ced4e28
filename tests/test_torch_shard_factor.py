"""Port of the shard-factor kernel module (repro_torch.kernels.shard_factor)
against the reference package, on the CPU (where the wrapper takes the
plain version): one request at a time, and the batched form that resolves
every request of a table build in one call.  Same numpy inputs go to both
sides; every quantity is an integer, so the tolerance is 0
(``np.array_equal`` on int64)."""

import dataclasses

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


# ---------------------------------------------------------------------------
# the batched form: every request of a table build in one call
# ---------------------------------------------------------------------------

def random_request(rng):
    """One request of a table build: a random program over operands of a
    random broadcast shape — scalars, rows (n,), columns (m, 1), full
    (m, n) and 3-dim shapes, one-cell shapes, and (by chance) empty
    programs and FSDP/ZeRO ``extra`` passes."""
    m, n = int(rng.integers(1, 6)), int(rng.integers(1, 40))
    shapes = [[()], [(), (n,), (1,)],
              [(), (n,), (m, 1), (m, n), (1, n), (1, 1)],
              [(), (n,), (m, 1), (m, n), (2, 1, 1), (2, m, n), (1, 1, n)]
              ][int(rng.integers(0, 4))]
    rules = {}
    for name in LOGICAL:
        k = rng.integers(0, 3)
        rules[name] = tuple(
            rng.choice(MESH_AXES, size=k, replace=False)) if k else ()
    n_dims = int(rng.integers(1, 5))
    axes = tuple(rng.choice(LOGICAL + (None,)) for _ in range(n_dims))

    def operand(values):
        shape = shapes[int(rng.integers(0, len(shapes)))]
        a = rng.choice(values, size=shape).astype(np.int64)
        return int(a) if shape == () and rng.integers(0, 2) else a
    dims = [operand([1, 2, 3, 4, 6, 8, 12, 16, 24, 64])
            for _ in range(n_dims)]
    sizes = {a: operand([1, 1, 2, 4, 8]) for a in MESH_AXES}
    extra = tuple(rng.choice(MESH_AXES, size=int(rng.integers(0, 3)),
                             replace=False))
    return dims, axes, sizes, rules, extra


@pytest.mark.parametrize("seed", range(6))
def test_batched_plain_version_equals_the_numpy_path(seed):
    """Randomized builds of up to 60 requests resolved by ONE batched call
    (the plain version on the CPU) == the port's and the reference's numpy
    ``batch_shard_factor`` on every request, as integers."""
    rng = np.random.default_rng(900 + seed)
    for _ in range(4):
        reqs = [random_request(rng)
                for _ in range(int(rng.integers(1, 61)))]
        batch = TK.ShardFactorBatch()
        keys = [batch.add(*r) for r in reqs]
        answers = batch.resolve("cpu")
        assert len(answers) == len(batch) <= len(reqs)
        for r, key in zip(reqs, keys):
            want = TB.batch_shard_factor(*r)
            assert np.array_equal(want, RB.batch_shard_factor(*r))
            got = np.broadcast_to(np.ones((), np.int64), want.shape) \
                if key is None else answers[key]
            assert got.dtype == np.int64 and got.shape == want.shape, r
            assert np.array_equal(got, want), r


def test_batched_extra_latch_and_one_cell_requests():
    """The FSDP/ZeRO latch (flags 1 and 2: a second extra axis reopens
    it) and one-cell requests, in one build, against the scalar
    reference."""
    rules = {"batch": ("data",), "heads": ("model",), "dmodel": ()}
    cases = [
        ([8, 6, 4], ("batch", "heads", "dmodel"), {"data": 2, "model": 3},
         ("data", "model")),
        ([12, 1, 8], ("layers", "dmodel", "heads"),
         {"data": 4, "model": 2}, ("data",)),
        ([5, 16], ("dmodel", "batch"), {"data": 4, "model": 2},
         ("model", "data")),
        ([np.array([[4]]), 6], ("dmodel", None), {"data": 2, "model": 2},
         ("data", "model")),
    ]
    batch = TK.ShardFactorBatch()
    keys = [batch.add(d, a, s, rules, e) for d, a, s, e in cases]
    packed = batch.pack()
    flags = set(packed.steps[:, 2].tolist())
    assert {1, 2} <= flags
    answers = batch.resolve("cpu")
    for (d, a, s, e), key in zip(cases, keys):
        want = RM.shard_factor([int(np.asarray(x).reshape(-1)[0])
                                for x in d], a, s, rules, e)
        assert answers[key].size == 1
        assert int(answers[key].reshape(-1)[0]) == want


def limit_request(n_dims, n_axes, dup=0):
    """A request of ``n_dims`` dims over ``n_axes`` mesh axes, every dim
    taking every axis in the rules pass and again in the extra pass:
    ``2 * n_dims * n_axes + dup`` steps."""
    mesh = [f"a{i}" for i in range(n_axes)]
    rules = {f"x{i}": tuple(mesh) + (mesh[0],) * (dup if i == 0 else 0)
             for i in range(n_dims)}
    dims = [np.array([2 ** 40, 2 ** 20, 2 ** 8 * 3, 1]) for _ in
            range(n_dims)]
    sizes = {a: np.array([2, 2, 2, 2]) for a in mesh}
    return dims, tuple(rules), sizes, rules, tuple(mesh)


def test_requests_at_the_kernel_limits():
    """8 dims, 8 axes, 128 steps pack and match the numpy path; one more
    of any of them is refused with ValueError, before any launch."""
    r = limit_request(TK.MAX_DIMS, TK.MAX_AXES)
    batch = TK.ShardFactorBatch()
    key = batch.add(*r)
    p = batch.pack()
    assert p.requests[0, TK.REQ_DIMS] == TK.MAX_DIMS
    assert p.requests[0, TK.REQ_AXES] == TK.MAX_AXES
    assert p.requests[0, TK.REQ_STEPS] == TK.MAX_STEPS
    assert np.array_equal(batch.resolve("cpu")[key],
                          RB.batch_shard_factor(*r))
    for over in (limit_request(TK.MAX_DIMS + 1, 4),
                 limit_request(4, TK.MAX_AXES + 1),
                 limit_request(TK.MAX_DIMS, TK.MAX_AXES, dup=1)):
        batch = TK.ShardFactorBatch()
        batch.add(*over)
        with pytest.raises(ValueError, match="limits"):
            batch.pack()


def test_int64_at_the_int32_boundary():
    """Dims at 2^31 - 1, 2^31 and beyond, and running products that
    overflow int32 (2^16 x 2^16 on one dim): the batched plain version
    equals the scalar reference; nothing is computed in 32 bits."""
    big = np.array([2 ** 31 - 1, 2 ** 31, 2 ** 32, 3 * 2 ** 31, 2 ** 40,
                    2 ** 62], np.int64)
    rules = {"batch": ("data", "model"), "heads": ("model",)}
    sizes = {"data": np.array([1, 2, 2 ** 16, 2 ** 16, 2 ** 20, 2 ** 31]),
             "model": np.array([2 ** 31 - 1, 2 ** 16, 2 ** 16, 2, 2 ** 20,
                                2])}
    cases = [([big], ("batch",), sizes, rules, ()),
             ([big, big[::-1].copy()], ("batch", "heads"), sizes, rules,
              ("data",)),
             ([np.array([2 ** 31 - 1]), 2 ** 31], ("heads", "batch"),
              {"data": 2 ** 31 - 1, "model": 2 ** 31 - 1}, rules, ())]
    batch = TK.ShardFactorBatch()
    keys = [batch.add(*c) for c in cases]
    answers = batch.resolve("cpu")
    for (dims, axes, s, rl, extra), key in zip(cases, keys):
        got = answers[key]
        assert np.array_equal(got, RB.batch_shard_factor(
            dims, axes, s, rl, extra))
        shape = got.shape
        for i in np.ndindex(shape):
            pick = lambda v: int(np.broadcast_to(v, shape)[i])
            assert int(got[i]) == RM.shard_factor(
                [pick(d) for d in dims], axes,
                {a: pick(v) for a, v in s.items()}, rl, extra)
    assert answers[keys[0]].max() >= 2 ** 32


def test_packed_buffers_share_rows_and_refuse_bad_ones():
    """Equal requests are recorded once and equal operand rows stored
    once; a malformed packed buffer is refused, never run."""
    sizes = {"data": np.array([1, 2, 4, 8]), "model": np.array([2, 2, 1, 1])}
    rules = {"batch": ("data",), "heads": ("model",)}
    r1 = ([np.array([8, 8, 8, 8]), 4], ("batch", "heads"), sizes, rules)
    r2 = ([np.array([4, 6, 8, 16]), 2], ("batch", "heads"), sizes, rules)
    batch = TK.ShardFactorBatch()
    assert batch.add(*r1) == batch.add(*r1) and len(batch) == 1
    batch.add(*r2)
    p = batch.pack()
    # 4 + 1 values of each request's dims, the two size rows once
    assert len(batch) == 2 and len(p.operands) == 2 * (4 + 1) + 2 * 4
    answers = batch.resolve("cpu")
    assert [a.tolist() for a in answers.values()] == [
        TB.batch_shard_factor(*r).tolist() for r in (r1, r2)]
    good = dict(operands=p.operands, rows=p.rows, requests=p.requests,
                steps=p.steps, tiles=p.tiles)
    bad_steps = p.steps.copy()
    bad_steps[0, 0] = 99
    bad_rows = p.rows.copy()
    bad_rows[0, 0] = len(p.operands)
    bad_out = p.requests.copy()
    bad_out[1, TK.REQ_OUT] -= 1
    for bad in (dict(good, steps=bad_steps), dict(good, rows=bad_rows),
                dict(good, tiles=p.tiles[:-1]), dict(good, requests=bad_out),
                dict(good, requests=p.requests.astype(np.int32))):
        with pytest.raises(ValueError):
            TK.Packed(**bad)
    with pytest.raises(TypeError):
        TK.shard_factor_batch(p)
    dev = p.to("cpu")
    with pytest.raises(ValueError, match="packed shapes"):
        TK.shard_factor_batch(dataclasses.replace(dev, rows=dev.rows[:-1]))


def test_resolve_batched_runs_the_build_twice_around_one_call(monkeypatch):
    """A build's every denominator from ONE batched call; the answers
    equal the numpy path; a second run that asks for something new
    raises."""
    calls = []
    real = TK.shard_factor_batch
    monkeypatch.setattr(TK, "shard_factor_batch",
                        lambda b: calls.append(b) or real(b))
    rng = np.random.default_rng(11)
    reqs = [random_request(rng) for _ in range(25)]
    out, batch = TK.resolve_batched(
        lambda: [TB.batch_shard_factor(*r) for r in reqs], "cpu")
    assert len(calls) == 1 and TB._shard_factor_impl is None
    assert len(batch) == len(calls[0].host.requests)
    for r, got in zip(reqs, out):
        assert np.array_equal(got, RB.batch_shard_factor(*r))
    rules = {"batch": ("data",)}
    runs = iter((8, 12))

    def unstable():
        return TB.batch_shard_factor([next(runs)], ("batch",),
                                     {"data": 2}, rules)
    with pytest.raises(RuntimeError, match="did not ask"):
        TK.resolve_batched(unstable, "cpu")
    assert TB._shard_factor_impl is None
