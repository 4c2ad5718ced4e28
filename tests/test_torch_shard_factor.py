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
    """8 dims, 8 axes, 128 steps pack (8 request fields, 8 tile fields, a
    64-bit request) and match the numpy path and the kernel's model; one
    more of any of them is refused with ValueError, before any launch."""
    r = limit_request(TK.MAX_DIMS, TK.MAX_AXES)
    batch = TK.ShardFactorBatch()
    key = batch.add(*r)
    p = batch.pack()
    assert p.requests.shape == (1, TK.REQ_FIELDS)
    assert p.tiles.shape == (1, TK.TILE_FIELDS)
    assert p.requests[0, TK.REQ_DIMS] == TK.MAX_DIMS
    assert p.requests[0, TK.REQ_AXES] == TK.MAX_AXES
    assert p.requests[0, TK.REQ_STEPS] == TK.MAX_STEPS
    assert p.wide.tolist() == [1]
    assert np.array_equal(batch.resolve("cpu")[key],
                          RB.batch_shard_factor(*r))
    assert np.array_equal(kernel_model(p), RB.batch_shard_factor(*r))
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
    # the inverses sit at the operands' indices, so they are shared alike
    assert p.inverses.shape == p.operands.shape
    k, o, inv = TK.size_constants(p.operands)
    assert np.array_equal(p.inverses.view(np.uint64), inv)
    assert (o * inv == 1).all() and (o << k == p.operands).all()
    answers = batch.resolve("cpu")
    assert [a.tolist() for a in answers.values()] == [
        TB.batch_shard_factor(*r).tolist() for r in (r1, r2)]
    # the kernel's own buffers are derived, never given
    assert np.array_equal(p.tiles, TK._tiles(p.requests))
    assert p.wide.tolist() == [0, 0]
    good = dict(operands=p.operands, rows=p.rows, requests=p.requests,
                steps=p.steps)
    for derived in ("inverses", "wide", "tiles"):
        with pytest.raises(TypeError):
            TK.Packed(**good, **{derived: getattr(p, derived)})
    bad_steps = p.steps.copy()
    bad_steps[0, 0] = 99
    bad_rows = p.rows.copy()
    bad_rows[0, 0] = len(p.operands)
    bad_out = p.requests.copy()
    bad_out[1, TK.REQ_OUT] -= 1
    bad_cells = p.requests.copy()
    bad_cells[0, TK.REQ_N] += 1
    for bad in (dict(good, steps=bad_steps), dict(good, rows=bad_rows),
                dict(good, requests=bad_cells), dict(good, requests=bad_out),
                dict(good, requests=p.requests.astype(np.int32)),
                dict(good, requests=np.pad(p.requests, ((0, 0), (0, 1)))),
                dict(good, rows=p.rows[:, :2])):
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


# ---------------------------------------------------------------------------
# a numpy model of the kernel's arithmetic (csrc/shard_factor.cu): the
# quotient form, s = 2^k o with o's inverse mod 2^64, the multiply-high
# test, and the thread's cell split from the tile's.  Used by these tests
# only.
# ---------------------------------------------------------------------------

U64 = np.uint64
M32 = U64(0xFFFFFFFF)


def umul64hi(a, b):
    """The high 64 bits of a * b for uint64 arrays (``__umul64hi``)."""
    a, b = np.asarray(a, U64), np.asarray(b, U64)
    a0, a1, b0, b1 = a & M32, a >> U64(32), b & M32, b >> U64(32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> U64(32)) + (p01 & M32) + (p10 & M32)
    return p11 + (p01 >> U64(32)) + (p10 >> U64(32)) + (mid >> U64(32))


def model_divides(q, s, inv=None, wide=True):
    """The kernel's test of s | q and the quotient it keeps: ``(ok,
    q / s where ok else q)`` for uint64 ``q`` and int64 ``s >= 1``, with
    ``inv`` the packed inverse (recomputed from ``s`` when None): in 64-bit
    words, or (``wide`` False: every operand < 2^32) in 32-bit ones, with
    the low half of the inverse and the multiply-high of 32 bits."""
    q = np.asarray(q, U64)
    k, o, inv0 = TK.size_constants(s)
    inv = inv0 if inv is None else np.asarray(inv).view(U64)
    with np.errstate(over="ignore"):
        m = q >> k
        if wide:
            x = m * inv
            high = umul64hi(x, o)
        else:
            assert (q < 2 ** 32).all() and (np.asarray(s) < 2 ** 32).all()
            x = (m * (inv & M32)) & M32
            high = (x * o) >> U64(32)
    ok = ((m << k) == q) & (high == 0)
    return ok, np.where(ok, x, q)


def kernel_cmul(c):
    """The kernel's multiplier for a thread's first cell, formed when a
    block stages a request: ``ceil(2^32 / C) = (2^32 - 1) // C + 1`` where
    ``2 <= C < TILE``, else 0 (no division needed)."""
    c = np.asarray(c, np.int64)
    small = (c >= 2) & (c < TK.TILE)
    return np.where(small, (2 ** 32 - 1) // np.where(small, c, 1) + 1, 0)


def model_cells(p, r: int):
    """Per cell of request ``r``: its (ri, ci) as the kernel forms them —
    the tile's split, the thread's first cell (CELLS a thread, one where
    the tile holds at most THREADS cells) by one compare or by the 32-bit
    multiply-high by :func:`kernel_cmul`, then stepped."""
    req = p.requests[r]
    n, c = int(req[TK.REQ_N]), int(req[TK.REQ_C])
    cmul = int(kernel_cmul(c))
    tiles = p.tiles[p.tiles[:, 0] == r]
    ri_all, ci_all = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for _, first, ri0, ci0 in tiles[:, :4].tolist():
        # a tile of at most THREADS cells takes one cell a thread
        nc = 1 if n - first <= TK.THREADS else TK.CELLS
        t = np.arange(TK.THREADS, dtype=np.int64)
        u = ci0 + t * nc
        if c >= TK.TILE:
            w = u >= c
            ri, ci = ri0 + w, np.where(w, u - c, u)
        elif c == 1:
            ri, ci = ri0 + u, np.zeros_like(u)
        else:
            d = (u.astype(U64) * U64(cmul)) >> U64(32)   # __umulhi
            ri, ci = ri0 + d.astype(np.int64), u - d.astype(np.int64) * c
        for j in range(nc):
            cell = first + t * nc + j
            v = cell < n
            ri_all[cell[v]], ci_all[cell[v]] = ri[v], ci[v]
            ci = ci + 1
            ri, ci = np.where(ci == c, ri + 1, ri), np.where(ci == c, 0, ci)
    return ri_all, ci_all


def kernel_model(p) -> np.ndarray:
    """The packed build evaluated as the kernel evaluates it, in numpy."""
    out = np.zeros(p.n_out, np.int64)
    for r, req in enumerate(p.requests.tolist()):
        n = req[TK.REQ_N]
        if n == 0:
            continue
        ri, ci = (x.astype(U64) for x in model_cells(p, r))

        def index(row):
            off, s0, s1 = (U64(v) for v in p.rows[row])
            with np.errstate(over="ignore"):
                return ((off + ri * s0 + ci * s1) & M32).astype(np.int64)
        nd, row0 = req[TK.REQ_DIMS], req[TK.REQ_ROW]
        q = [p.operands[index(row0 + d)].astype(U64) for d in range(nd)]
        used = np.zeros(n, np.uint32)
        latch = np.zeros(n, bool)
        den = np.ones(n, U64)
        st = p.steps[req[TK.REQ_STEP]:req[TK.REQ_STEP] + req[TK.REQ_STEPS]]
        for d, a, fl in st.tolist():
            idx = index(row0 + nd + a)
            s = p.operands[idx]
            div, quo = model_divides(q[d], s, p.inverses[idx],
                                     bool(p.wide[r]))
            if fl == 2:
                latch[:] = False
            free = (used >> np.uint32(a)) & 1 == 0
            ok = div & free & ~((fl > 0) & latch)
            q[d] = np.where(ok, quo, q[d])
            with np.errstate(over="ignore"):
                den = np.where(ok, den * s.astype(U64), den)
            used = used | np.where(ok, np.uint32(1 << a), np.uint32(0))
            latch = latch | (ok & (fl > 0))
        out[req[TK.REQ_OUT]:req[TK.REQ_OUT] + n] = den.view(np.int64)
    return out


EDGE_Q = sorted({0, 1, 2, 3, 2 ** 5, 2 ** 31, 2 ** 32, 2 ** 40, 2 ** 61,
                 TK.DIM_LIMIT, TK.DIM_LIMIT - 1, 3 * 5 * 7,
                 3 * 5 * 7 * 11 * 13, 3 ** 20 * 5 ** 8, 7 ** 19,
                 2 ** 20 * 3 ** 10 * 17, 12 * 96 * 2 ** 30, 17 * 2 ** 55})
EDGE_S = (1, 2, 3, 4, 6, 7, 12, 17, 64, 96, 2 ** 20)


@pytest.mark.parametrize("wide", [True, False], ids=["64bit", "32bit"])
@pytest.mark.parametrize("s", EDGE_S)
def test_model_divisibility_equals_python_remainder(s, wide):
    """The kernel's division-free test (low k bits, x = (q >> k) o^-1,
    umul64hi(x, o) == 0) and its new quotient equal Python's ``%`` and
    ``//`` on edge quotients: 0, 1, powers of two, 2^40, the limit 2^62,
    products of small odd primes, and each q +- 1; the 32-bit form on
    those below 2^32."""
    qs = sorted({v + e for v in EDGE_Q for e in (-1, 0, 1)
                 if 0 <= v + e <= TK.DIM_LIMIT}
                | {s * m for m in (1, 3, 2 ** 20, 3 ** 15)
                   if s * m <= TK.DIM_LIMIT})
    if not wide:
        qs = [q for q in qs if q < 2 ** 32] + [2 ** 32 - 1, 2 ** 32 - 2]
    ok, quo = model_divides(np.array(qs, U64), np.full(len(qs), s),
                            wide=wide)
    want = [q % s == 0 for q in qs]
    assert ok.tolist() == want
    assert [int(x) for x in quo] == [q // s if w else q
                                     for q, w in zip(qs, want)]


def test_size_constants_split_and_invert():
    """k and o with s = 2^k o, o odd, and o * o^-1 == 1 mod 2^64 — the
    packed inverse — on sizes up to 2^62 (and zeros below 1)."""
    s = np.array([1, 2, 3, 6, 7, 12, 17, 64, 96, 2 ** 20, 2 ** 31 - 1,
                  2 ** 31, 3 * 2 ** 40, 2 ** 62, 2 ** 63 - 1, 0, -5],
                 np.int64)
    k, o, inv = TK.size_constants(s)
    pos = s >= 1
    assert ((o[pos] & U64(1)) == 1).all()
    assert [int(x) << int(y) for x, y in zip(o[pos], k[pos])] \
        == s[pos].tolist()
    assert [(int(a) * int(b)) % 2 ** 64 for a, b in zip(o[pos], inv[pos])] \
        == [1] * int(pos.sum())
    assert not k[~pos].any() and not o[~pos].any() and not inv[~pos].any()
    assert np.array_equal(TK._inverses(s), inv.view(np.int64))


@pytest.mark.parametrize("c", [1, 2, 3, 5, 17, 255, 256, 257, 1000,
                               TK.TILE - 1, TK.TILE, TK.TILE + 1, 4608,
                               2 ** 20 + 3])
def test_model_cell_split_equals_divmod(c):
    """Each cell's (ri, ci) as the kernel forms it (the tile's split, a
    compare or the multiply-high by ceil(2^32 / C), then one step a cell)
    equals divmod(cell, C), over several tiles."""
    rows = max(1, (3 * TK.TILE + 5) // c)
    n = rows * c
    p = TK.Packed(np.array([8, 2], np.int64),
                  np.array([[0, 0, 0], [1, 0, 0]], np.int64),
                  np.array([(n, c, 0, 0, 1, 1, 0, 1)], np.int64),
                  np.array([[0, 0, 0]], np.int64))
    ri, ci = model_cells(p, 0)
    cells = np.arange(n)
    assert np.array_equal(ri, cells // c) and np.array_equal(ci, cells % c)


def test_cmul_divides_every_in_tile_offset():
    """For every C in [2, TILE) and every offset u < C + TILE a thread can
    have, __umulhi(u, ceil(2^32 / C)) == u // C, with the multiplier the
    kernel forms by one 32-bit divide, (2^32 - 1) // C + 1."""
    c = np.arange(2, TK.TILE, dtype=np.int64)
    cmul = kernel_cmul(c)
    assert np.array_equal(cmul, -(-2 ** 32 // c))
    u = np.arange(2 * TK.TILE, dtype=np.int64)
    got = (u[None, :].astype(U64) * cmul.astype(U64)[:, None]) >> U64(32)
    assert np.array_equal(got.astype(np.int64), u[None, :] // c[:, None])
    assert not kernel_cmul(np.array([1, TK.TILE, 2 ** 40])).any()


@pytest.mark.parametrize("seed", range(6))
def test_kernel_model_equals_plain_and_reference(seed):
    """The numpy model of the kernel on randomized packed builds (the
    batched tests' requests, dims widened up to 2^40, sizes up to 2^16)
    == the batched plain version == the reference's numpy path, per
    request, as integers."""
    rng = np.random.default_rng(4100 + seed)
    reqs = [random_request(rng) for _ in range(int(rng.integers(1, 41)))]
    for r in reqs[::3]:
        r[0][0] = np.asarray(r[0][0], np.int64) * 2 ** 30
        r[2]["data"] = np.asarray(r[2]["data"], np.int64) * 2 ** 13
    batch = TK.ShardFactorBatch()
    keys = [batch.add(*r) for r in reqs]
    if not len(batch):
        return
    p = batch.pack()
    got = kernel_model(p)
    plain = TK.shard_factor_batch(p.to("cpu")).numpy()
    assert np.array_equal(got, plain)
    for r, key in zip(reqs, keys):
        if key is None:
            continue
        j = batch._index[key]
        lo, n = p.requests[j, TK.REQ_OUT], p.requests[j, TK.REQ_N]
        assert np.array_equal(got[lo:lo + n].reshape(np.shape(
            RB.batch_shard_factor(*r))), RB.batch_shard_factor(*r)), r


def test_kernel_model_at_the_int32_boundary_and_the_limits():
    """The model at the int64 cases and the kernel's limits equals the
    plain version."""
    big = np.array([2 ** 31 - 1, 2 ** 31, 2 ** 32, 3 * 2 ** 31, 2 ** 40,
                    2 ** 62], np.int64)
    rules = {"batch": ("data", "model"), "heads": ("model",)}
    sizes = {"data": np.array([1, 2, 2 ** 16, 2 ** 16, 2 ** 20, 2 ** 31]),
             "model": np.array([2 ** 31 - 1, 2 ** 16, 2 ** 16, 2, 2 ** 20,
                                2])}
    batch = TK.ShardFactorBatch()
    batch.add([big], ("batch",), sizes, rules)
    batch.add([big, big[::-1].copy()], ("batch", "heads"), sizes, rules,
              ("data",))
    batch.add(*limit_request(TK.MAX_DIMS, TK.MAX_AXES))
    p = batch.pack()
    assert np.array_equal(kernel_model(p),
                          TK.shard_factor_batch(p.to("cpu")).numpy())


@pytest.mark.parametrize("bad", ["negative dim", "size 0", "dim past limit"])
def test_operands_out_of_range_are_refused(bad):
    """A negative dim, a size of 0 and a dim past DIM_LIMIT (2^62) are
    refused with a ValueError naming the limit: when packed, and by the
    plain version and the tensor wrapper."""
    dims = [np.array([8, 12, 16])]
    sizes = {"data": np.array([2, 2, 4])}
    if bad == "negative dim":
        dims = [np.array([8, -12, 16])]
    elif bad == "size 0":
        sizes = {"data": np.array([2, 0, 4])}
    else:
        dims = [np.array([8, TK.DIM_LIMIT + 1, 16])]
    rules = {"batch": ("data",)}
    batch = TK.ShardFactorBatch()
    batch.add(dims, ("batch",), sizes, rules)
    with pytest.raises(ValueError, match="limit"):
        batch.pack()
    with pytest.raises(ValueError, match="limit"):
        TK.shard_factor(dims, ("batch",), sizes, rules, device="cpu")
    d = torch.from_numpy(np.stack(dims))
    s = torch.from_numpy(np.stack([sizes["data"]]))
    for fn in (TK.shard_factor_plain, TK.shard_factor_tensors):
        with pytest.raises(ValueError, match="limit"):
            fn(d, s, [(0, 0, 0)])


def test_dims_at_the_limit_and_zero_are_taken():
    """A dim of 0 (every size divides it) and one of exactly 2^62 are in
    range: plain, model and the reference agree."""
    dims = [np.array([0, TK.DIM_LIMIT, 2 ** 61 * 3 // 2, 7])]
    sizes = {"data": np.array([4, 2 ** 31, 3, 7]),
             "model": np.array([8, 2, 2, 2])}
    rules = {"batch": ("data", "model")}
    batch = TK.ShardFactorBatch()
    key = batch.add(dims, ("batch",), sizes, rules, ("model",))
    p = batch.pack()
    want = RB.batch_shard_factor(dims, ("batch",), sizes, rules, ("model",))
    assert np.array_equal(batch.resolve("cpu")[key], want)
    assert np.array_equal(kernel_model(p), want)
    assert want.tolist() == [32, 2 ** 32, 6, 7]


def test_quotient_form_is_the_scalar_reference_where_numpy_wraps():
    """Where the numpy path's running product ``totals * s`` passes 2^63
    (2^40 applied, then 2^24 + 1 tested on a dim of 2^62: it wraps to
    2^40, which divides), the quotient form — plain version and the
    kernel's model — gives the scalar reference's exact answer."""
    dims = [np.array([2 ** 62])]
    sizes = {"data": np.array([2 ** 40]), "model": np.array([2 ** 24 + 1])}
    rules = {"batch": ("data", "model")}
    batch = TK.ShardFactorBatch()
    key = batch.add(dims, ("batch",), sizes, rules)
    want = RM.shard_factor([2 ** 62], ("batch",),
                           {"data": 2 ** 40, "model": 2 ** 24 + 1}, rules)
    assert want == 2 ** 40
    assert batch.resolve("cpu")[key].tolist() == [want]
    assert kernel_model(batch.pack()).tolist() == [want]


def test_requests_read_wide_only_where_an_operand_needs_it():
    """``wide`` is 1 exactly for the requests that read an operand of 2^32
    or more (their quotients stay 64-bit in the kernel); it is derived from
    the operands, so no packed build can say otherwise."""
    rules = {"batch": ("data",)}
    batch = TK.ShardFactorBatch()
    batch.add([np.array([8, 2 ** 32 - 2])], ("batch",),
              {"data": np.array([2, 2])}, rules)
    batch.add([np.array([8, 2 ** 32])], ("batch",),
              {"data": np.array([2, 2])}, rules)
    batch.add([np.array([8, 16])], ("batch",),
              {"data": np.array([2, 2 ** 33])}, rules)
    batch.add([8], ("batch",), {"data": np.array([2, 4])}, rules)
    p = batch.pack()
    assert p.wide.tolist() == [0, 1, 1, 0]
    assert np.array_equal(kernel_model(p),
                          TK.shard_factor_batch(p.to("cpu")).numpy())
    with pytest.raises(ValueError, match="init=False"):
        dataclasses.replace(p, wide=np.zeros(4, np.int64))
    assert dataclasses.replace(p).wide.tolist() == [0, 1, 1, 0]
