"""The port's sharding helpers (``mesh_ctx``, ``launch.mesh``,
``models.param``, ``train.optimizer.opt_state_specs``) against the
reference's, on the CPU.

* for all 12 archs ``param_specs`` / ``param_axes`` equal the reference's
  (shapes, dtypes, axis tuples) and ``opt_state_specs`` equals the
  reference's for AdamW with and without an fp32 master, Adafactor and
  8-bit Adam;
* every parameter, optimizer-state, gradient, batch and cache leaf's
  resolved spec (``param_shardings`` / ``opt_shardings`` /
  ``zero_grad_shardings`` / ``batch_shardings`` / ``cache_shardings``)
  equals the reference's ``PartitionSpec``, on the (16, 16) and (2, 16,
  16) production meshes and a (2, 4, 2, 16) ``data, expert, context,
  model`` mesh, for train, prefill and decode (the reference run in a
  process with 512 fake CPU devices);
* on the production meshes, built as ``DeviceMesh``es of a 512-rank world
  of ``torch.distributed``'s ``fake`` backend, every leaf's local shape is
  ``shape // shard_factor`` dim by dim;
* where a spec puts several mesh axes on one dim, each coordinate's
  shard (DTensor's own split, placement by placement) is the block the
  reference's ``devices_indices_map`` gives it, on (2, 2) and (2, 2, 2)
  meshes;
* ``mesh_context`` takes a ``DeviceMesh``; ``shard`` lays a ``DTensor``
  out and leaves a plain tensor alone; the kernels' entry points take a
  ``DTensor`` split only on dims they do not reduce over, and refuse the
  rest with a ``ValueError``.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as ref_config
from repro.core.spec import FULL_TRAIN as REF_FULL_TRAIN
from repro.core.spec import LLAVA_STAGE1 as REF_LLAVA_STAGE1
from repro.models import build_model as ref_build
from repro.models import param as RPM
from repro.train.optimizer import OptimizerConfig as RefOpt
from repro.train.optimizer import opt_state_specs as ref_opt_specs
from repro_torch import mesh_ctx as MC
from repro_torch.configs import SHAPES, registered_archs
from repro_torch.configs import get_config
from repro_torch.core.spec import FULL_TRAIN, LLAVA_STAGE1
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.models import build_model
from repro_torch.models import param as PM
from repro_torch.train.optimizer import OptimizerConfig, opt_state_specs
from tests.conftest import run_with_devices

ARCHS = registered_archs()
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "ep_cp": (("data", "expert", "context", "model"), (2, 4, 2, 16))}
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
OPTIMIZERS = [dict(name="adamw"), dict(name="adamw", master_fp32=False),
              dict(name="adafactor", master_fp32=False),
              dict(name="adamw8bit")]

# ---------------------------------------------------------------------------
# the reference's specs, from a process with 512 fake devices
# ---------------------------------------------------------------------------

REFERENCE_SPECS = r'''
import json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import SHAPES, get_config
from repro.core.spec import FULL_TRAIN
from repro.launch import mesh as M
from repro.mesh_ctx import mesh_context
from repro.models import build_model, param as PM
from repro.train.optimizer import OptimizerConfig, opt_state_specs

MESHES = {meshes}
KINDS = {kinds}
out = {{}}

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]

def walk(tree, prefix, group, key):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            walk(v, prefix + (k,), group, key)
        return
    out[key + "|" + group + "|" + "/".join(prefix)] = spec(tree)

for arch in {archs}:
    cfg = get_config(arch)
    model = build_model(cfg)
    for mname, (names, shape) in MESHES.items():
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), names)
        for kind, shape_name in KINDS.items():
            sh = SHAPES[shape_name]
            key = "|".join((arch, mname, kind))
            with mesh_context(mesh, M.arch_rules(cfg, kind)):
                walk(M.param_shardings(model, mesh), (), "params", key)
                walk(M.batch_shardings(mesh, model.batch_spec(sh)), (),
                     "batch", key)
                if kind == "train":
                    opt_cfg = OptimizerConfig(name=cfg.optimizer)
                    mask = PM.trainable_mask(model.spec, FULL_TRAIN)
                    axes = model.param_axes()
                    t_axes = jax.tree.map(lambda m, ax: ax if m else None,
                                          mask, axes)
                    t_specs, _ = PM.partition_params(model.param_specs(),
                                                     mask)
                    walk(M.opt_shardings(model, mesh, t_specs, opt_cfg,
                                         t_axes), (), "opt", key)
                    walk(M.zero_grad_shardings(mesh, t_specs, t_axes), (),
                         "zero", key)
                if kind == "decode":
                    B = sh.global_batch
                    if cfg.family == "encdec":
                        cache = jax.eval_shape(lambda: model.init_cache(
                            B, sh.seq_len, enc_len=sh.seq_len))
                    else:
                        cache = jax.eval_shape(lambda: model.init_cache(
                            B, sh.seq_len))
                    walk(M.cache_shardings(mesh, cache, cfg), (), "cache",
                         key)

# the shard index maps of multi-axis specs
maps = {{}}
for names, shape, specs in {index_cases}:
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), names)
    for s in specs:
        entries = [tuple(e) if isinstance(e, list) else e for e in s]
        sharding = NamedSharding(mesh, P(*entries))
        idx = sharding.devices_indices_map((16, 8, 4))
        got = {{}}
        for d, sl in idx.items():
            coord = [int(c) for c in np.argwhere(mesh.devices == d)[0]]
            got[",".join(map(str, coord))] = [
                [x.start or 0, x.stop if x.stop is not None else dim]
                for x, dim in zip(sl, (16, 8, 4))]
        maps[json.dumps([list(names), s])] = got
with open("{path}", "w") as f:
    json.dump({{"specs": out, "maps": maps}}, f)
print("REF_SPECS_OK", len(out))
'''

# (mesh axis names, shape, specs): several axes on one dim, in and out of
# the mesh's order
INDEX_CASES = [
    (("data", "model"), (2, 2),
     [[["data", "model"]], [["model", "data"]],
      [None, ["model", "data"]], ["model", None, "data"]]),
    (("data", "context", "model"), (2, 2, 2),
     [[["context", "model"]], [["model", "context"], "data"],
      [["model", "data", "context"]], [["context", "data"], None, "model"],
      [None, ["model", "context", "data"]], [["data", "context", "model"]]]),
]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "specs.json"
    code = REFERENCE_SPECS.format(
        meshes=repr(MESHES), kinds=repr(KINDS), archs=repr(ARCHS),
        index_cases=repr(INDEX_CASES), path=path)
    assert "REF_SPECS_OK" in run_with_devices(code, n_devices=512)
    return json.loads(path.read_text())


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (k,))
    elif tree is not None:
        yield "/".join(prefix), tree


def _spec_list(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def port_specs(arch: str, sizes_of) -> dict:
    """The port's resolved specs of every leaf, keyed as the reference's
    (``sizes_of(mesh name)`` is the mesh each helper gets)."""
    cfg = get_config(arch)
    model = build_model(cfg)
    out = {}
    for mname, (names, shape) in MESHES.items():
        mesh = sizes_of(mname)
        for kind, shape_name in KINDS.items():
            sh = SHAPES[shape_name]
            key = "|".join((arch, mname, kind))
            groups = {}
            with MC.mesh_context(mesh, M.arch_rules(cfg, kind)):
                groups["params"] = M.param_shardings(model, mesh)
                groups["batch"] = M.batch_shardings(mesh,
                                                    model.batch_spec(sh))
                if kind == "train":
                    opt_cfg = OptimizerConfig(name=cfg.optimizer)
                    mask = PM.trainable_mask(model.spec, FULL_TRAIN)
                    t_specs, _ = PM.partition_params(model.param_specs(),
                                                     mask)
                    t_axes, _ = PM.partition_params(model.param_axes(), mask)
                    groups["opt"] = M.opt_shardings(model, mesh, t_specs,
                                                    opt_cfg, t_axes)
                    groups["zero"] = M.zero_grad_shardings(mesh, t_specs,
                                                           t_axes)
                if kind == "decode":
                    enc = {"enc_len": sh.seq_len} \
                        if cfg.family == "encdec" else {}
                    groups["cache"] = M.cache_shardings(
                        mesh, model.init_cache(sh.global_batch, sh.seq_len,
                                               "meta", **enc), cfg)
            for group, tree in groups.items():
                for path, s in _walk(tree):
                    out[f"{key}|{group}|{path}"] = s
    return out


# ---------------------------------------------------------------------------
# specs and axes of the parameter and optimizer trees
# ---------------------------------------------------------------------------


def _tree_items(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_items(v, prefix + (k,))
    else:
        yield "/".join(prefix), tree


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_the_reference(arch):
    rmodel, tmodel = ref_build(ref_config(arch)), build_model(
        get_config(arch))
    want = dict(_tree_items(rmodel.param_specs()))
    got = dict(_tree_items(tmodel.param_specs()))
    assert list(got) == list(want)
    for k, sd in want.items():
        assert got[k].shape == tuple(sd.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(sd.dtype), k
    assert dict(_tree_items(tmodel.param_axes())) == \
        {k: tuple(v) for k, v in _rt_axes(rmodel.param_axes())}
    # the trainable parts of two policies, and every optimizer's state
    for policy, rpolicy in ((FULL_TRAIN, REF_FULL_TRAIN),
                            (LLAVA_STAGE1, REF_LLAVA_STAGE1)):
        mask = PM.trainable_mask(tmodel.spec, policy)
        rmask = RPM.trainable_mask(rmodel.spec, rpolicy)
        assert dict(_tree_items(mask)) == dict(_tree_items(rmask))
        t_specs, frozen = PM.partition_params(tmodel.param_specs(), mask)
        r_specs, _ = RPM.partition_params(rmodel.param_specs(), rmask)
        for kw in OPTIMIZERS:
            got = _opt_items(opt_state_specs(t_specs, OptimizerConfig(**kw)))
            want = _opt_items(ref_opt_specs(r_specs, RefOpt(**kw)))
            assert got == want, kw
            assert any(v is not None for v in got.values()) or \
                policy is LLAVA_STAGE1


def _rt_axes(tree, prefix=()):
    """(path, axes) of the reference's axes tree (its leaves are tuples)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _rt_axes(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _opt_items(tree, prefix=()) -> dict:
    """{leaf path: {state name: (shape, dtype name)} or None} of either
    package's optimizer-state spec tree."""
    out = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if v is None:
            out["/".join(path)] = None
        elif all(hasattr(s, "shape") for s in v.values()):
            out["/".join(path)] = {
                n: (tuple(s.shape), str(s.dtype).removeprefix("torch."))
                for n, s in v.items()}
        else:
            out.update(_opt_items(v, path))
    return out


# ---------------------------------------------------------------------------
# resolved specs of every leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_every_resolved_spec_equals_the_reference(arch, reference):
    want = {k: v for k, v in reference["specs"].items()
            if k.startswith(arch + "|")}
    got = port_specs(arch, lambda m: dict(zip(*MESHES[m])))
    assert set(got) == set(want)
    for k, s in got.items():
        assert _spec_list(s.spec) == want[k], k
    # every group and kind is covered
    groups = {k.split("|")[3] for k in got}
    assert groups == {"params", "batch", "opt", "zero", "cache"}


# ---------------------------------------------------------------------------
# DTensor layouts on DeviceMeshes of a fake 512-rank world
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    """A 512-rank world of the ``fake`` backend (rank 0 is this process),
    torn down after the module."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import DeviceMesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        meshes = {name: DeviceMesh("cpu", torch.arange(math.prod(shape))
                                   .reshape(shape), mesh_dim_names=names)
                  for name, (names, shape) in MESHES.items()
                  if name != "ep_cp"}
        for names, shape, _ in INDEX_CASES:
            meshes[names] = DeviceMesh("cpu", torch.arange(
                math.prod(shape)).reshape(shape), mesh_dim_names=names)
        yield meshes
    finally:
        dist.destroy_process_group()


def test_production_mesh_builders(world):
    mesh = M.make_production_mesh(multi_pod=True, device_type="cpu")
    assert mesh.mesh_dim_names == ("pod", "data", "model")
    assert tuple(mesh.mesh.shape) == (2, 16, 16)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_shapes_on_the_production_meshes(arch, world):
    sizes = {m: dict(zip(*MESHES[m])) for m in MESHES}
    specs = port_specs(arch, lambda m: world.get(m, sizes[m]))
    cfg = get_config(arch)
    model = build_model(cfg)
    shapes = {f"params|{p}": t.shape
              for p, t in _walk(model.param_specs())}
    checked = 0
    for key, s in specs.items():
        _, mname, kind, group, path = key.split("|")
        if mname == "ep_cp" or group not in ("params", "zero"):
            continue
        shape = shapes[f"params|{path}"]
        local = s.local_shape(shape)
        blocks = [1 if e is None else sizes[mname][e] if isinstance(e, str)
                  else math.prod(sizes[mname][a] for a in e)
                  for e in s.spec] + [1] * (len(shape) - len(s.spec))
        assert local == tuple(d // k for d, k in zip(shape, blocks)), key
        # the arithmetic twin the byte model uses
        axes = dict(_walk(model.param_axes()))[path]
        with MC.mesh_context(sizes[mname], M.arch_rules(cfg, kind)):
            factor = MC.shard_factor(
                shape, axes, sizes[mname], MC.current_rules(),
                extra=("data",) if group == "zero" or cfg.fsdp else ())
        assert math.prod(local) == math.prod(shape) // factor, key
        checked += 1
    assert checked


@pytest.mark.parametrize("case", range(sum(len(c[2]) for c in INDEX_CASES)))
def test_shard_index_maps_equal_the_reference(case, world, reference):
    names, shape, spec = [(n, s, sp) for n, s, specs in INDEX_CASES
                          for sp in specs][case]
    mesh = world[names]
    want = reference["maps"][json.dumps([list(names), spec])]
    entries = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
    placements = MC.placements(entries, mesh)
    full = torch.arange(16 * 8 * 4).reshape(16, 8, 4)
    for coord in np.ndindex(*shape):
        local = full
        for dim, pl in enumerate(placements):
            if hasattr(pl, "_split_tensor"):
                local = pl._split_tensor(local, shape[dim],
                                         with_padding=False)[0][coord[dim]]
        sl = want[",".join(map(str, coord))]
        block = full[tuple(slice(a, b) for a, b in sl)]
        assert torch.equal(local, block), (spec, coord, placements)


# ---------------------------------------------------------------------------
# the live mesh, shard(), and DTensors at the kernels' entry points
# ---------------------------------------------------------------------------


def test_mesh_context_takes_a_device_mesh(world):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = world["16x16"]
    assert MC.current_mesh() is None
    with MC.mesh_context(mesh):
        assert MC.current_mesh() is mesh
        assert MC.current_mesh_shape() == {"data": 16, "model": 16}
        assert MC.mesh_axis_sizes() == {"data": 16, "model": 16}
        x = torch.randn(32, 48)
        assert MC.shard(x, "batch", "ffn") is x
        dx = DTensor.from_local(x, mesh, [Replicate(), Replicate()],
                                run_check=False)
        got = MC.shard(dx, "batch", "ffn")
        assert got.placements == (Shard(0), Shard(1))
        assert torch.equal(got.to_local(), x[:2, :3])
        sh = MC.named_sharding((32, 48), ("batch", "ffn"))
        assert sh.spec == ("data", "model") and sh.local_shape(
            (32, 48)) == (2, 3)
    assert MC.current_mesh() is None
    with MC.mesh_context({"data": 2}):
        assert MC.current_mesh() is None and MC.named_sharding(
            (4,), ("batch",)) is None


def _dt(x, mesh, placements, shape=None):
    """This rank's ``x`` as a DTensor (global ``shape``: even splits by
    default)."""
    from torch.distributed.tensor import DTensor
    if shape is None:
        return DTensor.from_local(x, mesh, placements, run_check=False)
    stride = torch.empty(shape).stride()
    return DTensor.from_local(x, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def test_kernel_entry_points_take_only_splits_they_do_not_reduce(world):
    from torch.distributed.tensor import Replicate, Shard
    mesh = world[("data", "model")]
    g = torch.Generator().manual_seed(0)
    # RMSNorm: rows split, the normalized dim whole
    x = torch.randn(4, 6, 16, generator=g)
    scale = torch.randn(16, generator=g)
    got = ops.rmsnorm(_dt(x, mesh, [Shard(0), Shard(1)]), scale)
    assert got.placements == (Shard(0), Shard(1))
    assert torch.equal(got.to_local(), ops.rmsnorm(x, scale))
    got = ops.rmsnorm(_dt(x, mesh, [Shard(0), Replicate()]),
                      _dt(scale, mesh, [Replicate(), Replicate()]))
    assert torch.equal(got.to_local(), ops.rmsnorm(x, scale))
    with pytest.raises(ValueError, match="reduces over"):
        ops.rmsnorm(_dt(x, mesh, [Shard(2), Replicate()]), scale)
    with pytest.raises(ValueError, match="reduces over"):
        ops.rmsnorm(_dt(x, mesh, [Shard(0), Replicate()]),
                    _dt(scale, mesh, [Replicate(), Shard(0)]))
    # attention: batch and heads split alike on q, k, v
    q = torch.randn(2, 8, 4, 16, generator=g)
    k = torch.randn(2, 8, 2, 16, generator=g)
    v = torch.randn(2, 8, 2, 16, generator=g)
    pl = [Shard(0), Shard(2)]
    got = ops.flash_attention(*(_dt(t, mesh, pl) for t in (q, k, v)))
    assert got.placements == tuple(pl)
    torch.testing.assert_close(got.to_local(), ops.flash_attention(q, k, v),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="reduces over"):
        ops.flash_attention(*(_dt(t, mesh, [Shard(1), Replicate()])
                              for t in (q, k, v)))
    with pytest.raises(ValueError, match="not placed as"):
        ops.flash_attention(_dt(q, mesh, pl), k, v)
    # one kv head over two ranks: this rank holds it, the other none
    one = [_dt(t[:, :, :1], mesh, pl, shape=(4, 8, 1, 16))
           for t in (k, v)]
    with pytest.raises(ValueError, match="unevenly"):
        ops.flash_attention(_dt(q, mesh, pl), *one)
    # the SSD: batch split only
    b, S, H, P, N = 2, 16, 2, 4, 4
    args = (torch.randn(b, S, H, P, generator=g),
            torch.rand(b, S, H, generator=g) * 0.1,
            -torch.rand(H, generator=g),
            torch.randn(b, S, N, generator=g),
            torch.randn(b, S, N, generator=g))
    pl = [Shard(0), Replicate()]
    y, st = ops.ssd_scan(*(a if i == 2 else _dt(a, mesh, pl)
                           for i, a in enumerate(args)), chunk=8)
    wy, wst = ops.ssd_scan(*args, chunk=8)
    assert y.placements == st.placements == tuple(pl)
    assert torch.equal(y.to_local(), wy) and torch.equal(st.to_local(), wst)
    with pytest.raises(ValueError, match="reduces over"):
        ops.ssd_scan(*(a if i == 2 else _dt(a, mesh, [Shard(1),
                                                      Replicate()])
                       for i, a in enumerate(args)), chunk=8)
