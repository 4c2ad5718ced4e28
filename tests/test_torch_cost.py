"""The measurement record's cost and collective blocks (``core.
device_metrics.StepCounter``) against the reference's HLO accounting
(``repro.core.xla_metrics``), on the CPU.

* Dot FLOPs of each family's reduced forward (``Model.loss``) and of one
  train step (AdamW, the arch's remat "block") equal what
  ``loop_aware_stats`` counts in the reference's jitted program for the
  same cell (the reference's weights carried across, the same batch).
  Where the counts differ, the difference is named below and computed
  from the port's own run; every case it does not name is held to 0.
  The differences are XLA's rewrites of the reference's program, not
  products either side skips:

  - ``score_cse``: an attention backward recomputes ``q k^T``; XLA
    merges it with the same product of a forward in the same computation:
    the remat rerun of a scanned block in that block's backward, or, for
    the hybrid's shared attention (invoked outside any scan, not
    rematerialised), the forward itself.  The port computes both: 2 B H Sq
    Skv D per attention forward rerun in the backward, and per backward
    of the hybrid's shared attention.  (A scanned block without remat, as
    the ViT's, keeps both products in the reference too.)
  - ``logits_cse``: the chunked loss's logits product, rerun in the
    backward, merged by XLA with its forward: 2 B c D V per chunk rerun.
  - ``ssd_chunk_cse``: the SSD's chunk body is checkpointed inside the
    checkpointed block, and the port reruns it twice in the backward.  The
    reference's program, once XLA merges the nested reruns, computes one
    ``C B^T``, one masked product and one 2 b H Q N P product fewer per
    chunk: 2 b Q^2 N + 2 b H Q^2 P + 2 b H Q N P.
  - ``ssd_zero_state``: with one chunk the reference's chunk scan has one
    trip, XLA removes the loop and folds ``C state^T`` of the zero initial
    state: 2 b H Q N P per SSD call, forward only.
  - ``ssd_head_sum`` (the reference's extra): its autodiff of the chunk
    sums the gradients of B, C and ``C B^T`` (shared by the heads) over
    the heads with dots, the port's autograd with reductions:
    4 x 2 b Q N H + 2 b Q^2 H per chunk.
  - ``router_twice`` (the reference's extra): the reference evaluates the
    router again for the load-balance loss; under remat the backward keeps
    both evaluations' products where the port hands its routing on:
    2 x 2 T D E per MoE layer.

  With XLA's ``cse`` and ``simplify-while-loops`` passes off, the dense,
  VLM, enc-dec and MLA train steps count exactly the port's FLOPs
  (:func:`test_named_differences_are_xlas_cse`).
* Each kernel's reported FLOPs (``flash_attention.fwd_flops`` /
  ``dq_flops`` / ``dkv_flops``, ``ssd.plain_flops``; RMSNorm none) equal
  what the counter counts over its plain version at every shape case of
  the kernels' tests; the wrapper on a CPU tensor reports nothing.
* Per-op collective bytes equal ``collective_stats`` of HLO lines written
  for the same ops, shapes and group sizes (a ``fake`` world).
* The record's keys are the reference's dry-run record's, less
  ``compile_seconds``, plus the port's own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as RShape
from repro.configs import get_config as ref_config
from repro.core import spec as RSPEC
from repro.core import xla_metrics as XM
from repro.launch.mesh import make_smoke_mesh
from repro.mesh_ctx import mesh_context as ref_mesh_context
from repro.models import build_model as ref_build
from repro.train import optimizer as RO
from repro.train import train_step as RTS
from repro_torch.configs import get_config
from repro_torch.core import device_metrics as DM
from repro_torch.core.spec import FULL_TRAIN
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd as SSD
from repro_torch.mesh_ctx import mesh_context
from repro_torch.models import build_model
from repro_torch.models import mamba as MB
from repro_torch.models import transformer as TT
from repro_torch.train import OptimizerConfig, make_train_step, train_state

FAMILIES = {"dense": "smollm-360m", "vlm": "llava15-7b",
            "encdec": "seamless-m4t-large-v2", "ssm": "mamba2-1.3b",
            "hybrid": "zamba2-2.7b", "mla": "minicpm3-4b",
            "moe": "arctic-480b", "mla_moe": "deepseek-v2-lite-16b"}
B = 2


def to_torch(a) -> torch.Tensor:
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def make_batch(model, seq: int, seed: int = 1) -> dict:
    """A train batch of the reference model's batch_spec as numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, sd in model.batch_spec(RShape("t", seq, B, "train")).items():
        if np.issubdtype(sd.dtype, np.integer):
            out[name] = rng.integers(0, model.cfg.vocab, sd.shape) \
                .astype(np.int32)
        else:
            out[name] = (rng.standard_normal(sd.shape, np.float32) * 0.3) \
                .astype(sd.dtype)
    return out


@pytest.fixture(scope="module")
def fp32_pairs():
    """arch -> (ref model, ref params, port model, numpy params), fp32."""
    cache = {}

    def get(arch):
        if arch not in cache:
            rmodel = ref_build(dataclasses.replace(
                ref_config(arch).reduced(), dtype="float32"))
            rparams = rmodel.init(jax.random.PRNGKey(0))
            tmodel = build_model(dataclasses.replace(
                get_config(arch).reduced(), dtype="float32"))
            cache[arch] = (rmodel, rparams, tmodel,
                           jax.tree.map(np.asarray, rparams))
        return cache[arch]
    return get


def _moe(cfg) -> bool:
    return cfg.moe is not None


def _contexts(cfg):
    """(the reference's, the port's) mesh contexts: an MoE runs its
    dispatch path under a 1 x 1 mesh on both sides."""
    if _moe(cfg):
        return (ref_mesh_context(make_smoke_mesh()),
                mesh_context({"data": 1, "model": 1}))
    return contextlib.nullcontext(), contextlib.nullcontext()


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


class Named:
    """The named differences of one port run, from the port's own calls
    (see the module docstring)."""

    def __init__(self, monkeypatch):
        self.score_rerun = self.score_bwd = self.logits_cse = 0
        self.ssd_chunk_reruns = self.ssd_zero_state = self.ssd_head_sum = 0
        fwd, bwd = FA.flash_fwd_plain, FA.flash_bwd_plain
        loss, chunk, chunked = TT._chunk_loss, MB._ssd_chunk, MB.ssd_chunked

        def flash_fwd_plain(q, k, v, **kw):
            if _in_backward():
                self.score_rerun += 2 * FA._pairs(q, k) * q.shape[3]
            return fwd(q, k, v, **kw)

        def flash_bwd_plain(q, k, v, *args, **kw):
            self.score_bwd += 2 * FA._pairs(q, k) * q.shape[3]
            return bwd(q, k, v, *args, **kw)

        def chunk_loss(cfg, p, h, labels):
            if _in_backward():
                self.logits_cse += 2 * h.shape[0] * h.shape[1] \
                    * h.shape[2] * cfg.vocab
            return loss(cfg, p, h, labels)

        def ssd_chunk(A, out_dtype, st, xq, dtq, Bq, Cq):
            b, Q, H, P = xq.shape
            N = Bq.shape[-1]
            if _in_backward():
                self.ssd_chunk_reruns += 2 * b * Q * Q * N \
                    + 2 * b * H * Q * Q * P + 2 * b * H * Q * N * P
            else:
                self.ssd_head_sum += 4 * 2 * b * Q * N * H \
                    + 2 * b * Q * Q * H
            return chunk(A, out_dtype, st, xq, dtq, Bq, Cq)

        def ssd_chunked(x, dt, A, Bm, C, chunk, initial_state=None):
            b, S, H, P = x.shape
            if not _in_backward() and S <= chunk and initial_state is None:
                self.ssd_zero_state += 2 * b * H * chunk * Bm.shape[-1] * P
            return chunked(x, dt, A, Bm, C, chunk, initial_state)

        monkeypatch.setattr(FA, "flash_fwd_plain", flash_fwd_plain)
        monkeypatch.setattr(FA, "flash_bwd_plain", flash_bwd_plain)
        monkeypatch.setattr(TT, "_chunk_loss", chunk_loss)
        monkeypatch.setattr(MB, "_ssd_chunk", ssd_chunk)
        monkeypatch.setattr(MB, "ssd_chunked", ssd_chunked)

    def score_cse(self, family: str) -> int:
        return self.score_rerun + (self.score_bwd if family == "hybrid"
                                   else 0)

    @property
    def ssd_chunk_cse(self) -> int:
        # each chunk body is rerun twice in the port's backward
        return self.ssd_chunk_reruns // 2


def router_twice(cfg, seq: int) -> int:
    if not _moe(cfg):
        return 0
    layers = cfg.n_layers - cfg.moe.n_dense_layers
    return layers * 2 * (2 * B * seq * cfg.d_model * cfg.moe.n_experts)


def ref_flops(fn, *args) -> int:
    text = jax.jit(fn).lower(*args).compile().as_text()
    flops = XM.loop_aware_stats(text).flops
    assert flops == int(flops)
    return int(flops)


def forward_flops(pair, seq, monkeypatch):
    """(the reference's, the port's) dot FLOPs of the loss forward, and
    the named differences."""
    rmodel, rparams, tmodel, np_params = pair
    batch = make_batch(rmodel, seq)
    rctx, tctx = _contexts(rmodel.cfg)
    with rctx:
        want = ref_flops(lambda p, b: rmodel.loss(p, b),
                         rparams, {k: jnp.asarray(v) for k, v in
                                   batch.items()})
    tparams = tmodel.from_numpy(np_params, "cpu")
    named = Named(monkeypatch)
    with tctx, torch.no_grad():
        counter, _ = DM.count_step(lambda: tmodel.loss(
            tparams, {k: to_torch(v) for k, v in batch.items()}))
    return want, counter, named


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_dot_flops_equal_the_reference(family, fp32_pairs,
                                               monkeypatch):
    want, counter, named = forward_flops(fp32_pairs(FAMILIES[family]), 24,
                                         monkeypatch)
    assert counter.kernel_launches == 0          # the plain versions ran
    # ssd_zero_state: one chunk of 32 over 24 positions
    assert counter.flops - named.ssd_zero_state == want
    assert (named.ssd_zero_state > 0) == (family in ("ssm", "hybrid"))


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_forward_dot_flops_over_two_chunks(family, fp32_pairs, monkeypatch):
    """64 positions, two chunks of 32: the chunk scan has two trips and
    nothing is named."""
    want, counter, named = forward_flops(fp32_pairs(FAMILIES[family]), 64,
                                         monkeypatch)
    assert named.ssd_zero_state == 0
    assert counter.flops == want


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_dot_flops_equal_the_reference(family, fp32_pairs,
                                                  monkeypatch):
    rmodel, rparams, tmodel, np_params = fp32_pairs(FAMILIES[family])
    seq = 24
    batch = make_batch(rmodel, seq)
    rctx, tctx = _contexts(rmodel.cfg)
    opt = RO.OptimizerConfig(name="adamw")
    mask = RTS.PM.trainable_mask(rmodel.spec, RSPEC.FULL_TRAIN)
    trainable, _ = RTS.PM.partition_params(rparams, mask)
    rstate = RTS.TrainState(params=rparams,
                            opt=RO.init_opt_state(trainable, opt),
                            step=jnp.zeros((), jnp.int32))
    with rctx:
        want = ref_flops(RTS.make_train_step(rmodel, RSPEC.FULL_TRAIN, opt),
                         rstate, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    tstate = train_state(tmodel.from_numpy(np_params, "cpu"), FULL_TRAIN,
                         OptimizerConfig(name="adamw"))
    step = make_train_step(tmodel, FULL_TRAIN, OptimizerConfig(name="adamw"))
    named = Named(monkeypatch)
    with tctx:
        counter, _ = DM.count_step(lambda: step(
            tstate, {k: to_torch(v) for k, v in batch.items()}))
    assert counter.kernel_launches == 0
    port_only = named.score_cse(family) + named.logits_cse \
        + named.ssd_chunk_cse
    ref_only = router_twice(rmodel.cfg, seq) + named.ssd_head_sum
    assert counter.flops - port_only + ref_only == want, (
        counter.flops, want, vars(named))
    assert named.logits_cse > 0
    assert (named.score_cse(family) > 0) == (family != "ssm")
    assert (named.ssd_chunk_cse > 0) == (family in ("ssm", "hybrid"))


NO_CSE = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core import spec, xla_metrics as XM
from repro.models import build_model
from repro.train import optimizer as RO, train_step as RTS
from tests.test_torch_cost import make_batch
out = {}
for arch in sys.argv[1:]:
    model = build_model(dataclasses.replace(get_config(arch).reduced(),
                                            dtype="float32"))
    params = model.init(jax.random.PRNGKey(0))
    opt = RO.OptimizerConfig(name="adamw")
    trainable, _ = RTS.PM.partition_params(
        params, RTS.PM.trainable_mask(model.spec, spec.FULL_TRAIN))
    state = RTS.TrainState(params=params,
                           opt=RO.init_opt_state(trainable, opt),
                           step=jnp.zeros((), jnp.int32))
    batch = {k: jnp.asarray(v) for k, v in make_batch(model, 24).items()}
    text = jax.jit(RTS.make_train_step(model, spec.FULL_TRAIN, opt)).lower(
        state, batch).compile().as_text()
    out[arch] = int(XM.loop_aware_stats(text).flops)
print("FLOPS", json.dumps(out))
"""


def test_named_differences_are_xlas_cse(fp32_pairs, tmp_path):
    """The reference's train steps compiled with XLA's ``cse`` and
    ``simplify-while-loops`` passes off (a process of its own: the flags
    are read when the backend starts) count the port's dot FLOPs exactly
    for the families whose only named differences are ``score_cse`` and
    ``logits_cse``."""
    import json
    import os
    import subprocess
    import sys
    archs = [FAMILIES[f] for f in ("dense", "vlm", "encdec", "mla")]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(root, "src"), root]),
               XLA_FLAGS="--xla_disable_hlo_passes=cse,simplify-while-loops")
    r = subprocess.run([sys.executable, "-c", NO_CSE] + archs, cwd=root,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    want = json.loads(r.stdout.split("FLOPS", 1)[1])
    for arch in archs:
        _, _, tmodel, np_params = fp32_pairs(arch)
        tstate = train_state(tmodel.from_numpy(np_params, "cpu"),
                             FULL_TRAIN, OptimizerConfig(name="adamw"))
        step = make_train_step(tmodel, FULL_TRAIN,
                               OptimizerConfig(name="adamw"))
        batch = make_batch(fp32_pairs(arch)[0], 24)
        counter, _ = DM.count_step(lambda: step(
            tstate, {k: to_torch(v) for k, v in batch.items()}))
        assert counter.flops == want[arch], arch


# ---------------------------------------------------------------------------
# the kernels' reports against their plain versions
# ---------------------------------------------------------------------------


def _flash_cases():
    from tests.test_torch_flash_attention import TENSOR_CORE_CASES as FWD
    from tests.test_torch_flash_backward import TENSOR_CORE_CASES as BWD
    return list(dict.fromkeys(FWD + BWD))


def _qkv(case, seed=7):
    Bq, Sq, Skv, H, Hkv, D, Dv, causal, _ = case
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((Bq, Sq, H, D), generator=g)
    k = torch.randn((Bq, Skv, Hkv, D), generator=g)
    v = torch.randn((Bq, Skv, Hkv, Dv), generator=g)
    return q, k, v, causal, (Skv - Sq if causal else 0)


@pytest.mark.parametrize("case", _flash_cases(), ids=str)
def test_flash_reports_the_plain_versions_flops(case):
    q, k, v, causal, off = _qkv(case)
    with DM.StepCounter() as fwd:
        out, lse = FA.flash_fwd_plain(q, k, v, causal=causal, q_offset=off)
    assert fwd.flops == FA.fwd_flops(q, k, v)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    with DM.StepCounter() as bwd:
        FA.flash_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                           q_offset=off)
    assert bwd.flops == FA.dq_flops(q, k, v) + FA.dkv_flops(q, k, v)
    # the wrapper on CPU tensors takes the plain version: counted once,
    # nothing reported
    with DM.StepCounter() as wrapped:
        FA.flash_fwd(q, k, v, causal=causal, q_offset=off)
    assert (wrapped.flops, wrapped.kernel_launches) == (fwd.flops, 0)


def _ssd_cases():
    from tests.test_torch_ssd import TENSOR_CORE_CASES
    return TENSOR_CORE_CASES


@pytest.mark.parametrize("case", _ssd_cases(),
                         ids=lambda c: "x".join(map(str, c)))
def test_ssd_reports_the_plain_versions_flops(case):
    from tests.test_torch_ssd import inputs
    b, S, H, P, N, chunk = case
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in inputs(case)]
    with DM.StepCounter() as plain:
        SSD.ssd_scan_plain(*args, chunk=chunk)
    assert plain.flops == SSD.plain_flops(b, S, H, P, N, chunk)
    with DM.StepCounter() as wrapped:
        SSD.ssd_scan(*args, chunk=chunk)
    assert (wrapped.flops, wrapped.kernel_launches) == (plain.flops, 0)


def test_rmsnorm_has_no_dot():
    x = torch.randn(6, 64)
    scale = torch.randn(64)
    with DM.StepCounter() as c:
        y = RN.rmsnorm_fwd(x, scale)
        RN.rmsnorm_bwd(x, scale, torch.ones_like(y))
    assert c.flops == 0 and c.bytes_accessed > 0 and c.kernel_launches == 0


def test_report_kernel_reaches_every_active_counter():
    t = torch.zeros(4, 8)                       # 128 bytes

    def unasked():
        raise AssertionError("FLOPs computed with no counter active")
    DM.report_kernel((t,), unasked)             # no counter: no effect
    with DM.StepCounter() as outer:
        with DM.StepCounter() as inner:
            DM.report_kernel((t, t), lambda: 1000)
        DM.report_kernel((t,), lambda: 7)
        DM.report_kernel((t,))                  # no dot
    assert (inner.flops, inner.bytes_accessed, inner.kernel_launches) \
        == (1000, 256, 1)
    assert (outer.flops, outer.bytes_accessed, outer.kernel_launches) \
        == (1007, 512, 3)


@pytest.mark.parametrize("op,packet,shapes,want", [
    ("mm", torch.ops.aten.mm, ((5, 7), (7, 3)), 2 * 5 * 3 * 7),
    ("addmm", torch.ops.aten.addmm, ((3,), (5, 7), (7, 3)), 2 * 5 * 3 * 7),
    ("bmm", torch.ops.aten.bmm, ((4, 5, 7), (4, 7, 3)), 2 * 4 * 5 * 3 * 7),
    ("baddbmm", torch.ops.aten.baddbmm, ((4, 5, 3), (4, 5, 7), (4, 7, 3)),
     2 * 4 * 5 * 3 * 7)])
def test_dot_formulas(op, packet, shapes, want):
    args = [torch.randn(s) for s in shapes]
    with DM.StepCounter() as c:
        packet(*args)
    assert c.flops == want


@pytest.mark.parametrize("groups,transposed", [(1, False), (4, False),
                                               (1, True)])
def test_convolution_formula(groups, transposed):
    """2 x output elements x (input channels per group x kernel) — the
    reference's ``loop_aware_stats`` counts a convolution as a dot."""
    x = torch.randn(2, 8, 10, 10)
    if transposed:
        w = torch.randn(8, 6 // groups, 3, 3)
        with DM.StepCounter() as c:
            out = torch.nn.functional.conv_transpose2d(x, w, groups=groups)
        want = 2 * x.numel() * (6 // groups) * 9
    else:
        w = torch.randn(6 * groups // groups * 1, 8 // groups, 3, 3) \
            if groups == 1 else torch.randn(8, 8 // groups, 3, 3)
        with DM.StepCounter() as c:
            out = torch.nn.functional.conv2d(x, w, groups=groups)
        want = 2 * out.numel() * (8 // groups) * 9
    assert c.flops == want


# ---------------------------------------------------------------------------
# collectives against the reference's HLO accounting
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_world():
    """A ``fake``-backend world of the asked size (rank 0 is this
    process); torn down after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(size: int):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=size)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def _hlo(op: str, dtype: str, shape: tuple, group: int) -> str:
    dims = ",".join(map(str, shape))
    layout = ",".join(map(str, reversed(range(len(shape)))))
    ranks = ",".join(map(str, range(group)))
    extra = {"all-reduce": ", to_apply=%add",
             "reduce-scatter": ", dimensions={0}, to_apply=%add"}.get(
                 op, ", dimensions={0}")
    return (f"  %c.1 = {dtype}[{dims}]{{{layout}}} {op}(%p), "
            f"replica_groups={{{{{ranks}}}}}{extra}\n")


_HLO_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _issue(kind: str, api: str, t: torch.Tensor, group: int):
    """One collective of ``kind`` over the whole world through ``api``
    (``c10d``: the in-place ``torch.distributed`` calls, as the MoE
    issues them; ``functional``: the functional collectives DTensor
    issues) -> the result's shape."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    world = dist.group.WORLD
    if kind == "all-reduce":
        out = t.clone()
        if api == "c10d":
            dist.all_reduce(out)
        else:
            out = funcol.all_reduce(t, "sum", world).wait()
    elif kind == "all-gather":
        out = t.new_empty((group * t.shape[0],) + tuple(t.shape[1:]))
        if api == "c10d":
            dist.all_gather_into_tensor(out, t)
        else:
            out = funcol.all_gather_tensor(t, 0, world).wait()
    elif kind == "reduce-scatter":
        out = t.new_empty((t.shape[0] // group,) + tuple(t.shape[1:]))
        if api == "c10d":
            dist.reduce_scatter_tensor(out, t)
        else:
            out = funcol.reduce_scatter_tensor(t, "sum", 0, world).wait()
    else:
        out = torch.empty_like(t)
        if api == "c10d":
            dist.all_to_all_single(out, t)
        else:
            out = funcol.all_to_all_single(t, None, None, world).wait()
    return tuple(out.shape)


@pytest.mark.parametrize("api", ["c10d", "functional"])
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all"])
@pytest.mark.parametrize("group,dtype", [(4, torch.float32),
                                         (2, torch.bfloat16),
                                         (8, torch.float32)])
def test_collective_bytes_equal_the_reference(kind, api, group, dtype,
                                              fake_world):
    fake_world(group)
    t = torch.ones((16 * group, 24), dtype=dtype)
    with DM.StepCounter() as c:
        shape = _issue(kind, api, t, group)
    want = XM.collective_stats(_hlo(kind, _HLO_TYPES[dtype], shape, group))
    got = c.collectives
    assert got.counts == want.counts == {kind: 1}
    assert got.operand_bytes == want.operand_bytes
    assert got.wire_bytes == want.wire_bytes
    assert got.total_wire_bytes == want.total_wire_bytes > 0


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_permute_wire_bytes_equal_the_reference(group):
    line = (f"  %cp.1 = f32[64,32]{{1,0}} collective-permute(%p), "
            f"replica_groups={{{{{','.join(map(str, range(group)))}}}}}\n")
    want = XM.collective_stats(line)
    nbytes = 64 * 32 * 4
    assert want.operand_bytes == {"collective-permute": nbytes}
    assert {"collective-permute": DM.wire_bytes("collective-permute",
                                                nbytes, group)} \
        == want.wire_bytes


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------

# the reference's dry-run record (src/repro/launch/dryrun.py, lower_cell):
# top-level keys and the keys of its three cost / collective blocks
REF_KEYS = {"arch", "shape", "mesh", "mesh_shape", "n_devices", "kind",
            "compile_seconds", "memory", "predicted", "cost",
            "collectives", "loop_aware"}
REF_BLOCKS = {
    "cost": {"flops_per_device", "bytes_accessed_per_device"},
    "collectives": {"counts", "operand_bytes_per_device",
                    "wire_bytes_per_device", "total_wire_bytes_per_device"},
    "loop_aware": {"flops_per_device", "bytes_accessed_per_device",
                   "collective_counts", "collective_wire_bytes",
                   "total_wire_bytes_per_device"}}
PORT_KEYS = {"allocator", "seq_len", "global_batch", "backend", "chip",
             "optimizer", "remat", "policy", "grad_accum", "device",
             "step_s"}


def test_reference_keys_are_the_dry_runs():
    from repro.launch import dryrun
    src = inspect.getsource(dryrun.lower_cell)
    for key in REF_KEYS | set().union(*REF_BLOCKS.values()):
        assert f'"{key}"' in src, key


def test_record_keys_are_the_references(monkeypatch):
    from repro_torch.launch import measure as ME
    cell = ME.MeasureCell("smollm-360m", "train", 2048, 8, "full", "adamw",
                          "block")
    stats = DM.StepMemory(
        stats=DM.MemoryStats(argument_bytes=10, output_bytes=10,
                             temp_bytes=5, alias_bytes=10),
        baseline_bytes=0, start_bytes=10, end_bytes=10, peak_bytes=15,
        max_reserved_bytes=20, alloc_retries=0)
    counter = DM.StepCounter()
    counter.flops, counter.bytes_accessed = 123, 456
    rec = ME.record_for(cell, stats, {"name": "card", "power_limit": "1 W"},
                        counter, 0.5)
    assert set(rec) == (REF_KEYS - {"compile_seconds"}) | PORT_KEYS
    for block, keys in REF_BLOCKS.items():
        assert set(rec[block]) == keys, block
    assert rec["cost"] == {"flops_per_device": 123,
                           "bytes_accessed_per_device": 456}
    assert rec["loop_aware"]["flops_per_device"] == 123
    assert rec["collectives"]["counts"] == {}
    assert rec["step_s"] == 0.5
    # the blocks are no option: a record is made with its counter and time
    with pytest.raises(TypeError):
        ME.record_for(cell, stats, {"name": "card", "power_limit": "1 W"})


@pytest.mark.parametrize("arch,kind", [("llava15-7b", "train"),
                                       ("mamba2-1.3b", "prefill"),
                                       ("seamless-m4t-large-v2", "decode")])
def test_counted_cell_step_on_the_cpu(arch, kind):
    """A measurement cell's step (``launch.measure.cell_step``) counted on
    the CPU at a reduced config: dot FLOPs and bytes, no collective, no
    kernel report."""
    from repro_torch.launch import measure as ME
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    cell = ME.MeasureCell(arch, kind, 24, 2,
                          "llava_stage1" if arch == "llava15-7b" else "full",
                          "adamw" if kind == "train" else None,
                          "block" if kind == "train" else None)
    gen = torch.Generator().manual_seed(0)
    state = ME.make_state(cell, model, gen, "cpu")
    counter, out = DM.count_step(ME.cell_step(cell, model, state, gen,
                                              steps=1))
    blocks = DM.cost_blocks(counter)
    assert blocks["cost"]["flops_per_device"] > 0
    assert blocks["cost"]["bytes_accessed_per_device"] > 0
    assert blocks["loop_aware"]["flops_per_device"] \
        == blocks["cost"]["flops_per_device"]
    assert blocks["collectives"]["total_wire_bytes_per_device"] == 0
    assert counter.kernel_launches == 0 and counter.aten_ops > 0
