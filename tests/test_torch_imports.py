"""The port stands alone: importing every module of ``repro_torch`` in a
fresh interpreter pulls in neither ``jax`` nor the reference package, needs
no ``nvcc`` / ``triton``, and its default entry points refuse to run
without a CUDA device instead of quietly computing on the host.  The
kernel entry points of the models are differentiable, and serving's
parameters still record no graph."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def run_fresh(code: str, path: str = "") -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_HOME", "CUDA_PATH")}
    env["PYTHONPATH"] = SRC
    env["PATH"] = path or os.path.dirname(sys.executable)
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)


IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                          "repro_torch."))
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
print("MODULES", len(names))
print("BAD", bad)
for want in ("repro_torch.core.batch_torch", "repro_torch.core.sweep",
             "repro_torch.kernels.shard_factor",
             "repro_torch.kernels.segmented_cummax",
             "repro_torch.kernels.flash_attention",
             "repro_torch.kernels.rmsnorm", "repro_torch.kernels.ops",
             "repro_torch.kernels.ssd", "repro_torch.models.mamba",
             "repro_torch.models.ssm_lm", "repro_torch.models.moe",
             "repro_torch.models.hybrid", "repro_torch.models.encdec",
             "repro_torch.core.search", "repro_torch.core.planner",
             "repro_torch.kernels.ref", "repro_torch.models.param",
             "repro_torch.models.vit", "repro_torch.models.vlm",
             "repro_torch.serve.serve_step",
             "repro_torch.kernels._build", "repro_torch.configs.llava15_7b",
             "repro_torch.launch.mesh", "repro_torch.serve.pool",
             "repro_torch.launch.measure", "repro_torch.core.device_metrics",
             "repro_torch.train", "repro_torch.train.optimizer",
             "repro_torch.train.train_step", "repro_torch.serve.fleet",
             "repro_torch.autopilot.watch", "repro_torch.calibrate",
             "repro_torch.calibrate.__main__", "repro_torch.calibrate.fit",
             "repro_torch.calibrate.learned",
             "repro_torch.calibrate.measurements",
             "repro_torch.calibrate.paths", "repro_torch.calibrate.profile",
             "repro_torch.calibrate.report",
             "repro_torch.calibrate.residual",
             "repro_torch.calibrate.synthetic",
             "repro_torch.autopilot", "repro_torch.autopilot.__main__",
             "repro_torch.autopilot.guard", "repro_torch.autopilot.harness",
             "repro_torch.autopilot.mitigation",
             "repro_torch.checkpoint", "repro_torch.checkpoint.checkpointing",
             "repro_torch.runtime", "repro_torch.runtime.fault_tolerance",
             "repro_torch.data", "repro_torch.data.pipeline",
             "repro_torch.launch.train", "repro_torch.mesh_ctx",
             "repro_torch.configs.__main__", "repro_torch.examples",
             "repro_torch.examples.quickstart",
             "repro_torch.examples.capacity_plan",
             "repro_torch.examples.predict_memory",
             "repro_torch.examples.serve_batched",
             "repro_torch.examples.train_llava_e2e"):
    assert want in names, want
# the calibrate package's lazy exports name the port's own modules
import repro_torch.calibrate as C
for name in C.__all__:
    getattr(C, name)
assert all(m.startswith("repro_torch.calibrate.")
           for m in C._EXPORTS.values())
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
print("BAD_AFTER_EXPORTS", bad)
# the sharding code's DTensor half (imported on first use) brings in
# neither either
import torch
from repro_torch import mesh_ctx
from repro_torch.launch import mesh as M
mesh_ctx.placements((("data", "model"), None), type(
    "Mesh", (), {"mesh_dim_names": ("data", "model"),
                 "mesh": torch.zeros(2, 2)})())
from repro_torch.train.train_step import _batch_mean
from repro_torch.kernels.ops import _placed
_placed("rmsnorm", {"x": torch.zeros(2)}, {})
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
print("BAD_AFTER_SHARDING", bad)
"""


def test_every_module_imports_without_jax_or_reference_package():
    r = run_fresh(IMPORT_ALL)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    assert "BAD_AFTER_EXPORTS []" in r.stdout, r.stdout
    assert "BAD_AFTER_SHARDING []" in r.stdout, r.stdout
    n = int(r.stdout.split("MODULES")[1].split()[0])
    assert n >= 68, r.stdout


def test_no_source_line_imports_jax_or_reference_package():
    import re
    pat = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)
    checked = 0
    for base in (os.path.join(SRC, "repro_torch"),):
        for dirpath, _, files in os.walk(base):
            for f in files:
                if f.endswith(".py"):
                    text = open(os.path.join(dirpath, f)).read()
                    assert not pat.search(text), os.path.join(dirpath, f)
                    checked += 1
    text = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert not pat.search(text)
    assert checked >= 58


DEFAULT_ENTRY = """
import torch
assert not torch.cuda.is_available()
from repro_torch.core import sweep as SW
grid = SW.SweepGrid(arch="smollm-360m", chips=2, global_batches=(8,),
                    seq_lens=(512,))
for call in (lambda: SW.SweepEngine().sweep(grid),
             lambda: SW.sweep(grid),
             lambda: SW.SweepEngine().sweep(grid, device="cuda")):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e) and "device='cpu'" in str(e), e
    else:
        raise SystemExit("default entry point ran without a CUDA device")
res = SW.SweepEngine().sweep(grid, device="cpu")
print("CPU_OK", len(res))
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import generate
model = build_model(get_config("smollm-360m").reduced())
params = model.init(torch.Generator().manual_seed(0), "cpu")
batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
try:
    generate(model, params, batch, 2)
except RuntimeError as e:
    assert "CUDA" in str(e) and "device='cpu'" in str(e), e
else:
    raise SystemExit("generate ran without a CUDA device")
print("GEN_OK", tuple(generate(model, params, batch, 2, device="cpu").shape))
from repro_torch.core.spec import LLAVA_STAGE1
from repro_torch.train import OptimizerConfig, init_train_state
try:
    init_train_state(model, LLAVA_STAGE1, OptimizerConfig(),
                     torch.Generator().manual_seed(0))
except (RuntimeError, AssertionError) as e:
    assert "CUDA" in str(e), e
else:
    raise SystemExit("init_train_state built parameters without a CUDA "
                     "device")
print("TRAIN_OK")
"""


def test_default_entry_point_raises_without_cuda():
    r = run_fresh(DEFAULT_ENTRY)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "CPU_OK 2" in r.stdout
    assert "GEN_OK (1, 2)" in r.stdout
    assert "TRAIN_OK" in r.stdout


@pytest.mark.parametrize("extra,rc,needle", [
    ((), 2, "pass --device cpu"),
    (("--device", "cuda"), 2, "pass --device cpu"),
    (("--device", "cpu"), 0, "engine=torch, device=cpu"),
    (("--engine", "numpy"), 0, "engine=numpy"),
    (("--engine", "numpy", "--device", "cpu"), 2, "--engine torch only"),
    (("--device", "cpu", "--profile", "missing.json"), 2, "--profile: "),
    (("--device", "cpu", "--kind", "decode", "--mix", "0.3"), 0,
     "engine=torch, device=cpu"),
    (("--device", "cpu", "--kind", "decode", "--draft-arch",
      "smollm-360m"), 0, "engine=torch, device=cpu"),
    (("--device", "cpu", "--mesh", "data=2,expert=2"), 2,
     "dense arch"),
])
def test_cli(extra, rc, needle):
    code = ("import sys; from repro_torch.core.sweep import main; "
            f"sys.exit(main({['--arch', 'llava15_7b', '--chips', '4', '--batch', '16', '--seq-len', '1024', *extra]!r}))")
    r = run_fresh(code)
    assert r.returncode == rc, r.stdout + r.stderr
    assert needle in r.stdout + r.stderr


def test_cli_rejects_unported_family():
    """Every family sweeps now: the hybrid zamba2-2.7b on the host."""
    r = run_fresh("import sys; from repro_torch.core.sweep import main; "
                  "sys.exit(main(['--arch', 'zamba2_2_7b', '--chips', '4', "
                  "'--device', 'cpu']))")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "engine=torch, device=cpu" in r.stdout
    assert "zamba2-2.7b" in r.stdout


BUILD_WITHOUT_NVCC = """
from repro_torch.kernels import _build
assert len(_build.sources()) == 9
try:
    _build.load()
except RuntimeError as e:
    assert "nvcc not found" in str(e), e
    print("RAISED")
"""


def test_kernel_build_raises_without_nvcc(tmp_path):
    """Where there is no compiler the build says so; nothing falls back."""
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("an nvcc is installed here")
    r = run_fresh("import os; os.environ['REPRO_TORCH_BUILD_DIR'] = "
                  f"{str(tmp_path)!r}\n" + BUILD_WITHOUT_NVCC,
                  path=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "RAISED" in r.stdout
    assert not list(tmp_path.iterdir())


def test_kernel_entry_points_are_differentiable_and_serving_is_not():
    """``kernels.ops`` no longer refuses a graph: its Functions carry
    gradients to every input that asks; ``init_params`` still makes
    leaves that record none."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    out = ops.flash_attention(q, q, q, True)
    assert out.requires_grad and out.grad_fn is not None
    (g,) = torch.autograd.grad(out.sum(), q)
    assert g.shape == q.shape and bool(torch.isfinite(g).all())
    x = torch.randn(3, 16, requires_grad=True)
    s = torch.ones(16, requires_grad=True)
    gx, gs = torch.autograd.grad(ops.rmsnorm(x, s).sum(), (x, s))
    assert gx.shape == x.shape and gs.shape == s.shape
    model = build_model(get_config("llava15-7b").reduced())
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    assert not any(t.requires_grad for t in params.parameters())


def test_cli_calibration_flags(tmp_path):
    """``--profile`` and ``--residual-model`` load fitted files; the
    profiled torch table equals the reference CLI's; a residual model
    needs ``--engine numpy`` and the profile it was fitted over."""
    fixture = os.path.join(ROOT, "benchmarks", "fixtures",
                           "calibration_measurements.json")
    prof, res = str(tmp_path / "p.json"), str(tmp_path / "r.json")
    fit = run_fresh(
        "from repro_torch.calibrate.__main__ import main\n"
        f"assert main(['fit', '--measurements', {fixture!r}, '--out', "
        f"{prof!r}]) == 0\n"
        f"assert main(['fit-residual', '--measurements', {fixture!r}, "
        f"'--profile', {prof!r}, '--out', {res!r}]) == 0\n")
    assert fit.returncode == 0, fit.stdout + fit.stderr
    argv = ["--arch", "llava15_7b", "--chips", "8", "--chip", "v5e,h100",
            "--batch", "16,64", "--seq-len", "2048", "--profile", prof]

    def cli(module, *extra):
        return run_fresh(f"import sys; from {module} import main; "
                         f"sys.exit(main({[*argv, *extra]!r}))")

    env_ref = dict(os.environ)
    env_ref["PYTHONPATH"] = SRC
    env_ref["JAX_PLATFORMS"] = "cpu"
    ref = subprocess.run(
        [sys.executable, "-c", "import sys; from repro.core.sweep import "
         f"main; sys.exit(main({argv!r}))"], env=env_ref,
        capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr
    got = cli("repro_torch.core.sweep", "--device", "cpu")
    assert got.returncode == 0, got.stdout + got.stderr
    strip = lambda out: [ln for ln in out.splitlines()
                         if " cells in " not in ln]
    assert strip(got.stdout) == strip(ref.stdout)
    assert "[profile " in got.stdout
    bad = cli("repro_torch.core.sweep", "--device", "cpu",
              "--residual-model", res)
    assert bad.returncode == 2 and "--engine numpy" in bad.stderr
    ok = cli("repro_torch.core.sweep", "--engine", "numpy",
             "--residual-model", res)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "[residual " in ok.stdout
    argv = [a for a in argv if a not in ("--profile", prof)]
    unbound = cli("repro_torch.core.sweep", "--engine", "numpy",
                  "--residual-model", res)
    assert unbound.returncode == 2 and "matching --profile" in \
        unbound.stderr
