"""Nothing the benchmark runs loads JAX or the JAX package (compared by
whole top-level name: ``repro_torch`` is not ``repro``), and the
reference loads nothing of the program."""

import json
import os
import subprocess
import sys

from perfbench.harness import cell as CELL

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _loaded(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(CELL.ROOT), str(CELL.ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")],
        capture_output=True, text=True, env=env, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    names = [m["name"] for m in CELL.load_benchmark()["end_to_end"]
             + CELL.load_benchmark()["per_layer"]]
    loaded = _loaded(
        "from perfbench.harness import cell, cli, check, trace, train\n"
        "import perfbench.control\n"
        "import repro_torch.train, repro_torch.models.registry\n"
        "for kind in ('reference', 'flops', 'program'):\n"
        "    for fam in ('vlm', 'encdec'):\n"
        "        cell.plugin(kind, fam)\n"
        f"for m in {names!r}:\n"
        "    cell.plugin('metrics', m)\n")
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("import perfbench.reference.vlm, "
                     "perfbench.reference.encdec")
    assert not loaded & (FORBIDDEN | {"repro_torch"})


def test_the_forbidden_names_are_whole_top_level_names():
    from perfbench.harness.cli import forbidden_modules
    assert forbidden_modules(["jax.numpy", "torch"]) == ["jax"]
    assert forbidden_modules(["repro.core.sweep"]) == ["repro"]
    assert forbidden_modules(["repro_torch.train", "jaxtyping",
                              "flaxen"]) == []
