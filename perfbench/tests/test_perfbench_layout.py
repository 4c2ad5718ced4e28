"""The benchmark is driven by data: every cell, configuration, traffic
mix and metric is found by its name, and a new one takes only new files
and entries."""

import json
import shutil
from types import SimpleNamespace

import pytest

from perfbench.harness import cell as CELL
from perfbench.harness import check
from perfbench.tests import reduced

BENCH = CELL.load_benchmark()


def test_every_name_has_its_files():
    for conf in BENCH["configs"]:
        assert (CELL.ROOT / conf["file"]).is_file()
        assert conf["file"].startswith("perfbench/")
        family = json.loads((CELL.ROOT / conf["file"]).read_text())["family"]
        for kind in ("reference", "flops", "program"):
            assert (CELL.HERE / kind / f"{family}.py").is_file()
    for w in BENCH["workloads"]:
        c = CELL.load(w["name"])
        assert set(c.limits) == set(check.NAMES)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(CELL.plugin("metrics", m["name"]).read)


@pytest.mark.parametrize("name", reduced.CELLS)
def test_each_cell_reports_its_metrics(name):
    c = CELL.load(name)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    moved = {m["moves"] for m in c.per_layer}
    assert moved <= e2e


def test_a_new_cell_config_traffic_and_metric_take_only_new_files(tmp_path):
    """A copy of the benchmark's tree with one configuration, one traffic
    mix, one cell and one metric added as files and entries: each is
    found by its name, and no file that was there changed."""
    root = tmp_path / "checkout"
    shutil.copytree(CELL.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    conf = json.loads((CELL.ROOT / bench["configs"][0]["file"]).read_text())
    conf["num_hidden_layers"] = 4
    (root / "perfbench/configs/new_model.json").write_text(json.dumps(conf))
    bench["configs"].append(dict(bench["configs"][0], name="new_model",
                                 file="perfbench/configs/new_model.json",
                                 reduced=["num_hidden_layers"]))
    traffic = CELL.load(bench["workloads"][0]["name"]).traffic
    traffic["inputs"][1]["shape"] = [8, 3520]
    (root / "perfbench/traffic/new_mix.json").write_text(json.dumps(traffic))
    bench["workloads"].append(dict(bench["workloads"][0], name="new_cell",
                                   config="new_model", traffic="new_mix"))
    (root / "perfbench/limits/new_cell.json").write_text(
        (root / "perfbench/limits" /
         f"{bench['workloads'][0]['name']}.json").read_text())
    (root / "perfbench/metrics/steps_done.py").write_text(
        "def read(ctx):\n    return ctx.window['steps']\n")
    bench["per_layer"].append({
        "name": "steps_done", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "train_step",
        "moves": "train_tokens_per_s", "workloads": ["new_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    c = CELL.load("new_cell", root)
    assert c.config["num_hidden_layers"] == 4
    assert c.traffic["inputs"][1]["shape"] == [8, 3520]
    assert "steps_done" in [m["name"] for m in c.per_layer]
    assert "steps_done" not in [m["name"] for m in
                                CELL.load(BENCH["workloads"][0]["name"],
                                          root).per_layer]
    reader = CELL.plugin("metrics", "steps_done", root)
    assert reader.read(SimpleNamespace(window={"steps": 7})) == 7
    flops = CELL.plugin("flops", c.config["family"], root)
    assert flops.work(c.config, c.traffic)["positions"] == 8 * (576 + 3520)
    after = {p: p.read_bytes() for p in before}
    assert after == before
