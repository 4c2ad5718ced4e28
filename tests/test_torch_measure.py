"""The measurement artifact of the port (``repro_torch.launch.measure``,
``repro_torch.core.device_metrics``) on the CPU, with no card.

* every GRID cell's record predicts what the reference's
  ``planner.check`` predicts for the same cell, and what the record's own
  ingest (``Measurement.from_dryrun_record`` ->
  ``calibrate.residual.predict_measurement``) predicts, as integers;
* both packages' ``autopilot.watch.observed_bytes`` read a record's
  ``total_bytes``, and rebuild it from the four counters without it;
* a reference-style dry-run record (no own cell) ingests to the same
  Measurement in both packages;
* the allocator readings refuse a device that is not CUDA;
* each kind's step closure runs on the CPU at the reduced configs, under
  the 1 x 1 mesh context ``run_cell`` gives it (the MoE's dispatch path);
* the card's committed store predicts in the port what it predicts in the
  reference, and gives the MAPE table of ``PERF.md``.
"""

import dataclasses
import json
import os

import pytest
import torch

from repro.autopilot import watch as RW
from repro.calibrate import measurements as RMS
from repro.calibrate import residual as RRES
from repro.configs import ShapeConfig as RShape
from repro.core import planner as RPL
from repro.core import spec as RS
from repro_torch.autopilot import watch as TW
from repro_torch.calibrate import measurements as TMS
from repro_torch.calibrate import residual as TRES
from repro_torch.calibrate.paths import measured_dir, repo_root
from repro_torch.configs import get_config
from repro_torch.core import device_metrics as DM
from repro_torch.launch import measure as M
from repro_torch.mesh_ctx import mesh_context
from repro_torch.models import build_model

POLICIES = {"full": RS.FULL_TRAIN, "llava_stage1": RS.LLAVA_STAGE1,
            "llava_stage2": RS.LLAVA_STAGE2}
DEVICE = {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
STORE = os.path.join(repo_root(), "src", "repro_torch", "calibrate",
                     "measured", "h100_80gb_hbm3_700w.json")


def fake_memory(total: int, start: int = 3 << 30) -> DM.StepMemory:
    """Allocator readings of a step that peaked ``total`` bytes above a
    1 GiB baseline (for the host-only paths)."""
    base = 1 << 30
    end = start + (5 << 20)
    argument, output = start - base, end - base
    alias = min(start, end) - base
    stats = DM.MemoryStats(argument_bytes=argument, output_bytes=output,
                           temp_bytes=total - argument - output + alias,
                           alias_bytes=alias)
    return DM.StepMemory(stats=stats, baseline_bytes=base, start_bytes=start,
                         end_bytes=end, peak_bytes=base + total,
                         max_reserved_bytes=base + total + (64 << 20),
                         alloc_retries=0)


def record(cell, memory) -> dict:
    """The record of ``cell`` at the allocator readings ``memory``, with
    an empty step counter and a 1 s step (for the host-only paths)."""
    return M.record_for(cell, memory, DEVICE, DM.StepCounter(), 1.0)


def test_grid_covers_the_cells_asked_for():
    archs = {c.arch for c in M.GRID}
    assert len(M.GRID) >= 35 and len(archs) >= 7
    kinds = {(c.arch, c.kind, c.policy) for c in M.GRID}
    for want in (("llava15-7b", "train", "llava_stage1"),
                 ("llava15-7b", "train", "llava_stage2"),
                 ("llava-next-mistral-7b", "train", "llava_stage1"),
                 ("seamless-m4t-large-v2", "train", "full"),
                 ("seamless-m4t-large-v2", "prefill", "full"),
                 ("seamless-m4t-large-v2", "decode", "full"),
                 ("mamba2-1.3b", "train", "full"),
                 ("deepseek-v2-lite-16b", "prefill", "full"),
                 ("deepseek-v2-lite-16b", "decode", "full"),
                 ("minicpm3-4b", "train", "full"),
                 ("minicpm3-4b", "prefill", "full"),
                 ("minicpm3-4b", "decode", "full"),
                 ("zamba2-2.7b", "train", "full"),
                 ("zamba2-2.7b", "prefill", "full"),
                 ("zamba2-2.7b", "decode", "full")):
        assert want in kinds, want
    # every family the grid measures has its row in the summary
    assert {get_config(c.arch).family for c in M.GRID} <= set(
        M.FAMILY_NAMES)
    # one record file per cell
    names = [(c.arch, c.shape) for c in M.GRID]
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("cell", M.GRID, ids=lambda c: f"{c.arch}-{c.shape}")
def test_record_predicts_what_the_reference_planner_predicts(cell):
    rec = record(cell, fake_memory(20 << 30))
    want = RPL.check(cell.arch, RShape(cell.shape, cell.seq_len,
                                       cell.global_batch, cell.kind),
                     {"data": 1, "model": 1}, policy=POLICIES[cell.policy],
                     optimizer=cell.optimizer, remat=cell.remat,
                     backend="tpu", chip="h100")
    m = TMS.Measurement.from_dryrun_record(rec)
    got = TRES.predict_measurement(m)
    assert rec["predicted"]["peak_bytes"] == got.peak_bytes \
        == want.peak_bytes
    assert want.peak_bytes <= 60 << 30            # GRID's admission rule
    assert (m.arch, m.kind, m.seq_len, m.global_batch, m.backend, m.chip,
            m.optimizer, m.remat, m.policy, m.grad_accum) == (
        cell.arch, cell.kind, cell.seq_len, cell.global_batch, "tpu",
        "h100", cell.optimizer, cell.remat, cell.policy, 1)
    assert m.measured_bytes == 20 << 30 and m.meta["device"] == DEVICE
    # the reference's calibration predicts the ingested cell alike
    ref = RMS.Measurement.from_dict(m.to_dict())
    assert RRES.predict_measurement(ref).peak_bytes == want.peak_bytes


def test_observed_bytes_reads_the_total_and_rebuilds_it():
    rec = record(M.GRID[0], fake_memory(7 << 30))
    for watch in (TW, RW):
        assert watch.observed_bytes(rec) == 7 << 30
        assert watch.observed_bytes(rec["memory"]) == 7 << 30
        no_total = dict(rec, memory={k: v for k, v in rec["memory"].items()
                                     if k != "total_bytes"})
        assert watch.observed_bytes(no_total) == 7 << 30
        no_counter = dict(no_total, memory={
            k: v for k, v in no_total["memory"].items()
            if k != "temp_bytes"})
        assert watch.observed_bytes(no_counter) is None


def test_a_dryrun_record_ingests_as_in_the_reference():
    rec = {"arch": "llama3.2-3b", "shape": "train_4k", "mesh": "16x16",
           "kind": "train", "compile_seconds": 12.5,
           "memory": {"argument_bytes": 10, "output_bytes": 4,
                      "temp_bytes": 100, "alias_bytes": 4}}
    for r in (rec, dict(rec, mesh_shape={"data": 4, "model": 2})):
        got = TMS.Measurement.from_dryrun_record(r, source="x.json")
        want = RMS.Measurement.from_dryrun_record(r, source="x.json")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.backend == "cpu" and got.seq_len == 4096


def test_memory_stats_refuses_a_device_that_is_not_cuda():
    with pytest.raises(ValueError, match="not a CUDA device"):
        DM.memory_stats(lambda: None, 0, "cpu")
    with pytest.raises(ValueError, match="not a CUDA device"):
        DM.allocated_bytes(torch.device("cpu"))
    with pytest.raises(RuntimeError, match="CUDA device"):
        M.run_cell(M.GRID[0], device="cpu")


def test_memory_counters_sum_to_the_peak():
    mem = fake_memory(9 << 30, start=5 << 30)
    assert mem.stats.total_bytes == mem.peak_bytes - mem.baseline_bytes
    assert mem.stats.temp_bytes >= 0


def test_cli_exits_2_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert M.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_store_name_of_the_card():
    assert M.store_name(DEVICE) == "h100_80gb_hbm3_700w"


def test_measured_dir_is_under_experiments():
    assert measured_dir() == repo_root() / "experiments" / "measured"


CPU_CELLS = [("llava15-7b", "train", 24, "llava_stage1", "adamw"),
             ("llava15-7b", "prefill", 24, "full", None),
             ("llava15-7b", "decode", 12, "full", None),
             ("seamless-m4t-large-v2", "train", 16, "full", "adamw"),
             ("seamless-m4t-large-v2", "prefill", 16, "full", None),
             ("seamless-m4t-large-v2", "decode", 12, "full", None),
             ("mamba2-1.3b", "train", 40, "full", "adamw"),
             ("mamba2-1.3b", "prefill", 40, "full", None),
             ("mamba2-1.3b", "decode", 12, "full", None),
             ("arctic-480b", "train", 16, "full", "adafactor"),
             ("arctic-480b", "prefill", 16, "full", None),
             ("arctic-480b", "decode", 12, "full", None),
             ("deepseek-v2-lite-16b", "prefill", 16, "full", None),
             ("deepseek-v2-lite-16b", "decode", 12, "full", None),
             ("minicpm3-4b", "train", 16, "full", "adafactor"),
             ("minicpm3-4b", "prefill", 16, "full", None),
             ("minicpm3-4b", "decode", 12, "full", None)]


@pytest.mark.parametrize("arch,kind,seq,policy,opt", CPU_CELLS)
def test_step_closures_run_on_the_cpu(arch, kind, seq, policy, opt):
    cell = M.MeasureCell(arch, kind, seq, 2, policy, opt,
                         "block" if kind == "train" else None)
    model = build_model(get_config(arch).reduced())
    gen = torch.Generator().manual_seed(0)
    state = M.make_state(cell, model, gen, "cpu")
    with mesh_context(M.MESH):               # as run_cell runs a cell
        out = M.cell_step(cell, model, state, gen)()
    M.check_outputs(cell, model, out)
    if kind == "train":
        assert len(out["loss"]) == M.TRAIN_STEPS
        assert int(out["state"].step) == M.TRAIN_STEPS
    else:
        assert tuple(out["logits"].shape) == (2, 1, model.cfg.vocab)
    if kind == "decode" and model.cfg.family != "ssm":
        assert int(out["cache"]["len"][0]) == seq
        leaf = "latent" if model.cfg.mla else "k"
        assert out["cache"]["blocks"][leaf].shape[2] == seq


def test_summary_of_a_store():
    """The error table on records whose 'measured' bytes are their
    predictions times a factor per arch: raw MAPE is that factor's
    distance from 1, the tables' rows cover every arch x kind."""
    factors = {"llava15-7b": 1.2, "mamba2-1.3b": 0.9}
    cells = [c for c in M.GRID if c.arch in factors]
    records = []
    for c in cells:
        peak = M.predict(c).peak_bytes
        records.append(record(c, fake_memory(
            int(peak * factors[c.arch]))))
    out = M.summary(M.store_of(records))
    rows = {r["group"]: r for r in out["rows"]}
    assert out["cells"] == len(cells)
    assert rows["llava15-7b train"]["mape_raw_tpu"] == pytest.approx(
        100 * 0.2 / 1.2, abs=1e-6)
    assert rows["SSM"]["mape_raw_tpu"] == pytest.approx(100 * 0.1 / 0.9,
                                                        abs=1e-6)
    assert rows["all cells"]["cells"] == len(cells)
    assert rows["all cells"]["held_out_cells"] == len(cells) // 2
    assert rows["all multimodal training cells"]["cells"] == sum(
        c.kind == "train" and get_config(c.arch).family in ("vlm", "encdec")
        for c in cells)
    assert rows["llava15-7b train"]["worst_measured_over_predicted"] \
        == pytest.approx(1.2, abs=1e-6)


# ---------------------------------------------------------------------------
# the card's committed store
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card_store():
    with open(STORE) as f:
        return json.load(f)


def test_card_store_predicts_as_the_reference(card_store):
    got = TMS.MeasurementStore.from_dict(card_store)
    want = RMS.MeasurementStore.from_dict(card_store)
    assert len(got) == len(want) >= 35
    for g, w in zip(got, want):
        assert g.backend == "tpu" and g.chip == "h100" \
            and g.meta["device"]["name"]
        assert TRES.predict_measurement(g).peak_bytes \
            == RRES.predict_measurement(w).peak_bytes, g.key


def perf_table() -> dict:
    """The rows of PERF.md's card MAPE table: group -> (cells, raw tpu,
    raw cpu, held-out calibrated or None)."""
    text = open(os.path.join(repo_root(), "PERF.md")).read()
    block = text.split("<!-- card-mape-table -->")[1]
    rows = {}
    for line in block.strip().splitlines()[2:]:
        if not line.startswith("|"):
            break
        cols = [c.strip() for c in line.strip("|").split("|")]
        num = (lambda s: None if s in ("—", "-", "") else float(s))
        rows[cols[0].strip("*")] = (int(cols[1]), num(cols[2]),
                                    num(cols[3]), num(cols[4]))
    return rows


def test_card_store_gives_perf_md_table(card_store):
    out = M.summary(TMS.MeasurementStore.from_dict(card_store))
    table = perf_table()
    assert {r["group"] for r in out["rows"]} == set(table)
    for r in out["rows"]:
        n, raw, raw_cpu, held = table[r["group"]]
        assert n == r["cells"], r["group"]
        assert raw == pytest.approx(r["mape_raw_tpu"], abs=0.01)
        assert raw_cpu == pytest.approx(r["mape_raw_cpu"], abs=0.01)
        if r["mape_held_out"] is None:
            assert held is None, r["group"]
        else:
            assert held == pytest.approx(r["mape_held_out"], abs=0.01)


def test_card_store_has_the_ssm_training_rows(card_store):
    """The SSM's training cells were measured on the card (the committed
    store holds every GRID cell) and the summary recomputes their row
    and the SSM family's from the store on the CPU."""
    store = TMS.MeasurementStore.from_dict(card_store)
    grid = {(c.arch, c.shape) for c in M.GRID}
    held = {(m.arch, m.meta["shape"]) for m in store}
    assert held == grid
    ssm_train = [m for m in store
                 if m.arch == "mamba2-1.3b" and m.kind == "train"]
    assert len(ssm_train) == 5
    assert {m.remat for m in ssm_train} == {"block", "none"}
    rows = {r["group"]: r for r in M.summary(store)["rows"]}
    assert rows["mamba2-1.3b train"]["cells"] == 5
    assert rows["SSM"]["cells"] == 9
    table = perf_table()
    for group in ("mamba2-1.3b train", "SSM"):
        assert table[group][1] == pytest.approx(
            rows[group]["mape_raw_tpu"], abs=0.01)


def test_card_store_has_the_mla_rows(card_store):
    """The MLA archs' six cells were measured on the card:
    deepseek-v2-lite-16b prefill and decode, minicpm3-4b prefill, decode
    and Adafactor training at 4 and 8 x 2,048; their rows recompute from
    the store as PERF.md's table gives them."""
    store = TMS.MeasurementStore.from_dict(card_store)
    mla = sorted((m.arch, m.meta["shape"]) for m in store
                 if m.arch in ("deepseek-v2-lite-16b", "minicpm3-4b"))
    assert mla == sorted((c.arch, c.shape) for c in M.GRID
                         if c.arch in ("deepseek-v2-lite-16b",
                                       "minicpm3-4b"))
    assert len(mla) == 6
    assert {m.optimizer for m in store if m.arch == "minicpm3-4b"
            and m.kind == "train"} == {"adafactor"}
    rows = {r["group"]: r for r in M.summary(store)["rows"]}
    table = perf_table()
    for group in ("deepseek-v2-lite-16b prefill",
                  "deepseek-v2-lite-16b decode", "minicpm3-4b prefill",
                  "minicpm3-4b decode", "minicpm3-4b train"):
        assert table[group][0] == rows[group]["cells"]
        assert table[group][1] == pytest.approx(
            rows[group]["mape_raw_tpu"], abs=0.01)


def test_card_store_has_the_hybrid_rows(card_store):
    """zamba2-2.7b's six cells were measured on the card: prefill 4 x
    2,048, decode 16 x 4,096 and 1 x 524,288, AdamW training at 1 and 4 x
    2,048 and Adafactor at 8 x 2,048; their rows and the MoE and hybrid
    family rows recompute from the store as PERF.md's table gives them."""
    store = TMS.MeasurementStore.from_dict(card_store)
    hybrid = sorted((m.arch, m.meta["shape"]) for m in store
                    if m.arch == "zamba2-2.7b")
    assert hybrid == sorted((c.arch, c.shape) for c in M.GRID
                            if c.arch == "zamba2-2.7b")
    assert len(hybrid) == 6
    rows = {r["group"]: r for r in M.summary(store)["rows"]}
    table = perf_table()
    for group in ("zamba2-2.7b prefill", "zamba2-2.7b decode",
                  "zamba2-2.7b train", "hybrid", "MoE"):
        assert table[group][0] == rows[group]["cells"], group
        assert table[group][1] == pytest.approx(
            rows[group]["mape_raw_tpu"], abs=0.01)
    assert rows["hybrid"]["cells"] == 6 and rows["MoE"]["cells"] == 2


def test_grid_counts_a_state_once_no_later_cell_reads_it(monkeypatch):
    """``measure_grid`` runs the cells in order, each reusing the state
    of the one before it where they share it, and counts a cell's step
    only once the last cell of its state was measured: no measured step
    reads a state that a counted step updated.  The records come in the
    grid's order, each with its own counter and time."""
    events, states = [], []

    def run_cell(cell, reuse=None, device="cuda"):
        if reuse is None:
            states.append(object())
        state = states[-1]
        assert reuse is None or reuse.state is state
        events.append(("run", cell.shape))
        return M.CellRun(cell=cell, memory=fake_memory(1 << 30),
                         outputs={}, state=state, baseline=0, resident=0,
                         step_s=0.25 + len(events))

    def count_cell(cell, state, device="cuda"):
        assert state is states[-1]
        events.append(("count", cell.shape))
        c = DM.StepCounter()
        c.flops = len(events)
        return c

    monkeypatch.setattr(M, "run_cell", run_cell)
    monkeypatch.setattr(M, "count_cell", count_cell)
    monkeypatch.setattr(M, "card_identity", lambda: DEVICE)
    cells = [c for c in M.GRID if c.arch == "llava15-7b"]
    seen = []
    records = M.measure_grid(cells, "cpu", on_record=seen.append)
    assert [r["shape"] for r in records] == [c.shape for c in cells]
    assert seen == records
    # each state's cells: all measured, then all counted
    groups = [[cells[0]]]
    for c in cells[1:]:
        if M.same_state(groups[-1][-1], c):
            groups[-1].append(c)
        else:
            groups.append([c])
    want = []
    for g in groups:
        want += [("run", c.shape) for c in g]
        want += [("count", c.shape) for c in g]
    assert events == want and len(states) == len(groups) == 3
    assert len({r["cost"]["flops_per_device"] for r in records}) \
        == len(records)
    assert all(r["step_s"] > 0 for r in records)
