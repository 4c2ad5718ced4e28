"""Port of the memory autopilot (``repro_torch.autopilot``: the watch, the
mitigation planner, the guard, the drift-scenario harness and the CLI)
against the reference's ``repro.autopilot``, on the CPU.

Every test of tests/test_autopilot.py that concerns the autopilot runs
both packages on the same inputs and holds the port to the reference's
answer exactly (integers and the same floats): telemetry ingest, the
watch's state sequences, the planner's ranked candidates, the guard's
re-validation against ``planner.check`` (and a tampered plan refused),
``on_restart``, every scenario's ``ScenarioResult`` field by field, the
continual refit's events, and the CLI's stdout and exit status.  The
port's planner searches on the host here (``compute_engine="numpy"`` or
the torch engine with ``device="cpu"``); its default, the card, is
refused when no card is present.
"""

import dataclasses
import json

import pytest
import torch

from repro import autopilot as RA
from repro.autopilot import harness as RH
from repro.configs import ShapeConfig as RShape
from repro.core import planner as RPL
from repro.core.spec import FULL_TRAIN as R_FULL
from repro_torch import autopilot as TA
from repro_torch.autopilot import harness as TH
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.core import planner as TPL
from repro_torch.core import sweep as TSW
from repro_torch.core.spec import FULL_TRAIN as T_FULL

GOOD_MEM = {"argument_bytes": 100, "output_bytes": 40, "temp_bytes": 70,
            "alias_bytes": 10}
HOST = {"numpy": dict(compute_engine="numpy"),
        "torch_cpu": dict(compute_engine="torch", device="cpu")}


@pytest.fixture(scope="module")
def port_engine():
    return TSW.SweepEngine()


def headrooms(ref_engine, port_engine, frac=RH.BASE_FRAC):
    """The harness's budget normalization in each package (equal)."""
    ref = ref_engine.evaluate(RA.base_cell(), policy=R_FULL).peak_bytes
    port = port_engine.evaluate(TA.base_cell(), policy=T_FULL).peak_bytes
    assert ref == port
    return (ref / frac) / RPL.chip_hbm("v5e")


def cell_dict(cell) -> dict:
    return dataclasses.asdict(cell)


def mitigation_rows(cands) -> list:
    return [(m.action, cell_dict(m.cell), m.predicted_bytes,
             m.projected_bytes, m.budget_bytes, m.throughput_cost, m.note,
             m.safe, str(m)) for m in cands]


# -- telemetry ingest --------------------------------------------------------


RECORDS = [{"memory": {"total_bytes": 123}}, {"memory": GOOD_MEM}, GOOD_MEM,
           {**GOOD_MEM, "total_bytes": 7}, None, 17, "nope", [], {},
           {"memory": None}, {"memory": []}, {"memory": {}},
           {"memory": {"argument_bytes": 1}},
           {"memory": {**GOOD_MEM, "temp_bytes": None}},
           {"memory": {**GOOD_MEM, "temp_bytes": "NaNish"}},
           {"memory": {"total_bytes": 0}}, {"memory": {"total_bytes": -5}},
           {"memory": {"total_bytes": "garbage"}},
           {"memory": {"argument_bytes": 5, "output_bytes": 5,
                       "temp_bytes": 0, "alias_bytes": 10}}]


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_observed_bytes_matches_the_reference(i):
    assert TA.observed_bytes(RECORDS[i]) == RA.observed_bytes(RECORDS[i])


def test_load_and_scan_dryrun_match_the_reference(tmp_path):
    (tmp_path / "a.json").write_text(json.dumps({"memory": GOOD_MEM}))
    (tmp_path / "b.json").write_text("{ not json")
    (tmp_path / "c.txt").write_text("ignored")
    (tmp_path / "d.json").write_text(json.dumps({"memory": GOOD_MEM})[:25])
    (tmp_path / "e.json").write_text(json.dumps(
        {"memory": {"total_bytes": 0}}))
    assert TA.scan_dryrun_dir(str(tmp_path)) == \
        RA.scan_dryrun_dir(str(tmp_path)) == [
            ("a.json", 200), ("b.json", None), ("d.json", None),
            ("e.json", None)]
    for name in ("a.json", "b.json", "missing.json"):
        assert TA.load_dryrun(str(tmp_path / name)) == \
            RA.load_dryrun(str(tmp_path / name))
    assert TA.scan_dryrun_dir(str(tmp_path / "nope")) == []


# -- the watch ---------------------------------------------------------------


WATCH_SEQUENCES = {
    "safe_drift_critical": ([1000, 1200, 1300], {}),
    "slow_leak": ([1100] * 12, {}),
    "unusable": ([None, 0, -123, {"memory": {"total_bytes": 0}},
                  {"memory": {}}, 1000, {"memory": GOOD_MEM}], {}),
    "tight": ([900, 1000, 1100, 1150, 1190, 1240, 1260, 900],
              {"drift_tolerance": 1.02, "guard_frac": 0.9,
               "ewma_alpha": 0.5}),
}


@pytest.mark.parametrize("name", list(WATCH_SEQUENCES))
def test_watch_state_sequences_match_the_reference(name):
    seq, kw = WATCH_SEQUENCES[name]
    out = {}
    for pkg, mod in (("ref", RA), ("port", TA)):
        w = mod.MemoryWatch(predicted_bytes=1000, budget_bytes=1250, **kw)
        samples = [w.observe(i, obs) for i, obs in enumerate(seq)]
        out[pkg] = [(s.step, s.state.value, s.observed_bytes,
                     s.predicted_bytes, s.projected_bytes, s.budget_bytes,
                     s.ewma_ratio, s.headroom_bytes) for s in samples]
    assert out["port"] == out["ref"]


def test_watch_repredict_and_guards_match_the_reference():
    for mod in (RA, TA):
        w = mod.MemoryWatch(predicted_bytes=1000, budget_bytes=1250)
        w.observe(0, 1400)
        ratio = w.ewma_ratio
        w.repredict(500, reset_ewma=False)
        assert (w.predicted_bytes, w.ewma_ratio) == (500, ratio)
        w.repredict(500)
        assert w.ewma_ratio == 1.0
        with pytest.raises(ValueError):
            w.repredict(0)
        with pytest.raises(ValueError):
            mod.MemoryWatch(predicted_bytes=0, budget_bytes=1)


# -- mitigation planning -----------------------------------------------------


@pytest.mark.parametrize("host", list(HOST))
@pytest.mark.parametrize("ratio", [1.0, 1.1, 1.2, 1.6, 50.0])
def test_planner_candidates_match_the_reference(ratio, host, sweep_engine,
                                                port_engine):
    """Action, mutated cell, predicted / projected bytes, safety, cost,
    note and order — the reshard's ``plan_min_chips`` included (ratio 50:
    nothing on the mesh is safe)."""
    hr = headrooms(sweep_engine, port_engine)
    ref = RA.MitigationPlanner(engine=sweep_engine, policy=R_FULL,
                               headroom=hr).plan(RA.base_cell(),
                                                 ewma_ratio=ratio)
    port = TA.MitigationPlanner(engine=port_engine, policy=T_FULL,
                                headroom=hr, **HOST[host]).plan(
        TA.base_cell(), ewma_ratio=ratio)
    assert mitigation_rows(port.candidates) == \
        mitigation_rows(ref.candidates)
    assert (port.projected_bytes, port.budget_bytes, port.ewma_ratio,
            port.reaches_safety, cell_dict(port.cell)) == \
        (ref.projected_bytes, ref.budget_bytes, ref.ewma_ratio,
         ref.reaches_safety, cell_dict(ref.cell))
    if ratio == 50.0:
        assert "reshard" in {c.action for c in port.candidates}
    if ratio == 1.2:
        assert port.best.action == "grad_accum"


def test_planner_without_a_card_refuses_its_default(port_engine,
                                                   sweep_engine,
                                                   monkeypatch):
    """The reshard search runs on the card by default: with none present
    it raises, never a quiet run on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    planner = TA.MitigationPlanner(
        engine=port_engine, policy=T_FULL,
        headroom=headrooms(sweep_engine, port_engine))
    assert (planner.compute_engine, planner.device) == ("torch", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        planner.plan(TA.base_cell(), ewma_ratio=50.0)


# -- the guard ---------------------------------------------------------------


def test_applied_mitigation_validates_like_the_reference(sweep_engine,
                                                         port_engine):
    hr = headrooms(sweep_engine, port_engine)
    rp = RA.Autopilot(cell=RA.base_cell(), engine=sweep_engine, headroom=hr)
    tp = TA.Autopilot(cell=TA.base_cell(), engine=port_engine, headroom=hr,
                      compute_engine="numpy")
    rm, tm = rp.mitigate(step=0, ewma_ratio=1.2), tp.mitigate(
        step=0, ewma_ratio=1.2)
    assert mitigation_rows([tm]) == mitigation_rows([rm])
    assert cell_dict(tp.cell) == cell_dict(rp.cell) == cell_dict(tm.cell)
    assert tp.events == rp.events
    c = tm.cell
    ref = TPL.check(c.arch, TShape("t", c.seq_len, c.global_batch, "train"),
                    c.mesh_shape, backend=c.backend,
                    grad_accum=c.grad_accum, remat=c.remat,
                    optimizer=c.optimizer, chip=c.chip, headroom=hr,
                    offload_opt=c.offload)
    assert ref.peak_bytes == tm.predicted_bytes == RPL.check(
        c.arch, RShape("t", c.seq_len, c.global_batch, "train"),
        c.mesh_shape, backend=c.backend, grad_accum=c.grad_accum,
        remat=c.remat, optimizer=c.optimizer, chip=c.chip, headroom=hr,
        offload_opt=c.offload).peak_bytes


def test_tampered_mitigation_raises(sweep_engine, port_engine):
    pilot = TA.Autopilot(cell=TA.base_cell(), engine=port_engine,
                         headroom=headrooms(sweep_engine, port_engine),
                         compute_engine="numpy")
    good = pilot.planner.plan(TA.base_cell(), ewma_ratio=1.2).best
    bogus = TA.Mitigation(action=good.action, cell=good.cell,
                          predicted_bytes=good.predicted_bytes + 1,
                          projected_bytes=good.projected_bytes,
                          budget_bytes=good.budget_bytes,
                          throughput_cost=good.throughput_cost)
    with pytest.raises(TA.MitigationError, match="failed validation"):
        pilot._apply(0, bogus)
    assert pilot.cell == TA.base_cell()       # nothing applied
    assert not pilot.applied and not pilot.events


def test_on_restart_matches_the_reference(sweep_engine, port_engine):
    hr = 3 * headrooms(sweep_engine, port_engine)
    out = {}
    for pkg, mod, eng in (("ref", RA, sweep_engine),
                          ("port", TA, port_engine)):
        pilot = mod.Autopilot(cell=mod.base_cell(), engine=eng, headroom=hr)
        before = pilot.predicted_bytes
        cell = pilot.on_restart(step=3, mesh_shape={"data": 4, "model": 1})
        with pytest.raises(ValueError):
            pilot.on_restart(mesh_shape={"data": 2, "expert": 2})
        # a resize that leaves the projection past the guard band applies
        # the top-ranked plan before the run resumes
        pilot.watch.ewma_ratio = 1.3
        squeezed = pilot.on_restart(step=4)
        out[pkg] = (before, cell_dict(cell), pilot.predicted_bytes,
                    cell_dict(squeezed), pilot.events,
                    [m.action for m in pilot.applied])
    assert out["port"] == out["ref"]
    assert out["port"][1]["mesh"] == (("data", 4), ("model", 1))


# -- the closed loop ---------------------------------------------------------


@pytest.mark.parametrize("chip", ["v5e", "h100"])
@pytest.mark.parametrize("guarded", [True, False])
@pytest.mark.parametrize("name", [s.name for s in RA.SCENARIOS])
def test_scenario_results_match_the_reference(name, guarded, chip,
                                              sweep_engine, port_engine):
    ref = RA.run_scenario(RA.scenario(name), guarded, engine=sweep_engine,
                          chip=chip)
    port = TA.run_scenario(TA.scenario(name), guarded, engine=port_engine,
                           chip=chip, device="cpu")
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert str(port) == str(ref)
    if guarded:
        assert port.completed and port.oom_free and port.restarts == 0
        assert port.mitigations == ["grad_accum"]
    else:
        assert port.aborted and port.restarts == 4


def test_scenario_catalogue_matches_the_reference():
    assert [dataclasses.asdict(s) for s in TA.SCENARIOS] == \
        [dataclasses.asdict(s) for s in RA.SCENARIOS]
    assert (TH.BASE_FRAC, TH.HARNESS_ARCH, TH.HARNESS_MESH, TH.HARNESS_BATCH,
            TH.HARNESS_SEQ) == (RH.BASE_FRAC, RH.HARNESS_ARCH,
                                RH.HARNESS_MESH, RH.HARNESS_BATCH,
                                RH.HARNESS_SEQ)
    assert (TA.COST_PRIOR, TA.REMAT_LADDER) == (RA.COST_PRIOR,
                                                RA.REMAT_LADDER)
    assert cell_dict(TA.base_cell("h100")) == cell_dict(RA.base_cell("h100"))
    for s in TA.SCENARIOS:
        assert s.crosses_budget() and s.n_steps == len(s.ratios)
    with pytest.raises(KeyError):
        TA.scenario("nope")


def test_run_all_matches_the_reference(sweep_engine, port_engine):
    ref = RA.run_all(engine=sweep_engine)
    port = TA.run_all(engine=port_engine, compute_engine="numpy")
    assert [dataclasses.asdict(r) for r in port] == \
        [dataclasses.asdict(r) for r in ref]


# -- continual refit ---------------------------------------------------------


def _refit_run(mod, engine, hr, n=20, over=1.08, **kw):
    pilot = mod.Autopilot(cell=mod.base_cell(), engine=engine, headroom=hr,
                          refit=True, **kw)
    base = pilot.predicted_bytes
    obs = int(over * base)
    states = [pilot.observe(step, obs).state.value for step in range(n)]
    pilot.observe(n, None)
    return pilot, (base, states, pilot.events, pilot.refits,
                   len(pilot.store), pilot.predicted_bytes,
                   [m.action for m in pilot.applied],
                   pilot.residual.model_hash if pilot.residual else None)


def test_refit_events_match_the_reference(sweep_engine, port_engine):
    hr = 3 * headrooms(sweep_engine, port_engine)
    rp, ref = _refit_run(RA, sweep_engine, hr, refit_min_samples=8)
    tp, port = _refit_run(TA, port_engine, hr, refit_min_samples=8)
    assert port == ref
    assert tp.refits == 1 and not tp.applied and port[1][-1] == "safe"
    assert tp.planner.residual is tp.residual
    for rm, tm in zip(rp.store.measurements, tp.store.measurements):
        assert tm.to_dict() == rm.to_dict()


def test_refit_budget_and_sample_gate_match_the_reference(sweep_engine,
                                                          port_engine):
    hr = 3 * headrooms(sweep_engine, port_engine)
    _, ref = _refit_run(RA, sweep_engine, hr, n=12, over=1.1,
                        refit_min_samples=5, max_refits=0)
    _, port = _refit_run(TA, port_engine, hr, n=12, over=1.1,
                         refit_min_samples=5, max_refits=0)
    assert port == ref and port[3] == 0 and port[4] == 12


def test_refit_rejects_serve_cell(sweep_engine, port_engine):
    from repro_torch.serve.pool import ServeSpec
    cell = dataclasses.replace(TA.base_cell(), kind="decode",
                               serve=ServeSpec.make(block_size=16))
    with pytest.raises(ValueError, match="serve"):
        TA.Autopilot(cell=cell, engine=port_engine,
                     headroom=headrooms(sweep_engine, port_engine),
                     refit=True)


# -- the CLI -----------------------------------------------------------------


CLI_CASES = {
    "list": ["--list"],
    "scenario": ["--scenario", "underestimate"],
    "guarded_only": ["--guarded-only", "--scenario", "spike"],
    "unguarded_only": ["--unguarded-only"],
    "chip_h100": ["--chip", "h100", "--scenario", "slow-leak"],
    "all": [],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_stdout_and_exit_status_match_the_reference(case, capsys):
    from repro.autopilot.__main__ import main as ref_main
    from repro_torch.autopilot.__main__ import main as port_main
    argv = CLI_CASES[case]
    rc_ref = ref_main(argv)
    out_ref = capsys.readouterr().out
    rc_port = port_main(argv + ["--device", "cpu"])
    out_port = capsys.readouterr().out
    assert (rc_port, out_port) == (rc_ref, out_ref)
    assert rc_port == 0 and out_port


def test_cli_ingest_matches_the_reference(tmp_path, capsys):
    from repro.autopilot.__main__ import main as ref_main
    from repro_torch.autopilot.__main__ import main as port_main
    (tmp_path / "ok.json").write_text(json.dumps({"memory": GOOD_MEM}))
    (tmp_path / "bad.json").write_text("{ nope")
    for argv in (["--ingest", str(tmp_path)],
                 ["--ingest", str(tmp_path / "missing")]):
        rc_ref = ref_main(argv)
        out_ref = capsys.readouterr().out
        rc_port = port_main(argv)
        assert (rc_port, capsys.readouterr().out) == (rc_ref, out_ref)
    assert "2 artifacts, 1 unusable" in out_ref or rc_ref == 1


def test_cli_refusals(capsys, monkeypatch):
    from repro_torch.autopilot.__main__ import main
    with pytest.raises(SystemExit) as exc:
        main(["--scenario", "nope", "--device", "cpu"])
    assert exc.value.code == 2
    assert "unknown scenario" in capsys.readouterr().err
    # the default runs the guard's search on the card: none here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        main(["--scenario", "spike"])
    assert exc.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
    # the host engine needs no card
    assert main(["--scenario", "spike", "--engine", "numpy"]) == 0
