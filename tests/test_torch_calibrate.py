"""The port's calibration pipeline (``repro_torch.calibrate``) against the
reference package's (``repro.calibrate``) on the same inputs: the bundled
measurement fixture, the synthetic generator, the NNLS / ridge solvers,
the accuracy report, the dry-run record ingest and the CLI's files.
Profiles and residual models must serialize and hash identically; MAPE
tables must be equal to the last digit."""

import json

import numpy as np
import pytest

from repro.calibrate import fit as RF
from repro.calibrate import learned as RL
from repro.calibrate import measurements as RM
from repro.calibrate import report as RR
from repro.calibrate import residual as RD
from repro.calibrate import synthetic as RSY
from repro.calibrate.profile import CalibrationProfile as RProfile
from repro.core import sweep as RS
from repro_torch.calibrate import fit as TF
from repro_torch.calibrate import learned as TL
from repro_torch.calibrate import measurements as TM
from repro_torch.calibrate import report as TR
from repro_torch.calibrate import residual as TD
from repro_torch.calibrate import synthetic as TSY
from repro_torch.calibrate.profile import CalibrationProfile as TProfile
from repro_torch.core import sweep as SW

FIXTURE = "benchmarks/fixtures/calibration_measurements.json"
ASSEMBLIES = ("legacy", "liveness")
SOURCE = {"fixture": "calibration_measurements.json"}


@pytest.fixture(scope="module")
def stores(request):
    root = request.config.rootpath
    return (TM.MeasurementStore.load(root / FIXTURE),
            RM.MeasurementStore.load(root / FIXTURE))


@pytest.fixture(scope="module")
def engines():
    return SW.SweepEngine(), RS.SweepEngine()


@pytest.fixture(scope="module")
def fitted(stores, engines):
    """assembly -> ((port profile, port residual), (ref profile, ref
    residual)), fitted on the fixture with the same metadata."""
    out = {}
    for asm in ASSEMBLIES:
        pair = []
        for mod_f, mod_l, store, eng in ((TF, TL, stores[0], engines[0]),
                                         (RF, RL, stores[1], engines[1])):
            prof = mod_f.fit_profile(store, engine=eng, assembly=asm,
                                     created="fixed", source=SOURCE)
            res = mod_l.fit_residual(store, profile=prof, engine=eng,
                                     assembly=asm, created="fixed",
                                     source=SOURCE)
            pair.append((prof, res))
        out[asm] = tuple(pair)
    return out


def test_store_and_generator_equal_reference(stores):
    port, ref = stores
    assert port.to_dict() == ref.to_dict()
    assert len(port) == 144
    # the generator reproduces the fixture, as the reference's does
    assert TSY.generate().to_dict() == RSY.generate().to_dict() \
        == ref.to_dict()


@pytest.mark.parametrize("assembly", ASSEMBLIES)
def test_decompose_equals_reference(stores, engines, assembly):
    got = TD.decompose(stores[0], engines[0], assembly=assembly)
    ref = RD.decompose(stores[1], engines[1], assembly=assembly)
    assert len(got) == len(ref) == len(stores[0])
    for a, b in zip(got, ref):
        assert a.terms == b.terms
        assert a.raw_peak_bytes == b.raw_peak_bytes
        assert a.residual_bytes == b.residual_bytes


@pytest.mark.parametrize("assembly", ASSEMBLIES)
def test_profile_equals_reference(fitted, assembly, tmp_path):
    (prof, _), (rprof, _) = fitted[assembly]
    assert prof.to_dict() == rprof.to_dict()
    assert prof.profile_hash == rprof.profile_hash
    assert prof.summary() == rprof.summary()
    assert not prof.is_identity
    # the saved file is byte-identical and loads back into either package
    prof.save(tmp_path / "port.json")
    rprof.save(tmp_path / "ref.json")
    assert (tmp_path / "port.json").read_text() \
        == (tmp_path / "ref.json").read_text()
    assert TProfile.load(tmp_path / "ref.json").profile_hash \
        == prof.profile_hash


@pytest.mark.parametrize("assembly", ASSEMBLIES)
def test_residual_model_equals_reference(fitted, assembly, tmp_path):
    (prof, res), (rprof, rres) = fitted[assembly]
    assert res.to_dict() == rres.to_dict()
    assert res.model_hash == rres.model_hash
    assert res.base_profile_hash == prof.profile_hash
    assert res.summary() == rres.summary()
    res.save(tmp_path / "port.json")
    rres.save(tmp_path / "ref.json")
    assert (tmp_path / "port.json").read_text() \
        == (tmp_path / "ref.json").read_text()
    assert TL.ResidualModel.load(tmp_path / "ref.json").model_hash \
        == res.model_hash


def _nnls_cases():
    rng = np.random.default_rng(21)
    for m, n in ((12, 4), (40, 7), (144, 7)):
        A = rng.uniform(0.0, 5.0, (m, n))
        x = np.abs(rng.normal(size=n))
        x[rng.integers(n)] = 0.0
        yield A, A @ x + rng.normal(scale=1e-3, size=m)


@pytest.mark.parametrize("path", ["scipy", "projected_gradient"])
def test_nnls_paths_equal_reference(path, monkeypatch, stores):
    """``nnls`` through scipy, and the projected-gradient solve taken when
    scipy is missing: both equal the reference's bit for bit, and the
    fallback recovers scipy's answer to fit tolerance."""
    for A, b in _nnls_cases():
        if path == "scipy":
            x, r = TF.nnls(A, b)
            rx, rr = RF.nnls(A, b)
        else:
            x, r = TF._pg_nnls(A, b)
            rx, rr = RF._pg_nnls(A, b)
            sx, _ = RF.nnls(A, b)
            assert np.allclose(x, sx, atol=1e-6)
        assert np.array_equal(x, rx) and r == rr
        assert (x >= 0).all()
    if path == "projected_gradient":
        # with scipy unimportable the fit takes the fallback and still
        # gives the reference's profile on the same fallback
        import builtins
        real_import = builtins.__import__

        def no_scipy(name, *a, **kw):
            if name.startswith("scipy"):
                raise ImportError(name)
            return real_import(name, *a, **kw)

        monkeypatch.setattr(builtins, "__import__", no_scipy)
        got = TF.fit_profile(stores[0], created="fixed", source=SOURCE)
        ref = RF.fit_profile(stores[1], created="fixed", source=SOURCE)
        assert got.to_dict() == ref.to_dict()


def test_ridge_equals_reference():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(30, 5))
    b = rng.normal(size=30)
    for lam in (1e-3, 0.5):
        assert np.array_equal(TF.ridge(A, b, lam), RF.ridge(A, b, lam))


@pytest.mark.parametrize("by", ["family", "arch"])
@pytest.mark.parametrize("assembly", ASSEMBLIES)
def test_evaluate_mape_table_equals_reference(fitted, stores, engines,
                                              assembly, by):
    (prof, res), (rprof, rres) = fitted[assembly]
    got = TR.evaluate(stores[0], prof, by=by, engine=engines[0],
                      assembly=assembly, residual=res)
    ref = RR.evaluate(stores[1], rprof, by=by, engine=engines[1],
                      assembly=assembly, residual=rres)
    assert got.to_json_dict() == ref.to_json_dict()
    assert got.to_markdown(title="t") == ref.to_markdown(title="t")
    assert got.to_csv() == ref.to_csv()
    assert got.all_groups_improved and ref.all_groups_improved
    assert got.mape_learned <= got.mape_calibrated < got.mape_raw


def test_leave_one_family_out_equals_reference(stores, engines):
    """The folds, and each fold's holdout MAPE (profile + residual fitted
    on the other families), equal the reference's."""
    got = TL.leave_one_family_out(stores[0])
    ref = RL.leave_one_family_out(stores[1])
    assert [f for f, _, _ in got] == [f for f, _, _ in ref]
    assert len(got) == 6
    for (fam, train, test), (_, rtrain, rtest) in zip(got, ref):
        assert train.to_dict() == rtrain.to_dict()
        assert test.to_dict() == rtest.to_dict()
        prof = TF.fit_profile(train, engine=engines[0])
        rprof = RF.fit_profile(rtrain, engine=engines[1])
        res = TL.fit_residual(train, profile=prof, engine=engines[0])
        rres = RL.fit_residual(rtrain, profile=rprof, engine=engines[1])
        assert fam not in res.families
        assert res.model_hash == rres.model_hash
        a = TR.evaluate(test, prof, engine=engines[0], residual=res)
        b = RR.evaluate(rtest, rprof, engine=engines[1], residual=rres)
        assert a.to_json_dict() == b.to_json_dict()


def _record(mesh="16x16", memory=None, **extra):
    rec = {"arch": "smollm-360m", "shape": "train_4k", "mesh": mesh,
           "kind": "train", "compile_seconds": 1.0,
           "memory": memory if memory is not None else {
               "argument_bytes": 1, "output_bytes": 2, "temp_bytes": 3,
               "alias_bytes": 0, "total_bytes": 7 * 1024 ** 3}}
    rec.update(extra)
    return rec


DRYRUN_CASES = {
    "2d-mesh": _record(),
    "3d-mesh": _record(mesh="2x16x16"),
    "explicit-mesh": _record(mesh_shape={"data": 8, "model": 4}),
    "counters-only": _record(memory={"argument_bytes": 5,
                                     "output_bytes": 2, "temp_bytes": 3,
                                     "alias_bytes": 1}),
    "pipelined": _record(mesh_shape={"data": 2, "model": 2, "pipe": 2},
                         microbatches=4, schedule="gpipe",
                         offload_optimizer=True),
    "counters-missing": _record(memory={"argument_bytes": 1}),
    "total-non-numeric": _record(memory={"total_bytes": "??"}),
    "counter-non-numeric": _record(memory={
        "argument_bytes": 1, "output_bytes": "x", "temp_bytes": 3,
        "alias_bytes": 0}),
    "total-zero": _record(memory={"total_bytes": 0}),
    "total-negative": _record(memory={"argument_bytes": 1,
                                      "output_bytes": 1, "temp_bytes": 1,
                                      "alias_bytes": 10}),
    "memory-not-dict": _record(memory=[1, 2]),
    "mesh-unnameable": _record(mesh="2x2x2x2"),
}


@pytest.mark.parametrize("case", sorted(DRYRUN_CASES))
def test_from_dryrun_record_equals_reference(case):
    """One dry-run record through both ingests, the telemetry defect
    matrix included: the same Measurement, or the same ValueError."""
    from repro.autopilot import watch as RW
    from repro_torch.autopilot import watch as TW
    rec = DRYRUN_CASES[case]
    assert TW.observed_bytes(rec) == RW.observed_bytes(rec)
    assert TW.observed_bytes(rec["memory"]) \
        == RW.observed_bytes(rec["memory"])
    assert TW.telemetry_defect(rec) == RW.telemetry_defect(rec)
    try:
        want = RM.Measurement.from_dryrun_record(rec, source="t.json")
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TM.Measurement.from_dryrun_record(rec, source="t.json")
        assert str(got.value) == str(e)
        return
    got = TM.Measurement.from_dryrun_record(rec, source="t.json")
    assert got.to_dict() == want.to_dict()
    assert got.measured_bytes > 0
    assert TD.predict_measurement(got).peak_bytes \
        == RD.predict_measurement(want).peak_bytes


def test_dryrun_dir_ingest_and_shared_paths(tmp_path):
    from repro.calibrate import paths as RP
    from repro_torch.calibrate import paths as TP
    assert TP.repo_root() == RP.repo_root()
    assert TP.dryrun_dir() == RP.dryrun_dir()
    assert TP.profiles_dir() == RP.profiles_dir()
    for name, rec in DRYRUN_CASES.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    (tmp_path / "trunc.json").write_text('{"arch": "smollm-360m", "mem')
    got = TM.MeasurementStore.ingest_dryrun_dir(tmp_path)
    ref = RM.MeasurementStore.ingest_dryrun_dir(tmp_path)
    assert got.to_dict() == ref.to_dict() and len(got) == 5
    with pytest.raises(ValueError):
        TM.MeasurementStore.ingest_dryrun_dir(tmp_path, strict=True)


def test_profile_loading_rules_equal_reference():
    good = TProfile(coefficients={"static": 1.1, "act_saved": 0.9,
                                  "act_transient": 1.0, "overhead": 1.0},
                    chip_constant_bytes={"v5e": 7, "*": 3})
    d = good.to_dict()
    assert good.profile_hash == RProfile.from_dict(d).profile_hash
    assert (good.chip_offset("v5e"), good.chip_offset("h100")) == (7, 3)
    for bad in (dict(d, kind="nope"), dict(d, schema_version=9),
                dict(d, terms=["static"])):
        with pytest.raises(ValueError) as e:
            RProfile.from_dict(bad)
        with pytest.raises(ValueError) as g:
            TProfile.from_dict(bad)
        assert str(g.value) == str(e.value).replace("repro.", "repro_torch.")
    with pytest.raises(ValueError, match="negative"):
        TProfile(coefficients=dict(d["coefficients"], static=-1.0))
    assert TProfile.identity().is_identity


def _run_cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("cmd", ["fit", "fit-residual", "apply", "report"])
def test_cli_files_equal_reference(cmd, tmp_path, capsys, request):
    """``python -m repro_torch.calibrate`` writes the reference CLI's
    files: the same profile and residual JSON (apart from the creation
    time), the same report markdown and JSON, the same apply output."""
    from repro.calibrate.__main__ import main as rmain
    from repro_torch.calibrate.__main__ import main as tmain
    store = str(request.config.rootpath / FIXTURE)
    out = {}
    for tag, main in (("port", tmain), ("ref", rmain)):
        d = tmp_path / tag
        d.mkdir()
        prof, res = str(d / "prof.json"), str(d / "res.json")
        rc, text = _run_cli(main, ["fit", "--measurements", store,
                                   "--out", prof], capsys)
        assert rc == 0
        runs = {"fit": text}
        if cmd != "fit":
            rc, runs["fit-residual"] = _run_cli(
                main, ["fit-residual", "--measurements", store,
                       "--profile", prof, "--out", res], capsys)
            assert rc == 0
        if cmd == "apply":
            rc, runs["apply"] = _run_cli(
                main, ["apply", "--profile", prof, "--residual-model", res,
                       "--arch", "smollm_360m", "--mesh", "data=4,model=2",
                       "--chip", "v5e"], capsys)
            assert rc == 0
        if cmd == "report":
            rc, runs["report"] = _run_cli(
                main, ["report", "--profile", prof, "--residual-model",
                       res, "--measurements", store, "--by", "family",
                       "--md", str(d / "r.md"), "--json",
                       str(d / "r.json")], capsys)
            assert rc == 0
        files = {}
        for f in sorted(d.iterdir()):
            text = f.read_text()
            if f.suffix == ".json":
                text = json.loads(text)
                text.pop("created", None)
            files[f.name] = text
        out[tag] = (runs[cmd].replace(str(d), "<dir>"), files)
    assert out["port"] == out["ref"]
    assert ("prof.json" in out["port"][1])
    if cmd == "report":
        assert "r.md" in out["port"][1] and "r.json" in out["port"][1]
