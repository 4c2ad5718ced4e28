"""``python -m repro_torch.configs`` against ``python -m repro.configs``:
the arch table, ``--breakdown`` and the ``--profile`` / ``--residual-model``
table print the reference's text character for character, and every
error case exits with the reference's code and message."""

from __future__ import annotations

import pytest

from repro.configs import __main__ as REF
from repro_torch.configs import __main__ as PORT

# the fixed non-identity profile of the goldens' calibrated variant
# (tests/test_torch_predictor.py)
GOLDEN_COEFS = {"static": 1.0417, "act_saved": 0.9313,
                "act_transient": 1.1902, "overhead": 0.8641}
GOLDEN_CHIPS = {"v5e": 134217728, "*": 33554432}


def _run(main, argv, capsys):
    """(exit code, stdout, the error line of stderr without the prog)."""
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out, err = capsys.readouterr()
    lines = [ln for ln in err.splitlines() if ": error: " in ln]
    return rc, out, lines[-1].split(": error: ", 1)[1] if lines else ""


def _same(argv, capsys):
    want = _run(REF.main, argv, capsys)
    got = _run(PORT.main, argv, capsys)
    assert got == want
    return got


def test_table_equals_the_reference():
    assert PORT.table() == REF.table()


def test_main_without_arguments_prints_the_reference_table(capsys):
    rc, out, _ = _same([], capsys)
    assert rc == 0 and out.startswith("| arch")


BREAKDOWNS = {
    "smollm_pipe_1f1b": ["--arch", "smollm-360m", "--mesh",
                         "data=2,model=1,pipe=2", "--microbatches", "4"],
    "smollm_pipe_gpipe": ["--arch", "smollm-360m", "--mesh",
                          "data=2,model=1,pipe=2", "--microbatches", "4",
                          "--schedule", "gpipe"],
    "smollm_pipe_liveness": ["--arch", "smollm_360m", "--mesh",
                             "data=2,model=1,pipe=2", "--microbatches", "4",
                             "--assembly", "liveness"],
    "llava_liveness": ["--arch", "llava15_7b", "--mesh",
                       "data=4,model=2", "--assembly", "liveness",
                       "--policy", "llava_stage1"],
    "llava_pipe": ["--arch", "llava15_7b", "--mesh",
                   "data=4,model=2,pipe=2", "--microbatches", "4"],
    "deepseek_expert_context": ["--arch", "deepseek-v2-lite-16b", "--mesh",
                                "data=2,model=2,expert=4,context=2"],
    "deepseek_expert_pipe": ["--arch", "deepseek_v2_lite_16b", "--mesh",
                             "data=1,model=2,expert=2,context=2,pipe=2",
                             "--microbatches", "4", "--chip", "h100"],
    "llama_decode_serve": ["--arch", "llama3_2_3b", "--shape", "decode_32k",
                           "--mesh", "data=1,model=2", "--block-size", "16",
                           "--utilization", "0.9", "--prefix-hit-rate",
                           "0.5", "--prefix-len", "1024", "--mix",
                           "0.25:2048x1,8192x3", "--draft-arch",
                           "smollm-360m"],
    "mamba_cpu_backend": ["--arch", "mamba2-1.3b", "--backend", "cpu",
                          "--shape", "prefill_32k", "--mesh",
                          "data=4,model=1"],
}


@pytest.mark.parametrize("case", sorted(BREAKDOWNS))
def test_breakdown_prints_the_reference_text(case, capsys):
    rc, out, err = _same(["--breakdown"] + BREAKDOWNS[case], capsys)
    assert rc == 0 and not err
    assert "per-module breakdown" in out


def test_breakdown_function_equals_the_reference():
    from repro.serve.fleet import parse_mix as ref_mix
    from repro.serve.pool import ServeSpec as RefSpec
    from repro_torch.serve.fleet import parse_mix as port_mix
    from repro_torch.serve.pool import ServeSpec as PortSpec

    def spec(cls, mix):
        return cls.make(block_size=16, utilization=0.9,
                        prefix_hit_rate=0.5, prefix_len=1024,
                        mix=mix("0.25:2048x1,8192x3"),
                        draft_arch="smollm-360m")
    kw = dict(shape="decode_32k", mesh={"data": 1, "model": 2},
              chip="h100")
    want = REF.breakdown("llama3_2_3b", serve=spec(RefSpec, ref_mix), **kw)
    got = PORT.breakdown("llama3_2_3b", serve=spec(PortSpec, port_mix),
                         **kw)
    assert got == want and "serving: block 16" in got


def _profile_files(tmp_path):
    from repro.calibrate.learned import FEATURE_NAMES, ResidualModel
    from repro.calibrate.profile import CalibrationProfile
    profile = CalibrationProfile(coefficients=dict(GOLDEN_COEFS),
                                 chip_constant_bytes=dict(GOLDEN_CHIPS))
    p = tmp_path / "profile.json"
    profile.save(str(p))
    w = tuple(round(0.013 * ((i * 7) % 5 - 2), 4) for i in range(17))
    residual = ResidualModel.from_dict({
        "schema_version": 1, "kind": "residual_model",
        "features": list(FEATURE_NAMES), "families": {"vlm": list(w)},
        "global": [x / 2 for x in w],
        "base_profile_hash": profile.profile_hash,
        "created": "", "source": {}, "fit": {}})
    r = tmp_path / "residual.json"
    residual.save(str(r))
    return str(p), str(r)


@pytest.mark.parametrize("extra", [
    [], ["--chip", "h100", "--mesh", "data=8,model=2", "--shape",
         "prefill_32k"]], ids=["default_cell", "h100_prefill"])
def test_profile_table_prints_the_reference_text(extra, tmp_path, capsys):
    profile, _ = _profile_files(tmp_path)
    rc, out, err = _same(["--profile", profile] + extra, capsys)
    assert rc == 0 and not err and "calibrated GiB" in out


def test_residual_model_table_prints_the_reference_text(tmp_path, capsys):
    profile, residual = _profile_files(tmp_path)
    rc, out, err = _same(["--profile", profile, "--residual-model",
                          residual], capsys)
    assert rc == 0 and not err and "learned GiB" in out


ERRORS = {
    # tests/test_serve.py
    "serve_knob_on_train_shape": ["--breakdown", "--arch", "smollm_360m",
                                  "--block-size", "16"],
    "serve_knob_needs_breakdown": ["--block-size", "16"],
    # tests/test_stages.py
    "breakdown_needs_arch": ["--breakdown"],
    "assembly_needs_breakdown": ["--assembly", "liveness"],
    "breakdown_and_profile": ["--breakdown", "--arch", "smollm_360m",
                              "--profile", "p.json"],
    "unknown_arch": ["--breakdown", "--arch", "gpt-9"],
    "unknown_policy": ["--breakdown", "--arch", "smollm_360m", "--policy",
                       "lora"],
    "unknown_chip": ["--breakdown", "--arch", "smollm_360m", "--chip",
                     "a100"],
    "bad_mesh": ["--breakdown", "--arch", "smollm_360m", "--mesh",
                 "data=two"],
    "expert_on_dense": ["--breakdown", "--arch", "smollm_360m", "--mesh",
                        "data=2,expert=2"],
    "bad_mix": ["--breakdown", "--arch", "llama3_2_3b", "--shape",
                "decode_32k", "--mix", "2:xx"],
    "unknown_draft": ["--breakdown", "--arch", "llama3_2_3b", "--shape",
                      "decode_32k", "--draft-arch", "gpt-9"],
    "residual_needs_profile": ["--residual-model", "r.json"],
    "cell_flags_need_profile": ["--chip", "h100", "--shape", "train_4k"],
    "missing_profile_file": ["--profile", "no_such_profile.json"],
    "bad_schedule": ["--breakdown", "--arch", "smollm_360m", "--schedule",
                     "zb"],
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_exit_as_the_reference(case, capsys, tmp_path,
                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc, out, err = _same(ERRORS[case], capsys)
    assert rc == 2 and err and not out
