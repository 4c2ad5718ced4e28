"""The work counts of both cells against numbers worked by hand."""

from types import SimpleNamespace

import pytest

from perfbench.harness import cell as CELL
from perfbench.harness import peaks, work
from perfbench.harness.trace import Trace


def _work(name):
    c = CELL.load(name)
    return CELL.plugin("flops", c.config["family"]).work(c.config, c.traffic)


def test_vlm_stage1_model_flops():
    layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 14336
    assert layer == 218_103_808
    tokens, img, txt = 8 * 2048, 8 * 576, 8 * 1472
    scores = 8 * 32 * (2048 * 2049 // 2)
    assert scores == 537_133_056
    proj = 2 * img * (1024 * 4096 + 4096 * 4096)
    head = 2 * txt * 4096 * 32064
    forward = proj + 32 * (2 * layer * tokens + 2 * scores * 256) + head
    # frozen LM and head: input gradients only; the projector: both
    # layers' weight gradients and the second layer's input gradient
    backward = 32 * (2 * layer * tokens + 2 * scores * 512) + head \
        + proj + 2 * img * 4096 * 4096
    w = _work("vlm_stage1_8x2k")
    assert w["model_flops"] == pytest.approx(forward + backward, rel=1e-12)
    assert w["model_flops"] == pytest.approx(4.905e14, rel=1e-3)
    assert w["positions"] == 16384


def test_speech_full_model_flops():
    enc = 4 * 1024 * 1024 + 3 * 1024 * 8192
    dec = 8 * 1024 * 1024 + 3 * 1024 * 8192
    t = 4 * 2048
    linear = 2 * t * 1024 * 1024 + 24 * 2 * t * (enc + dec) \
        + 2 * t * 1024 * 256102
    full, causal = 4 * 16 * 2048 * 2048, 4 * 16 * (2048 * 2049 // 2)
    attn = 24 * 2 * 128 * (full + causal + full)
    forward = linear + attn
    backward = 2 * linear - 2 * t * 1024 * 1024 + 2 * attn
    w = _work("speech_full_4x2k")
    assert w["model_flops"] == pytest.approx(forward + backward, rel=1e-12)
    assert w["positions"] == 16384
    assert [c["calls"] for c in w["attention"]] == [24, 24, 24]


def test_flash_and_rmsnorm_work():
    call = _work("vlm_stage1_8x2k")["attention"][0]
    q, kv = 8 * 2048 * 32 * 128, 8 * 2048 * 8 * 128
    ops, nbytes = work.flash(call, "fwd", 2)
    assert ops == 2 * 537_133_056 * 256
    assert nbytes == 2 * (2 * q + 2 * kv) + 4 * 8 * 32 * 2048
    ops, nbytes = work.flash(call, "dq", 2)
    assert ops == 2 * 537_133_056 * (2 * 128 + 128)
    assert nbytes == 2 * (4 * q + 2 * kv) + 8 * 8 * 32 * 2048
    ops, nbytes = work.flash(call, "dkv", 2)
    assert ops == 2 * 537_133_056 * 512
    assert nbytes == 2 * (2 * q + 4 * kv) + 8 * 8 * 32 * 2048
    speech = _work("speech_full_4x2k")["attention"]
    assert work.scores(speech[0]) == 4 * 16 * 2048 * 2048
    assert work.scores(speech[2]) == 4 * 16 * 2048 * 2048
    norm = _work("vlm_stage1_8x2k")["rmsnorm"]
    assert norm == [{"rows": 16384, "D": 4096, "calls": 65}]
    assert work.rmsnorm(norm[0], "fwd", 2)[1] == 2 * (2 * 16384 * 4096
                                                      + 4096)
    assert work.rmsnorm(norm[0], "bwd", 2)[1] == 2 * (3 * 16384 * 4096
                                                      + 2 * 4096)
    assert [n["calls"] for n in _work("speech_full_4x2k")["rmsnorm"]] == \
        [49, 73]


def test_mfu_and_roofline_readers():
    w = _work("vlm_stage1_8x2k")
    ctx = SimpleNamespace(window={"steps": 6, "seconds": 9.6}, work=w)
    mfu = CELL.plugin("metrics", "mfu_pct").read(ctx)
    assert mfu == pytest.approx(100 * w["model_flops"] * 6 / 9.6 / 989e12)
    # two traced steps; the forward ran twice a call (rematerialised)
    call = w["attention"][0]
    fwd_bound = max(work.flash(call, "fwd", 2)[0] / peaks.BF16_FLOPS,
                    work.flash(call, "fwd", 2)[1] / peaks.HBM_BYTES)
    tr = Trace(steps=2, window_s=3.0, busy_s=2.9,
               kernels={"flash_fwd_kernel_wgmma": [128, 0.2],
                        "ampere_gemm": [10, 1.0]})
    share = CELL.plugin("metrics", "flash_roofline").read(
        SimpleNamespace(trace=tr, work=w))
    assert share == pytest.approx(100 * 128 * fwd_bound / 0.2)
    assert CELL.plugin("metrics", "rmsnorm_roofline").read(
        SimpleNamespace(trace=tr, work=w)) is None
    idle = CELL.plugin("metrics", "device_idle_pct").read(
        SimpleNamespace(trace=tr))
    assert idle == pytest.approx(100 * (1 - 2.9 / 3.0))
