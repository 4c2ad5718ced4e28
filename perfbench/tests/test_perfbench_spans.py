"""The attribution of device time and idle gaps to the program's spans,
on synthetic events, and the readings taken from it."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from perfbench import breakdown
from perfbench.harness import cell as CELL
from perfbench.harness import peaks, spans, work
from perfbench.tests import reduced

FWD, BWD, OPT = spans.FORWARD, spans.BACKWARD, spans.OPTIMIZER
BLOCK, CHUNK = spans.RECOMPUTED
FLASH_FWD, FLASH_BWD = spans.FLASH["fwd"][0], spans.FLASH["bwd"][0]


def _times():
    """A step from 0 to 100 us: the forward [0, 30] holds a block [5, 25];
    the backward [30, 80] (main thread) holds a recomputed block [40, 60]
    opened on another thread; the optimizer [80, 92]."""
    host = [(0, 30, FWD), (5, 25, BLOCK), (30, 80, BWD), (40, 60, BLOCK),
            (80, 92, OPT)]
    ops = [(2, 6, 1), (10, 20, 10), (35, 45, 50), (50, 70, 55),
           (72, 78, 70), (85, 90, 85), (96, 99, None), (99, 100, 97)]
    return spans.attribute(host, ops, (0, 100))


def test_an_operation_is_under_every_span_its_launch_lies_in():
    t = _times()
    us = 1e-6
    assert t.count == {FWD: 1, BLOCK: 2, BWD: 1, OPT: 1}
    assert t.device_s[FWD] == pytest.approx(14 * us)
    assert t.device_s[BLOCK] == pytest.approx(40 * us)
    assert t.device_s[BWD] == pytest.approx(36 * us)
    assert t.device_s[OPT] == pytest.approx(5 * us)
    assert t.launches == {FWD: 2, BLOCK: 3, BWD: 3, OPT: 1}
    # the recomputed block lies inside the backward, the first inside the
    # forward; across threads, by the host's clock
    assert t.inside[(BLOCK, BWD)] == pytest.approx(30 * us)
    assert t.inside[(BLOCK, FWD)] == pytest.approx(10 * us)
    assert (FWD, BWD) not in t.inside
    assert t.unplaced == 1


def test_the_innermost_span_began_last():
    t = _times()
    us = 1e-6
    assert t.own_s[FWD] == pytest.approx(4 * us)
    assert t.own_s[BLOCK] == pytest.approx(40 * us)
    assert t.own_s[BWD] == pytest.approx(6 * us)
    assert t.own_s[spans.OUTSIDE] == pytest.approx(1 * us)
    assert sum(t.own_s.values()) == pytest.approx(
        sum(t.device_s[n] for n in (FWD, BWD, OPT)) + 1 * us)


def test_idle_gaps_go_to_the_span_under_way():
    t = _times()
    us = 1e-6
    # ops cover [2,6] [10,20] [35,45] [50,70] [72,78] [85,90] [96,100]
    assert t.busy_s == pytest.approx(59 * us)
    assert t.window_s == pytest.approx(100 * us)
    assert t.idle[FWD] == pytest.approx(2 * us + 15 * us)    # [0,2] [20,35]
    assert t.idle[BLOCK] == pytest.approx(4 * us + 5 * us)   # [6,10] [45,50]
    assert t.idle[BWD] == pytest.approx(2 * us)              # [70, 72]
    assert t.idle[OPT] == pytest.approx(7 * us)              # [78, 85]
    assert t.idle[spans.OUTSIDE] == pytest.approx(6 * us)    # [90, 96]
    assert sum(t.idle.values()) == pytest.approx(t.window_s - t.busy_s)


def _event(name, a, b, device=DeviceType.CPU, id=0, linked=0):
    return SimpleNamespace(name=name, device_type=device, id=id,
                           linked_correlation_id=linked,
                           time_range=SimpleNamespace(start=a, end=b))


def test_a_range_on_the_device_timeline_is_no_operation():
    cuda = DeviceType.CUDA
    events = [
        _event(spans.STEP, 0, 100), _event(FWD, 0, 40, id=1),
        _event("aten::mm", 5, 15, id=2), _event("cudaLaunchKernel", 6, 7,
                                                id=501, linked=2),
        _event("nvjet_gemm", 20, 30, cuda, id=501, linked=2),
        # a kernel whose launch call the trace lost: its host op's time
        _event("aten::add", 16, 18, id=3),
        _event("elementwise", 31, 33, cuda, id=502, linked=3),
        # the program's and the harness's ranges, shown on the device
        _event(FWD, 20, 33, cuda, id=1),
        _event("repro_torch.other", 20, 33, cuda, id=9),
        _event(spans.STEP, 20, 60, cuda, id=4),
        _event("memcpy", 50, 60, cuda, id=503),
    ]
    t = spans.from_events(events)
    assert t.launches == {FWD: 2} and t.count == {FWD: 1}
    assert t.device_s[FWD] == pytest.approx(12e-6)
    assert t.unplaced == 1
    assert t.busy_s == pytest.approx(22e-6)
    assert {k: (n, pytest.approx(sec)) for k, (n, sec) in t.kernels.items()} \
        == {"nvjet_gemm": (1, 10e-6), "elementwise": (1, 2e-6),
            "memcpy": (1, 10e-6)}
    with pytest.raises(RuntimeError):
        spans.from_events(events[1:])


def test_the_readings():
    w = CELL.plugin("flops", "vlm").work(
        CELL.load("vlm_stage1_8x2k").config,
        CELL.load("vlm_stage1_8x2k").traffic)
    call = w["attention"][0]
    host = [(0, 10, FWD), (10, 40, BWD), (40, 41, OPT)]
    host += [(20 + i * 0.5, 20.2 + i * 0.5, BLOCK) for i in range(32)]
    host += [(1 + i * 0.1, 1.05 + i * 0.1, FLASH_FWD) for i in range(32)]
    host += [(20 + i * 0.5, 20.1 + i * 0.5, FLASH_FWD) for i in range(32)]
    ops = [(0, 9e5, 0.5), (1e6, 2e6, 20.15), (2e6, 2.5e6, 37),
           (2.5e6, 2.5005e6, 40.5)]
    ops += [(3e6, 3e6 + 1000, 1.02 + i * 0.1) for i in range(32)]
    t = spans.attribute(host, ops, (0, 3.1e6))
    r = spans.readings(t, w)
    assert r["forward_ms"] == pytest.approx(900 + 32)
    assert r["backward_ms"] == pytest.approx(1500)
    assert r["optimizer_ms"] == pytest.approx(0.5)
    assert r["recompute_ms"] == pytest.approx(1000)
    # 64 forward spans a step: each call's forward ran twice, and 32
    # launches of 1 ms lie under them
    fwd = max(work.flash(call, "fwd", 2)[0] / peaks.BF16_FLOPS,
              work.flash(call, "fwd", 2)[1] / peaks.HBM_BYTES)
    assert r["flash_op_roofline"] == pytest.approx(100 * 64 * fwd / 32e-3)
    assert r["rmsnorm_op_roofline"] is None
    assert r["saved_gib"] is None and r["state_init_s"] is None
    rec = SimpleNamespace(name=FWD, allocated_in=2 ** 30,
                          allocated_out=5 * 2 ** 30)
    state = SimpleNamespace(name=spans.STATE, seconds=0.25)
    r = spans.readings(None, w, [rec], [state])
    assert r["saved_gib"] == 4.0 and r["state_init_s"] == 0.25
    assert r["forward_ms"] is None


def test_no_program_span_reads_nothing():
    t = spans.attribute([], [(0, 5, 1), (6, 9, 7)], (0, 10))
    assert t.idle == {spans.OUTSIDE: pytest.approx(2e-6)}
    assert t.own_s == {spans.OUTSIDE: pytest.approx(8e-6)}
    w = CELL.plugin("flops", "encdec").work(
        CELL.load("speech_full_4x2k").config,
        CELL.load("speech_full_4x2k").traffic)
    assert set(spans.readings(t, w).values()) == {None}
    # off CUDA the recorder reads the allocator as None
    cpu = SimpleNamespace(name=FWD, allocated_in=None, allocated_out=None)
    assert spans.readings(t, w, [cpu])["saved_gib"] is None


@pytest.mark.parametrize("name", reduced.CELLS)
def test_the_breakdown_on_the_cpu(name):
    out = breakdown.breakdown(reduced.cell(name), 2 ** 31 + 99, "cpu",
                              log=lambda *a, **k: None)
    r = out["readings"]
    # no device operation on the CPU: no device reading, no allocator's
    assert all(r[k] is None for k in r if k != "state_init_s")
    assert r["state_init_s"] > 0
    assert set(out["kernel_rooflines"].values()) == {None}
    assert out["count"][FWD] == 1 and out["count"][BLOCK] > 0
    assert out["device_only"]["span_events"] == []
    assert [p["name"] for p in out["phase_records"]] == \
        [FWD, BWD, OPT, spans.STATE]
    assert len(out["untraced_step_s"]) == breakdown.TIMED
    assert out["host_traced_step_s"] > 0
