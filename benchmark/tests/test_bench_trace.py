"""The traced window's reduction on synthetic event lists."""

import pytest

from benchmark.harness import spec
from benchmark.harness import trace as tr
from benchmark.run import Run

I = tr.Interval


def synthetic():
    # kernels overlap (1-3 and 2-4 count once); the window is the frames'
    # span, so the idle time before the first kernel and after the last
    # counts
    kernels = [I("k1", 1, 3), I("k2", 2, 4), I("memcpy", 6, 7)]
    calls = [I("aten::a", 0, 5), I("cudaLaunchKernel", 0.6, 0.7),
             I("cudaLaunchKernel", 2.0, 2.1), I("cuLaunchKernel", 8.2, 8.3),
             I("aten::c", 8, 9), I("cudaLaunchKernel", 12, 13)]
    return tr.Trace(kernels, calls, (0.0, 10.0), 2)


def readers(cell="woft-720p-online"):
    return {m["name"]: r for m, r in spec.Cell(cell).metrics(True)}


def test_busy_is_the_union_over_the_whole_window():
    t = synthetic()
    assert tr.busy_s(t) == pytest.approx(4.0)
    assert tr.idle_gaps(t) == [(0.0, 1), (4, 6), (7, 10.0)]
    run = Run(trace=t)
    assert readers()["device_idle_share"].read(run) == pytest.approx(60.0)


def test_gaps_by_what_the_host_did():
    b = tr.breakdown(synthetic())
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"aten::a": 1.0, "python": 2.0, "aten::c": 3.0})
    assert dict(b["device_ops"]) == pytest.approx(
        {"k1": 2.0, "k2": 2.0, "memcpy": 1.0})


def test_innermost_call():
    calls = [I("outer", 0, 10), I("inner", 2, 4), I("late", 9, 12)]
    got = tr.innermost_calls(calls, [1.0, 3.0, 5.0, 9.5, 11.0, 13.0])
    assert [c.name if c else None for c in got] == [
        "outer", "inner", "outer", "late", "late", None]


def test_launches_a_frame_within_the_window():
    run = Run(trace=synthetic())
    assert readers()["host_launches_per_frame"].read(run) == 1.5


def test_categories():
    assert tr.category("void corr_lookup_kernel<4>(Levels)") == \
        "kernel B (corr lookup)"
    assert tr.category("local_corr_bf16_kernel") == "kernel C (local volume)"
    assert tr.category("sm90_xmma_fprop_implicit_gemm_f32f32") == \
        "convolution"
    assert tr.category("void geqrf_kernel") == "qr / solve"
    assert tr.category("Memcpy HtoD (Pageable -> Device)") == "copy"


def test_layer_times_and_nothing_to_read():
    t = tr.Trace([I("cudnn::fprop", 0, 0.004), I("geqrf", 0.004, 0.005)],
                 [], (0.0, 0.01), 2)
    r = readers()
    assert r["conv_ms_per_frame"].read(Run(trace=t)) == pytest.approx(2.0)
    assert r["fit_ms_per_frame"].read(Run(trace=t)) == pytest.approx(0.5)
    none = tr.Trace([I("k", 0, 1)], [], (0, 1), 1)
    none.records = [{"ok": True}]
    none.counters = {}
    for name in ("conv_ms_per_frame", "fit_ms_per_frame",
                 "host_launches_per_frame", "corr_lookup_roofline"):
        assert r[name].read(Run(trace=none)) is None
    assert r["step_mfu"].read(Run(trace=None)) is None
