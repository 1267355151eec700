"""The window's statistics on synthetic timings."""

import statistics

import pytest

from benchmark.harness import stats
from benchmark.run import Run


def test_rate_is_all_work_over_the_whole_window():
    # 10 calls of 50 ms and one stall of 500 ms in a 1.0 s window
    assert stats.rate(11, 1.0) == 11.0
    with pytest.raises(ValueError):
        stats.rate(3, 0.0)


def test_p95_over_every_call():
    lat = [0.050] * 95 + [0.100] * 5
    # linear between order statistics: the 95th of 100 values
    assert stats.percentile(lat, 95) == pytest.approx(0.0525)
    assert stats.percentile([0.02, 0.04], 50) == pytest.approx(0.03)


def test_end_to_end_readers():
    from benchmark.harness import spec
    cell = spec.Cell("woft-720p-online")
    readers = {m["name"]: r for m, r in cell.metrics(False)}
    lat = [0.06] * 190 + [0.2] * 10
    run = Run(latencies_s=lat, window_s=sum(lat), answers=200, setup_s=12.5)
    assert readers["target_frames_per_s"].read(run) == pytest.approx(
        200 / sum(lat))
    assert readers["frame_ms_p95"].read(run) == pytest.approx(
        stats.percentile(lat, 95) * 1e3)
    assert readers["setup_s"].read(run) == 12.5


def test_spread_is_quartiles_over_median():
    v = [10.0, 10.2, 9.8, 10.1, 9.9, 10.0]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)
