"""95th percentile of the latency of every call in the window (ms, host
clock, from handing the frame to the program to holding its homography on
the host)."""

from benchmark.harness import stats


def read(run):
    return stats.percentile(run.latencies_s, 95) * 1e3
