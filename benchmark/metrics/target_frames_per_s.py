"""Target-frames tracked in the window over the whole window (host clock;
the window ends when the last call holds its answer on the host)."""

from benchmark.harness import stats


def read(run):
    return stats.rate(run.answers, run.window_s)
