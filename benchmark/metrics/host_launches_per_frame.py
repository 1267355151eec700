"""Host calls that put work on the device (kernel and graph launches) in
the traced window, a frame."""

from benchmark.harness import trace as tr


def read(run):
    t = run.trace
    if t is None:
        return None
    lo, hi = t.window
    n = sum(1 for c in t.calls
            if c.name in tr.LAUNCH_CALLS and lo <= c.start < hi)
    return n / t.frames if n else None
