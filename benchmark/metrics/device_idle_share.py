"""Share of the traced window in which no operation ran on the device
(%): 1 minus the union of the device intervals over the window, which
runs from the first traced frame's call to the last one's answer."""

from benchmark.harness import trace as tr


def read(run):
    t = run.trace
    if t is None:
        return None
    return 100.0 * (1.0 - tr.busy_s(t) / t.window_s)
