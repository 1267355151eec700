"""Kernel M's device ms a tracked frame: the traced window's GMA
aggregations (``gma_aggregate_kernel``) over its tracked frames, one flow a
frame (the traced calls times the traffic's ``chunk``). Read only where
the trace's launches of M, the program's launch counter and the
configuration's iterations a flow agree; else (a program without kernel M)
nothing is read."""

from benchmark.harness import trace as tr

KERNEL = "gma_aggregate_kernel"


def flows_and_seconds(run):
    """(flows, M's device seconds) of the traced window, or None where the
    launches, the counter and ``iters`` a flow disagree."""
    t = run.trace
    if t is None:
        return None
    secs = tr.kernel_seconds(t, lambda n: KERNEL in n)
    launches = sum(1 for k in t.kernels if KERNEL in k.name)
    flows = t.frames * run.traffic["chunk"]
    iters = run.cell.config["model"]["iters"]
    if (not secs or launches != t.counters.get("gma_aggregate")
            or launches != iters * flows):
        return None
    return flows, secs


def read(run):
    got = flows_and_seconds(run)
    return None if got is None else 1e3 * got[1] / got[0]
