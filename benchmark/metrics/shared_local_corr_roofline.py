"""Kernel C's share of its roofline (%) in a chunked shared-flow cell: the
least time of the traced window's block-local volumes (the larger of their
bf16 bytes over HBM bandwidth and their operations over the bf16 peak,
both from the cell's shapes: ``harness/work.py:local_volume_flops``,
``local_volume_bytes``) over C's device time. One flow a tracked frame,
whatever the targets' checks (the shared step has no fallback flow): the
traced calls times the traffic's ``chunk``; the program's launch counter
must agree with the kernels in the trace and with the flows, else the
metric is not read."""

from benchmark.harness import trace as tr
from benchmark.harness import work

KERNEL = "local_corr_"


def read(run):
    t = run.trace
    if t is None:
        return None
    secs = tr.kernel_seconds(t, lambda n: KERNEL in n)
    launches = sum(1 for k in t.kernels if KERNEL in k.name)
    flows = t.frames * run.traffic["chunk"]
    if (not secs or launches != t.counters.get("local_corr_build")
            or launches != flows):
        return None
    m = run.cell.config["model"]
    h, w = run.traffic["height"], run.traffic["width"]
    margin = run.cell.config["flow"]["local_margin"]
    one = work.bound_s(work.local_volume_bytes(m, h, w, margin),
                       work.local_volume_flops(m, h, w, margin),
                       work.PEAK_FLOPS["bf16"])
    return 100.0 * one * flows / secs
