"""Kernel B's share of its roofline (%): the least time of the traced
window's pyramid lookups (bytes from the cell's shapes over HBM
bandwidth: each query's in-level windows read once, its coordinates read
and its output written once; ``harness/work.py``) over B's device time.

A flow is 13 lookups: 12 over every cell, then one for the weight head,
over every cell after a failed check (the fallback's dense head) or, on
the sparse head, over the rows of the target's points' 3x3 neighbourhoods
(written once each, read as the distinct cells of the target's box). The
program's launch counter must agree with the kernels in the trace and
with 13 a flow; else the metric is not read."""

from benchmark.harness import trace as tr
from benchmark.harness import work

KERNEL = "corr_lookup_kernel"


def read(run):
    t = run.trace
    if t is None:
        return None
    secs = tr.kernel_seconds(t, lambda n: KERNEL in n)
    launches = sum(1 for k in t.kernels if KERNEL in k.name)
    flows = len(t.records) + sum(not r["ok"] for r in t.records)
    if (not secs or launches != t.counters.get("corr_pyramid_lookup")
            or launches != 13 * flows):
        return None
    m, tp = run.cell.config["model"], run.cell.config["tracker"]
    h, w = run.traffic["height"], run.traffic["width"]
    r = m["corr_radius"]
    k2 = (2 * r + 1) ** 2
    dense = work.dense_lookup_bytes(m, h, w)
    rows = 9 * tp["subsample_n"]
    cells = work.sparse_head_cells(h, w, run.traffic["target_frac"],
                                   tp["subsample_n"])
    h1, w1, _ = work.grid(h, w)
    cx, cy = w1 // 2, h1 // 2              # an interior cell: whole windows
    sparse = (cells * work.window_bytes(m, h1, w1, cx, cy)
              + rows * (8 + 4 * k2 * m["corr_levels"]))
    fallbacks = flows - len(t.records)
    total = (12 * flows + fallbacks) * dense + len(t.records) * sparse
    return 100.0 * (total / work.HBM_BYTES_PER_S) / secs
