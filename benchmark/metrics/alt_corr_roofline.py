"""Kernel K's share of its roofline (%): the least time of the traced
window's alternate lookups over K's device time. A lookup's least time is
the larger of its operations at 67 TFLOP/s float32 and its bytes at 3.35
TB/s (``harness/alternate_work.py``: every query's tap products and blend;
the query features, the pooled levels and the coordinates read once, the
output written once).

A flow is 13 lookups: 12 over every cell, then one for the weight head,
over every cell after a failed check (the fallback's dense head) or, on
the sparse head, over its rows (9 a point). The program's launch counter
must agree with the kernels in the trace and with 13 a flow; else the
metric is not read."""

from benchmark.harness import alternate_work as aw
from benchmark.harness import trace as tr
from benchmark.harness import work

KERNEL = "alt_corr_kernel"


def read(run):
    t = run.trace
    if t is None:
        return None
    secs = tr.kernel_seconds(t, lambda n: KERNEL in n)
    launches = sum(1 for k in t.kernels if KERNEL in k.name)
    flows = len(t.records) + sum(not r["ok"] for r in t.records)
    if (not secs or launches != t.counters.get("alt_corr_lookup")
            or launches != 13 * flows):
        return None
    m, tp = run.cell.config["model"], run.cell.config["tracker"]
    h, w = run.traffic["height"], run.traffic["width"]
    _, _, q = work.grid(h, w)
    dense = aw.bound_s(aw.alt_dense_bytes(m, h, w), aw.alt_lookup_flops(m, q))
    rows = 9 * tp["subsample_n"]
    sparse = aw.bound_s(
        aw.alt_indexed_bytes(m, h, w, run.traffic["target_frac"], rows),
        aw.alt_lookup_flops(m, rows))
    fallbacks = flows - len(t.records)
    total = (12 * flows + fallbacks) * dense + len(t.records) * sparse
    return 100.0 * total / secs
