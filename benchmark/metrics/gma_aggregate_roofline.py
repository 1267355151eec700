"""Kernel M's share of its roofline (%): the least time of the traced
window's GMA aggregations over M's device time. An aggregation's least
time is the larger of its product's operations at the bf16 peak and the
bytes any exact form moves at HBM bandwidth (``harness/gma_work.py``:
``aggregate_bound_s``; no stored probability matrix, no recomputed
scores). Read where ``gma_aggregate_ms_per_frame`` reads: the launches, the
counter and the iterations a flow agree."""

from benchmark.harness import gma_work, spec
from benchmark.harness import work

_ms = spec.load_module(spec.HERE / "metrics" / "gma_aggregate_ms_per_frame.py",
                       "benchmark_metric_gma_aggregate_ms_per_frame")


def read(run):
    got = _ms.flows_and_seconds(run)
    if got is None:
        return None
    flows, secs = got
    m = run.cell.config["model"]
    _, _, q = work.grid(run.traffic["height"], run.traffic["width"])
    return 100.0 * gma_work.aggregate_bound_s(m, q) * m["iters"] * flows / secs
