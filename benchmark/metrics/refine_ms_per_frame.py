"""Device ms of the flow network's refinement loop (the span
``woft.flow.refine``: the GRU context and the iterations; stream time
between its two events), summed over a frame's flows, a traced frame."""

from benchmark.harness import spans


def read(run):
    return spans.device_ms_per_frame(run, "woft.flow.refine")
