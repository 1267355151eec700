"""Device ms of the weight head for every target of a frame (the spans
``woft.weight_head``: its lookup at the flow's end and its evaluation at
the rows the targets' points ask for), a tracked frame of the traced
chunks."""

from benchmark.harness import chunk_spans


def read(run):
    return chunk_spans.device_ms_per_frame(run, ("woft.weight_head",))
