"""Device ms of the weight head (the span ``woft.weight_head``: its own
lookup and ``weight_head_apply``), a traced frame."""

from benchmark.harness import spans


def read(run):
    return spans.device_ms_per_frame(run, "woft.weight_head")
