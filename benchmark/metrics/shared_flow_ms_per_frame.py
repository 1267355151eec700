"""Device ms of the one shared flow a frame (the span ``woft.flow``: the
WeightedRAFT forward from the template's features to the pre-warped frame,
the weight head's dense lookup included), a tracked frame of the traced
chunks."""

from benchmark.harness import chunk_spans


def read(run):
    return chunk_spans.device_ms_per_frame(run, ("woft.flow",))
