"""Device ms of the homography fits (the span ``woft.fit``: the DLT
assembly, its normalisation and the QR solve, every kernel of
``_estimate_h``), a traced frame."""

from benchmark.harness import spans


def read(run):
    return spans.device_ms_per_frame(run, "woft.fit")
