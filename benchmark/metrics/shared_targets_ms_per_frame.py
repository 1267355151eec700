"""Device ms of the per-target batched work of a frame: the TC validity,
Sobol gather and weight gathers (the spans ``woft.select``, less the
weight head inside them), the fits (``woft.fit``) and the inlier checks
(``woft.check``), a tracked frame of the traced chunks."""

from benchmark.harness import chunk_spans


def read(run):
    return chunk_spans.device_ms_per_frame(
        run, ("woft.select", "woft.fit", "woft.check"),
        less=(("woft.weight_head", "woft.select"),))
