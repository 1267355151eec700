"""Device idle ms that the host shell holds (``harness/trace.py``'s idle
gaps whose middle falls inside ``woft.track`` but outside ``woft.step``:
the frame's upload and the answer's readback), a traced frame."""

from benchmark.harness import spans


def read(run):
    if spans.frame_trees(run) is None:
        return None
    idle = spans.idle_by_owner(run.trace)
    return None if idle is None else idle["shell"] * 1e3 / run.trace.frames
