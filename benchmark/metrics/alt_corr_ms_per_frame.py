"""Device ms of the alternate correlation's lookups (every span
``woft.corr.alternate``: the loop's 12 and the weight head's one a flow;
stream time between its two events), a traced frame."""

from benchmark.harness import spans


def read(run):
    return spans.device_ms_per_frame(run, "woft.corr.alternate")
