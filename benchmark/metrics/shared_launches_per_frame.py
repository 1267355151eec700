"""Host calls that put work on the device (kernel and graph launches) in
the traced window, a tracked frame: ``host_launches_per_frame``'s count a
traced call over the frames a call hands (the traffic's ``chunk``)."""

from benchmark.harness import spec

_calls = spec.load_module(spec.HERE / "metrics" / "host_launches_per_frame.py",
                          "benchmark_metric_host_launches_per_frame")


def read(run):
    n = _calls.read(run)
    return None if n is None else n / run.traffic["chunk"]
