"""Device ms of the convolution kernels (cuDNN's, their layout transposes
included) in the traced window, a frame."""

from benchmark.harness import trace as tr


def read(run):
    t = run.trace
    if t is None:
        return None
    s = tr.kernel_seconds(t, lambda n: tr.category(n) == "convolution")
    return s * 1e3 / t.frames if s else None
