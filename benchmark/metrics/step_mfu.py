"""The whole step's share of the card's peak (%): the model operations of
the window's frames (``harness/work.py:frame_flops``, from the cell's
shapes) over the window's host-clock time, against the peak of the number
format the configuration states (float32 with TF32 off: 67 TFLOP/s; bf16:
989 TFLOP/s dense). The traced run's window, before and outside the
profiler's."""


def read(run):
    if run.trace is None or not run.window_s:
        return None
    return 100.0 * run.flops / run.window_s / run.peak_flops
