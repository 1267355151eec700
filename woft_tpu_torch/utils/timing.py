"""Host timing (ref:pytracking/utils/timing.py).

The port's twin of ``woft_tpu/utils/timing.py``'s ``time_measurer``: the
host wall clock. For device time by stage use the program's spans
(``utils/profiling.py``: ``recording()``, ``recorded_spans()``), by kernel
``torch.profiler``.
"""

import inspect
import logging
import time

_UNITS = {"s": 1.0, "ms": 1000.0, "us": 1e6}


class time_measurer:
    """Call to get elapsed time; usable as a context manager that logs."""

    def __init__(self, units="s"):
        self.multiplier = _UNITS[units]
        self.units = units
        self.start = time.perf_counter()

    def __call__(self):
        return (time.perf_counter() - self.start) * self.multiplier

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *args):
        caller = inspect.currentframe().f_back
        mod = caller.f_globals.get("__name__", "?")
        logging.getLogger(mod).debug("elapsed: %.3f%s", self(), self.units)
