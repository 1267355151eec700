"""Per-stage timing (ref:pytracking/utils/timing.py).

The port's twin of ``woft_tpu/utils/timing.py``: ``time_measurer`` is the
host wall clock; ``device_time_measurer`` synchronises the card around the
measured region (``torch.cuda.synchronize`` of the value's device, where
the JAX package calls ``jax.block_until_ready``), so the time covers the
queued device work. For device time by kernel use ``torch.profiler``.
"""

import inspect
import logging
import time

import torch

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


def _devices(value):
    """The CUDA devices of the tensors in ``value`` (nested tuples, lists
    and dicts)."""
    if isinstance(value, torch.Tensor):
        return {value.device} if value.is_cuda else set()
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return set().union(*map(_devices, value)) if value else set()
    return set()


class device_time_measurer(time_measurer):
    """Wall clock that synchronises the card before start and stop: the
    devices of ``sync_value``'s tensors, or, without a value, the current
    CUDA device (nothing on a machine without one)."""

    def __init__(self, units="s", sync_value=None):
        self._sync(sync_value)
        super().__init__(units)

    @staticmethod
    def _sync(value):
        if value is not None:
            for dev in _devices(value):
                torch.cuda.synchronize(dev)
        elif torch.cuda.is_available():
            torch.cuda.synchronize()

    def stop(self, value=None):
        self._sync(value)
        return self()
