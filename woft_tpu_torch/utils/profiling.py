"""Profiling helpers (the reference's per-stage debug timers).

The port's twin of ``woft_tpu/utils/profiling.py``: ``trace_step`` records
N steps under ``torch.profiler`` (CPU activity, and CUDA's where a card is
present) and writes a Chrome trace to ``log_dir`` (open it in Perfetto or
``chrome://tracing``; the JAX package writes an xprof trace);
``stage_timer`` logs the host-side ms of a stage at debug level, after
synchronising the card that holds ``sync_value``'s tensors.
"""

import contextlib
import logging
import os
import time

import torch

from .timing import device_time_measurer

logger = logging.getLogger(__name__)


def trace_step(step_fn, args, *, log_dir="woft_trace", n=3):
    """Run ``step_fn(*args)`` ``n`` times under ``torch.profiler``.

    Returns the last result; the Chrome trace lands in
    ``log_dir/trace.json``. Chain-dependent steps should pass updated args
    themselves."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        out = None
        for _ in range(n):
            out = step_fn(*args)
        device_time_measurer._sync(out)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
    return out


@contextlib.contextmanager
def stage_timer(name, sync_value=None):
    """Host-side stage timer with the reference's debug-log surface: the
    card of ``sync_value``'s tensors is synchronised before the time is
    read (none without a value)."""
    start = time.perf_counter()
    yield
    if sync_value is not None:
        device_time_measurer._sync(sync_value)
    logger.debug("%s: %.1fms", name, 1000 * (time.perf_counter() - start))
