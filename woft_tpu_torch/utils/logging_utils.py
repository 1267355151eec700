"""Operational logging helpers (ref:pytracking/utils/various_utils.py).

The port's copy of ``woft_tpu/utils/logging_utils.py`` (plain Python)."""


class SparseExceptionLogger:
    """Log each distinct error message once (with prefix-normalisation for
    repetitive spam like OOM / file-not-found) (ref:various_utils.py:19-42)."""

    def __init__(self, logger, extra_starts=()):
        self.logger = logger
        self.seen = set()
        self.starts = ["CUDA out of memory", "RESOURCE_EXHAUSTED",
                       "[Errno 2] No such file or directory:",
                       *extra_starts]

    def _normalise(self, msg):
        for start in self.starts:
            if msg.startswith(start):
                return start
        return msg

    def __call__(self, prefix, exception):
        msg = self._normalise(str(exception))
        if msg not in self.seen:
            self.seen.add(msg)
            self.logger.warning("%s: %s", prefix, msg)


def with_debugger(fn):
    """Drop into a post-mortem debugger on exception
    (ref:various_utils.py:7-16)."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception:
            import pdb
            import sys
            import traceback
            traceback.print_exc()
            pdb.post_mortem(sys.exc_info()[2])
            raise

    return wrapped
