"""Long-job crash notifications (ref:pytracking/utils/telegram_notification.py).

The port's copy of ``woft_tpu/utils/notifications.py`` (plain Python).

The reference pushes Telegram messages for jobs that die after running >1
minute. Network egress is environment-dependent, so the transport is
pluggable: a webhook/command sink via env vars, falling back to a log line.

    WOFT_NOTIFY_CMD   shell command; message passed on stdin
    WOFT_NOTIFY_FILE  append-to file path
"""

import functools
import logging
import os
import socket
import subprocess
import time

logger = logging.getLogger(__name__)


def send_notification(message, parse_mode=None):
    """Deliver a notification through the configured sink."""
    tagged = f"[{socket.gethostname()}] {message}"
    cmd = os.environ.get("WOFT_NOTIFY_CMD")
    path = os.environ.get("WOFT_NOTIFY_FILE")
    if cmd:
        try:
            subprocess.run(cmd, shell=True, input=tagged.encode(),
                           timeout=30, check=False)
            return True
        except Exception as ex:  # noqa: BLE001 — notification best effort
            logger.warning("notify command failed: %s", ex)
    if path:
        try:
            with open(path, "a") as f:
                f.write(tagged + "\n")
            return True
        except OSError as ex:
            logger.warning("notify file failed: %s", ex)
    logger.info("NOTIFY: %s", tagged)
    return False


def with_notification(fn=None, *, min_runtime_s=60.0):
    """Decorator: push a notification if the wrapped call raises after
    running longer than ``min_runtime_s`` (ref:telegram_notification.py:7-32)."""
    def deco(f):
        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            start = time.time()
            try:
                return f(*args, **kwargs)
            except Exception as ex:
                if time.time() - start > min_runtime_s:
                    send_notification(
                        f"{f.__name__} crashed after "
                        f"{time.time() - start:.0f}s: {ex!r}")
                raise
        return wrapped

    return deco(fn) if fn is not None else deco
