"""RNG helpers (ref:pytracking/utils/random.py).

The port's copy of ``woft_tpu/utils/random_utils.py``: numpy's global RNG,
which the debug overlays' colours draw from (``vis.py``)."""

import contextlib

import numpy as np


@contextlib.contextmanager
def tmp_np_seed(seed):
    """Temporarily seed numpy's global RNG (ref:random.py:5-15)."""
    if seed is None:
        yield
        return
    state = np.random.get_state()
    np.random.seed(seed)
    try:
        yield
    finally:
        np.random.set_state(state)
