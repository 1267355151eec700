"""Pre-computed flow cache keyed by a frame's identity.

The port's own copy of ``woft_tpu/flow/cache.py``
(ref:pytracking/utils/caching.py:24-59), with its file layout, so that a
cache written by either package reads in the other: a frame pair's flow
and weights live at ``{cache_dir}/{dataset}/{seq}/{i}-{i+1}.npz`` as
``half_flow`` (float16, (H, W, 2), or (2, H, W) as the reference's own
files have it) and ``half_weights`` (float16, (H, W) or (1, H, W)).
``RaftFlow.compute_flow`` reads it when its config names a
``flow_cache_dir`` and the caller passes ``src_img_identifier``.
"""

import hashlib
from pathlib import Path

import numpy as np


def identify_image(img):
    """sha256 of the raw image bytes (ref:caching.py:48-50)."""
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


class FlowCache:
    def __init__(self, cache_dir):
        self.cache_dir = Path(cache_dir)

    def _frame_path(self, identifier):
        dataset, seq, frame_i = identifier
        return self.cache_dir / str(dataset) / str(seq) / \
            f"{frame_i}-{frame_i + 1}.npz"

    def load(self, src_img, identifier):
        """-> (flow (H, W, 2) float32, weights (H, W) float32 | None).

        ``identifier`` is (dataset, seq, frame_i); a miss raises
        ``FileNotFoundError``."""
        path = self._frame_path(identifier)
        with np.load(path) as data:
            flow = data["half_flow"].astype(np.float32)
            weights = None
            if "half_weights" in data and data["half_weights"].size > 1:
                weights = data["half_weights"].astype(np.float32)
        if flow.shape[0] == 2:                       # (2, H, W) -> (H, W, 2)
            flow = flow.transpose(1, 2, 0)
        if weights is not None and weights.ndim == 3:
            weights = weights[0]
        return flow, weights

    def store(self, identifier, flow, weights=None):
        """Save flow (H, W, 2) [+ weights (H, W)] as a float16 npz."""
        path = self._frame_path(identifier)
        path.parent.mkdir(parents=True, exist_ok=True)
        arrays = {"half_flow": np.asarray(flow, np.float16)}
        if weights is not None:
            arrays["half_weights"] = np.asarray(weights, np.float16)
        np.savez_compressed(path, **arrays)
        return path
