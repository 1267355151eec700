"""Search-window WOFT config (PyTorch port): a 256-pixel window at any
frame size.

Twin of ``woft_tpu/configs/WOFT_window.py``: the search region is warped
into a window of fixed area (``tracker/window.py``; the device-resident
step is ``tracker/window_step.py``), WeightedRAFT-large in float32 with the
dense pyramid inside it. Window mode prefers the window-mode fine-tune,
``weights/wraft_tpu_v5_torch.pt`` (the export of the JAX package's
``weights/wraft_tpu_v5``), unless ``WOFT_WRAFT_TORCH_CKPT`` names a file.
"""

import os
from pathlib import Path

from woft_tpu_torch.config import Config, load_config
from woft_tpu_torch.tracker import TrackerParams, WOFTWindowTracker


def get_config():
    conf = Config()

    conf.tracker_class = WOFTWindowTracker
    conf.flow_config = load_config(
        Path(__file__).resolve().parent / "flow" / "wraft_large.py")

    v5 = (Path(__file__).resolve().parents[2] / "weights"
          / "wraft_tpu_v5_torch.pt")
    if v5.exists() and not os.environ.get("WOFT_WRAFT_TORCH_CKPT"):
        conf.flow_config.model = v5

    conf.window_size = 256
    conf.window_margin = 0.5
    conf.min_window_px = 160

    conf.tracker_params = TrackerParams(
        subsample_n=500,
        inlier_px=5.0,
        min_inlier_frac=0.2,
        no_prewarp_after_n=10,
        estimator="wls_qr",
        redetection="inliers",
        padding_mode="nopad",
    )
    return conf
