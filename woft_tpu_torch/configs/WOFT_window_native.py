"""Native-scale search-window config (PyTorch port): window sides chosen
once a sequence.

Twin of ``woft_tpu/configs/WOFT_window_native.py`` (after the reference's
native-resolution crops, ref:pytracking/tracker/WOFT_window.py:37-44): the
window's sides follow the margin-padded template box, snapped up to 32
pixels and capped at 512, so the crop scale is isotropic and exactly 1
whenever the native region fits the cap. The frame's cost then grows with
the target's native size up to the cap.
"""

from pathlib import Path

from woft_tpu_torch.config import load_config


def get_config():
    conf = load_config(Path(__file__).resolve().parent / "WOFT_window.py")
    conf.window_native_scale = True
    conf.window_max_px = 512
    conf.window_snap_px = 32
    return conf
