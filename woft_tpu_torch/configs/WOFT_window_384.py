"""Accuracy-tier search-window config (PyTorch port): a 384-pixel window.

Twin of ``woft_tpu/configs/WOFT_window_384.py``: ``WOFT_window.py`` with a
384-pixel window and a margin of 0.35. A window-space error of 1 px maps to
about 1/scale frame pixels, so the larger window buys finer effective
resolution over the target for about twice the window step's work.
"""

from pathlib import Path

from woft_tpu_torch.config import load_config


def get_config():
    conf = load_config(Path(__file__).resolve().parent / "WOFT_window.py")
    conf.window_size = 384
    conf.window_margin = 0.35
    return conf
