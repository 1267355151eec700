"""Ablation config (PyTorch port), the twin of
``woft_tpu/configs/WOFT_downscale_3x.py``: deviation from canonical WOFT ->
downscale=3."""

from woft_tpu_torch.configs._ablation_base import build_config


def get_config():
    return build_config(downscale=3)
