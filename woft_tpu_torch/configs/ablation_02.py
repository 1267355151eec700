"""Ablation config (PyTorch port), the twin of
``woft_tpu/configs/ablation_02.py``: deviation from canonical WOFT ->
redetection='never'."""

from woft_tpu_torch.configs._ablation_base import build_config


def get_config():
    return build_config(redetection='never')
