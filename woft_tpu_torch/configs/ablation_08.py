"""Ablation config (PyTorch port), the twin of
``woft_tpu/configs/ablation_08.py``: deviation from canonical WOFT ->
estimator='irls_huber'."""

from woft_tpu_torch.configs._ablation_base import build_config


def get_config():
    return build_config(estimator='irls_huber')
