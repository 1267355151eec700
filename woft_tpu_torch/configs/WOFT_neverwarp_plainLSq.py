"""Ablation config (PyTorch port), the twin of
``woft_tpu/configs/WOFT_neverwarp_plainLSq.py``: deviation from canonical
WOFT -> estimator='plain_qr', redetection='never'."""

from woft_tpu_torch.configs._ablation_base import build_config


def get_config():
    return build_config(estimator='plain_qr', redetection='never')
