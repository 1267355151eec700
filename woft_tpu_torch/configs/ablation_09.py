"""Ablation config (PyTorch port), the twin of
``woft_tpu/configs/ablation_09.py``: deviation from canonical WOFT ->
OpenCV RANSAC (max_iters=10000, thr=3). Needs ``cv2``, imported at the
first fit."""

from woft_tpu_torch.configs._ablation_base import build_config


def get_config():
    return build_config(estimator='cvransac')
