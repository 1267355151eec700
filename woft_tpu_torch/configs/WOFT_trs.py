"""Ablation config (PyTorch port), the twin of
``woft_tpu/configs/WOFT_trs.py``: deviation from canonical WOFT -> a
similarity (translation, rotation, scale) fit by
cv2.estimateAffinePartial2D instead of a full homography. Needs ``cv2``,
imported at the first fit."""

from woft_tpu_torch.configs._ablation_base import build_config


def get_config():
    return build_config(estimator='trs')
