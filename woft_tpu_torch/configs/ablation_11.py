"""Ablation_11 config (PyTorch port), the twin of
``woft_tpu/configs/ablation_11.py``: the external flow backend, no weight
head, OpenCV RANSAC (needs ``cv2``, imported at the first fit)."""

from woft_tpu_torch.configs._ablation_base import build_config


def get_config():
    return build_config(flow_config='liteflownet2.py', estimator='cvransac',
                        flow_overrides={'use_weight_head': False})
