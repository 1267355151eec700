"""Ablation_12 config (PyTorch port), the twin of
``woft_tpu/configs/ablation_12.py``: the external flow backend and the
separately trained cost-volume weight head, weighted QR. The head's
checkpoint is not in the repository, so building its tracker raises
``FileNotFoundError`` naming it."""

from woft_tpu_torch.configs._ablation_base import build_config


def get_config():
    return build_config(flow_config='liteflownet2.py')
