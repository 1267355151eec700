"""Ablation config (PyTorch port): the canonical WOFT tracker, the table's
reference row. Twin of ``woft_tpu/configs/ablation_06-WOFT.py``."""

from woft_tpu_torch.configs._ablation_base import build_config


def get_config():
    return build_config()
