"""Ablation config (PyTorch port), the twin of
``woft_tpu/configs/WOFT_origraft.py``: deviation from canonical WOFT ->
the original RAFT (``flow/orig_raft.py``: no weight head, so uniform
weights, 24 iterations, ``RAFT`` padding) and plain LSq."""

from woft_tpu_torch.configs._ablation_base import build_config


def get_config():
    return build_config(flow_config='orig_raft.py', estimator='plain_qr')
