"""Ablation_07 config (PyTorch port), the twin of
``woft_tpu/configs/WOFT_rep.py``: the weight head trained without RAFT
fine-tuning; the flow config swaps to the 'rep' checkpoint
(``flow/wraft_large_rep.py``: the v3 export), the rest canonical."""

from woft_tpu_torch.configs._ablation_base import build_config


def get_config():
    return build_config(flow_config='wraft_large_rep.py')
