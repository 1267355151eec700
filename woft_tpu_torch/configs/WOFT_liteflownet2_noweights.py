"""Ablation_10 config (PyTorch port), the twin of
``woft_tpu/configs/WOFT_liteflownet2_noweights.py``: the external flow
backend without the reliability weight head, plain LSq over uniform
weights."""

from woft_tpu_torch.configs._ablation_base import build_config


def get_config():
    return build_config(flow_config='liteflownet2.py', estimator='plain_qr',
                        flow_overrides={'use_weight_head': False})
