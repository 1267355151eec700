"""'weighted_masked' tracker config (PyTorch port), the twin of
``woft_tpu/configs/WOFT_masked.py``: WeightedRAFT plus the visibility
mask head; the sigmoided mask, where it exceeds 0.5, joins the TC
validity beside the template mask. No trained mask head exists: the v4
weights load for the rest and the head keeps its seeded init."""

from woft_tpu_torch.configs._ablation_base import build_config


def get_config():
    return build_config(flow_overrides={'raft_type': 'weighted_masked'})
