"""Canonical WeightedRAFT flow config (PyTorch port).

Twin of ``woft_tpu/configs/flow/wraft_large.py``: weighted RAFT, large
backbone, 12 GRU iterations, no padding, float32. ``model`` is a
torch-readable state dict, in the reference's order of preference: the
file named by ``WOFT_WRAFT_TORCH_CKPT``, then the trained full-frame
checkpoint ``weights/wraft_tpu_v4_torch.pt`` (the export of the JAX
package's ``weights/wraft_tpu_v4``, made by
``tools/export_torch_weights.py``); when none exists ``RaftFlow`` falls
back to seeded random weights with a logged warning.
"""

import os
from pathlib import Path

from woft_tpu_torch.config import Config

WEIGHTS = Path(__file__).resolve().parents[3] / "weights"


def get_config():
    conf = Config()

    from woft_tpu_torch.flow.wrapper import RaftFlow
    conf.of_class = RaftFlow
    conf.raft_type = "weighted"

    conf.class_params = Config()
    conf.class_params.small = False
    conf.class_params.alternate_corr = False
    conf.class_params.weight_head_structure = [(128, 3), (128, 3), (128, 3)]

    env_ckpt = os.environ.get("WOFT_WRAFT_TORCH_CKPT")
    candidates = ([Path(env_ckpt)] if env_ckpt else []) + [
        WEIGHTS / "wraft_tpu_v4_torch.pt"]
    conf.model = next((c for c in candidates if c.exists()), candidates[-1])

    conf.iters = 12
    conf.padding_mode = "nopad"
    conf.precision = "highest"

    conf.name = Path(__file__).stem
    return conf
