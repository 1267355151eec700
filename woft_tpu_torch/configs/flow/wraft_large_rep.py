"""ablation_07 flow config: the weight head trained without RAFT
fine-tuning (PyTorch port).

Twin of ``woft_tpu/configs/flow/wraft_large_rep.py``: the canonical
WeightedRAFT-large config with another checkpoint. ``model`` is the first
torch-readable state dict that exists, in the reference's order of
preference: a head-only 'rep' export, the reference's ``.pth``, then the
export of the JAX package's ``weights/wraft_tpu_v3`` (made by
``tools/export_torch_weights.py``; the one the repository holds), then
``v2``'s.
"""

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

    candidates = [WEIGHTS / "wraft_tpu_rep_torch.pt",
                  WEIGHTS / "v2_SNOB_large_g05/wraft_weights-ep09-end.pth",
                  WEIGHTS / "wraft_tpu_v3_torch.pt",
                  WEIGHTS / "wraft_tpu_v2_torch.pt"]
    conf.model = next((c for c in candidates if c.exists()), candidates[-1])

    conf.iters = 12
    conf.padding_mode = "nopad"
    conf.precision = "highest"

    conf.name = Path(__file__).stem
    return conf
