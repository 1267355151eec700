"""External-backend flow config, the LiteFlowNet2 role of ablations 10-12
(PyTorch port).

Twin of ``woft_tpu/configs/flow/liteflownet2.py``: an external flow
network and a separately trained weight head over its 7x7 local cost
volume (``flow/external.py``). The backend is an 'orig' RAFT-large of 12
iterations on the trained v3 backbone (``weights/wraft_tpu_v3_torch.pt``,
its weight head dropped). The head's checkpoint
``weights/liteflownet2_v2/wraft_weights-ep04-end.pth`` is not in the
repository: ``ExternalFlowWrapper`` raises ``FileNotFoundError`` naming it
unless ``use_weight_head`` is False (ablations 10 and 11).
"""

from pathlib import Path

from woft_tpu_torch.config import Config

WEIGHTS = Path(__file__).resolve().parents[3] / "weights"


def get_config():
    conf = Config()

    from woft_tpu_torch.flow.external import ExternalFlowWrapper
    conf.of_class = ExternalFlowWrapper
    conf.backend_fn = None          # None -> the RAFT backend
    conf.backend_iters = 12
    conf.patch = 7

    conf.model = WEIGHTS / "liteflownet2_v2" / "wraft_weights-ep04-end.pth"

    backend_candidates = [WEIGHTS / "wraft_tpu_v3_torch.pt",
                          WEIGHTS / "wraft_tpu_v2_torch.pt"]
    conf.backend_model = next(
        (c for c in backend_candidates if c.exists()), None)

    conf.iters = 12
    conf.padding_mode = "nopad"
    conf.precision = "highest"

    conf.name = Path(__file__).stem
    return conf
