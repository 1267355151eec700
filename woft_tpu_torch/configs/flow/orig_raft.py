"""Original (unweighted) RAFT flow config (PyTorch port).

Twin of ``woft_tpu/configs/flow/orig_raft.py``: 'orig' RAFT-large (flow
only, no weight head), 24 GRU iterations, ``RAFT`` replicate padding,
float32. ``model`` is the reference's ``weights/raft-sintel.pth``; the
repository does not hold it, so ``RaftFlow`` falls back to seeded random
weights with a logged warning, as the JAX package does.
"""

from pathlib import Path

from woft_tpu_torch.config import Config

WEIGHTS = Path(__file__).resolve().parents[3] / "weights"


def get_config():
    conf = Config()

    from woft_tpu_torch.flow.wrapper import RaftFlow
    conf.of_class = RaftFlow
    conf.raft_type = "orig"

    conf.class_params = Config()
    conf.class_params.small = False
    conf.class_params.alternate_corr = False

    conf.model = WEIGHTS / "raft-sintel.pth"

    conf.iters = 24
    conf.padding_mode = "RAFT"
    conf.precision = "highest"

    conf.name = Path(__file__).stem
    return conf
