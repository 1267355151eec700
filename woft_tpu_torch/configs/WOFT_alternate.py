"""The canonical WOFT tracker on RAFT's volume-free correlation.

``WOFT.py`` with ``flow_config.class_params.alternate_corr = True``,
nothing else changed: no all-pairs pyramid is stored; each of a flow's 13
lookups computes its windows from the features (RAFT's
``AlternateCorrBlock``, princeton-vl/RAFT ``core/corr.py``), kernel K on
the card. For frames whose float32 pyramid does not fit the card: at
3840x2160 it would take 89.2 GB. The JAX package has no file of this
name; its ``WOFT.py`` with the same flag is the twin.
"""

from pathlib import Path

from woft_tpu_torch.config import load_config


def get_config():
    conf = load_config(Path(__file__).resolve().parent / "WOFT.py")
    conf.flow_config.class_params.alternate_corr = True
    return conf
