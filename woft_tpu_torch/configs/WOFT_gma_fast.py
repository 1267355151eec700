"""The speed tier of WOFT with GMA as its flow network.

``WOFT_fast.py`` (block-local correlation, a bf16 model) with
``flow_config.class_params.gma = True``, nothing else changed: RAFT-large
plus GMA's global motion aggregation over the 1/8 grid (Jiang et al., ICCV
2021; ``models/gma.py``), the template's attention built once a sequence
and the aggregation run by kernel M on the card. The repository holds no
GMA checkpoint: the flow loads the trained WeightedRAFT v4 export and draws
GMA's additions from a seed (``flow/wrapper.py:load_model``). The JAX
package has no GMA and no file of this name.
"""

from pathlib import Path

from woft_tpu_torch.config import load_config


def get_config():
    conf = load_config(Path(__file__).resolve().parent / "WOFT_fast.py")
    conf.flow_config.class_params.gma = True
    conf.name = "WOFT_gma_fast"
    return conf
