"""Speed-tier WOFT tracker config (PyTorch port): block-local correlation
and a bf16 model.

Twin of ``woft_tpu/configs/WOFT_fast.py``: the tracker logic of ``WOFT.py``;
the flow network runs with ``corr_impl='local'`` (``models/corr.py:
build_local_corr``, kernels C, D, E) and ``precision='bf16'``. Lookups equal
the all-pairs path while the residual flow after the pre-warp stays within
+-``local_margin`` 1/8-resolution cells (16 -> +-128 full-resolution
pixels); beyond that the window saturates. Prefer ``WOFT.py`` when frames
routinely jump further than that between redetections.
"""

from pathlib import Path

from woft_tpu_torch.config import load_config


def get_config():
    conf = load_config(Path(__file__).resolve().parent / "WOFT.py")
    conf.flow_config.corr_impl = "local"
    conf.flow_config.local_margin = 16
    conf.flow_config.precision = "bf16"
    conf.name = "WOFT_fast"
    return conf
