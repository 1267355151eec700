"""``build_config``, shared by the ablation config family (PyTorch port).

Twin of ``woft_tpu/configs/_ablation_base.py``: one function spans the
paper's ablation table, and each config file states only its deviation:

- estimator: weighted LSq (canonical) / plain LSq / IRLS-Huber, and the
  host fits (OpenCV RANSAC, similarity), which need ``cv2``;
- redetection: inlier check (canonical) / neverwarp / alwayswarp;
- downscale: 1 (canonical) / 2 / 3 / 4, with replicate ('RAFT') padding,
  since downscaled frames are rarely /8.

- flow network (``flow_config``): WeightedRAFT (canonical), its 'rep'
  checkpoint (``wraft_large_rep.py``), the original RAFT
  (``orig_raft.py``), or the external backend with its cost-volume weight
  head (``liteflownet2.py``, ``flow/external.py``); ``flow_overrides``
  sets fields of the flow config (``raft_type``, ``use_weight_head``).

Every flow config of the reference has a twin here. A name the port does
not have raises ``NotImplementedError``; no other file is loaded in its
place.
"""

from pathlib import Path

from woft_tpu_torch.config import Config, load_config
from woft_tpu_torch.tracker import TrackerParams, WOFTTracker

_FLOW_DIR = Path(__file__).resolve().parent / "flow"


def build_config(estimator="wls_qr", redetection="inliers", downscale=0,
                 flow_config="wraft_large.py", padding_mode=None,
                 subsample_n=500, no_local_h=False, flow_overrides=None):
    flow_path = _FLOW_DIR / flow_config
    if not flow_path.is_file():
        raise NotImplementedError(f"flow config '{flow_config}' is not "
                                  "ported")
    conf = Config()
    conf.tracker_class = WOFTTracker
    conf.flow_config = load_config(flow_path)
    conf.flow_config.weights_postprocessing_fn = None
    for k, v in (flow_overrides or {}).items():
        setattr(conf.flow_config, k, v)
    if padding_mode is None:
        padding_mode = "RAFT" if downscale else str(
            conf.flow_config.padding_mode or "nopad")
    conf.flow_config.padding_mode = padding_mode

    conf.downscale_inputs = downscale
    conf.tracker_params = TrackerParams(
        subsample_n=subsample_n,
        inlier_px=5.0,
        min_inlier_frac=0.2,
        no_prewarp_after_n=10,
        estimator=estimator,
        redetection=redetection,
        downscale=downscale,
        no_local_h=no_local_h,
        padding_mode=padding_mode,
    )
    return conf
