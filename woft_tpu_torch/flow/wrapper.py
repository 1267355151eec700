"""The ``compute_flow`` wrapper protocol around WeightedRAFT.

PyTorch twin of ``woft_tpu/flow/wrapper.py``:
- inputs: (H, W, 3) uint8 BGR numpy images of equal shape (host API), or
  (B, H, W, 3) float RGB tensors on the device (device API);
- ``mode='flow'`` -> dense flow (2, H, W) + weights (H, W);
- ``mode='TC'``   -> (src_coords (2, HW), dst_coords (2, HW), weights
  (1, HW)), full-field; subsampling and masking happen downstream.

``config.corr_impl`` ('dense' or 'local'), ``config.local_margin`` and
``config.precision`` ('highest' or 'bf16') pass through to ``RaftConfig``;
``config.weights_postprocessing_fn``, when set, maps the weight logits
before the optional sigmoid (the reference's hook).

Weights: ``config.model`` names a torch-readable state dict (``torch.save``
of ``WeightedRAFT.state_dict()``, or ``params_from_jax_numpy`` output);
without one the network gets seeded random weights and a warning.
"""

import logging
import os

import numpy as np
import torch

from ..device import resolve_device
from ..models.raft import RaftConfig, init_raft_params, weighted_raft_forward
from ..ops.pad import make_padder
from ..ops.resize import resize_down
from ..ops.sampling import featuremap_coords

logger = logging.getLogger(__name__)


def upload_bgr(img_bgr, device, downscale=0):
    """(H, W, 3) BGR uint8 numpy -> (1, H, W, 3) float32 RGB on ``device``;
    with ``downscale`` s, resized there as ``cv2.resize(INTER_LINEAR)``
    with ``fx = fy = 1/s`` does (``ops/resize.py``)."""
    img = torch.from_numpy(np.ascontiguousarray(img_bgr)).to(device)
    if downscale:
        img = resize_down(img, downscale)
    return img.flip(-1).to(torch.float32)[None].contiguous()


class RaftFlow:
    """Host-facing WeightedRAFT flow wrapper on one device (default
    ``cuda``; raises without a card)."""

    def __init__(self, config, device=None):
        self.C = config
        self.device = resolve_device(device)
        if config.raft_type != "weighted":
            raise NotImplementedError(
                f"raft_type '{config.raft_type}' is not ported")
        if config.class_params.small or config.class_params.alternate_corr:
            raise NotImplementedError("only RAFT-large with the full "
                                      "correlation volume is ported")
        whs = config.class_params.weight_head_structure or ()
        self.cfg = RaftConfig(
            iters=int(config.iters or 12),
            weight_head_structure=tuple(tuple(s) for s in whs),
            corr_impl=str(config.corr_impl) if config.corr_impl else "dense",
            local_margin=int(config.local_margin or 16),
            precision=str(config.precision) if config.precision
            else "highest")
        self.padding_mode = config.padding_mode or "nopad"
        self.model = self._load_model(config.model)

    def _load_model(self, path):
        model = init_raft_params(self.cfg, seed=0)
        if path and os.path.exists(str(path)):
            logger.info("Loading torch checkpoint %s", path)
            state = torch.load(str(path), map_location="cpu",
                               weights_only=True)
            model.load_state_dict(
                {k[len("module."):] if k.startswith("module.") else k: v
                 for k, v in state.items()}, strict=True)
        else:
            logger.warning("No torch-readable checkpoint (%s); using seeded "
                           "random weights (seed 0)", path or "none given")
        return model.to(self.device).eval()

    def compute_flow_device(self, src, dst):
        """(B, H, W, 3) float RGB device tensors -> (flow (B, H, W, 2),
        weight logits (B, H, W, 1))."""
        padder = make_padder(self.padding_mode, src.shape)
        psrc, pdst = padder.pad(src, dst)
        out = weighted_raft_forward(self.model, self.cfg, psrc, pdst)
        return padder.unpad(out["flow_up"]), padder.unpad(out["weights_up"])

    def compute_flow(self, src_img, dst_img, mode="TC", numpy_out=False,
                     do_sigmoid=False):
        """Reference-compatible entry: BGR uint8 images -> flow or TCs."""
        if mode not in ("flow", "TC"):
            raise ValueError(f"mode must be 'flow' or 'TC', got {mode!r}")
        if src_img.shape != dst_img.shape:
            raise ValueError("source and destination shapes differ")
        flow, weights = self.compute_flow_device(
            upload_bgr(src_img, self.device), upload_bgr(dst_img, self.device))
        if self.C.weights_postprocessing_fn:
            weights = self.C.weights_postprocessing_fn(weights)
        if do_sigmoid:
            weights = torch.sigmoid(weights)

        H, W = src_img.shape[:2]
        if mode == "flow":
            outs = [flow[0].permute(2, 0, 1), weights[0, ..., 0]]
        else:
            src_coords = featuremap_coords((H, W), self.device)   # (2, HW)
            dst_coords = src_coords + flow[0].reshape(-1, 2).T
            outs = [src_coords, dst_coords, weights[0].reshape(1, -1)]
        if numpy_out:
            outs = [o.cpu().numpy() for o in outs]
        return tuple(outs)
