"""The ``compute_flow`` wrapper protocol around the RAFT flow networks.

PyTorch twin of ``woft_tpu/flow/wrapper.py``:
- inputs: (H, W, 3) uint8 BGR numpy images of equal shape (host API), or
  (B, H, W, 3) float RGB tensors on the device (device API);
- ``mode='flow'`` -> dense flow (2, H, W) + weights (H, W), or None under
  ``raft_type='orig'``, [+ visibility mask (H, W) under
  'weighted_masked'];
- ``mode='TC'``   -> (src_coords (2, HW), dst_coords (2, HW), weights
  (1, HW) or None [, mask (1, HW)]), full-field; subsampling and masking
  happen downstream.

``config.raft_type`` ('weighted', 'orig', 'weighted_masked') picks
``RaftConfig.variant`` (``class_params.small``, RAFT-small, is not
ported);
``class_params.mask_head_structure`` (default three 128-channel 3x3
layers under 'weighted_masked') and ``class_params.alternate_corr`` pass
through, as do ``config.corr_impl`` ('dense' or 'local'),
``config.local_margin`` and ``config.precision`` ('highest', 'default' or
'bf16'); ``config.weights_postprocessing_fn``, when set, maps the weight
logits before the optional sigmoid (the reference's hook).

Weights: ``config.model`` names a torch-readable state dict (``torch.save``
of ``WeightedRAFT.state_dict()``, or ``params_from_jax_numpy`` output).
A state dict that lacks subtrees the variant has (the v4 weights under
'weighted_masked': no ``mask_head``) loads what it has and keeps the
seeded init for the rest; subtrees the variant lacks (``weight_head``
under 'orig') are dropped; either way with the reference's warning.
Without a file the network gets seeded random weights and a warning.
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


def raft_config(config):
    """The ``RaftConfig`` of a flow config (``raft_type``, ``class_params``,
    ``iters``, ``corr_impl``, ``local_margin``, ``precision``)."""
    cp = config.class_params
    if cp.small:
        raise NotImplementedError("RAFT-small is not ported")
    variant = str(config.raft_type or "weighted")
    whs = cp.weight_head_structure or ()
    mhs = cp.mask_head_structure or (
        ((128, 3),) * 3 if variant == "weighted_masked" else ())
    return RaftConfig(
        variant=variant,
        iters=int(config.iters or 12),
        weight_head_structure=tuple(tuple(s) for s in whs),
        mask_head_structure=tuple(tuple(s) for s in mhs),
        alternate_corr=bool(cp.alternate_corr),
        corr_impl=str(config.corr_impl) if config.corr_impl else "dense",
        local_margin=int(config.local_margin or 16),
        precision=str(config.precision) if config.precision else "highest")


def load_model(cfg, path, device):
    """A seeded ``WeightedRAFT`` of ``cfg`` with the state dict at ``path``
    loaded over it: strictly when the keys match; otherwise the keys both
    have (the reference's merge of a partial match), with its warning.
    Without a file: the seeded weights and a warning."""
    model = init_raft_params(cfg, seed=0)
    if path and os.path.exists(str(path)):
        logger.info("Loading torch checkpoint %s", path)
        state = torch.load(str(path), map_location="cpu", weights_only=True)
        state = {k[len("module."):] if k.startswith("module.") else k: v
                 for k, v in state.items()}
        own = model.state_dict()
        if set(state) != set(own):
            logger.warning("checkpoint %s is a partial match; merging "
                           "overlapping subtrees non-strictly (missing: "
                           "%d tensors, dropped: %d)", path,
                           len(set(own) - set(state)),
                           len(set(state) - set(own)))
            state = {k: v for k, v in state.items() if k in own}
            if not state:
                raise ValueError(f"checkpoint {path} shares no tensor with "
                                 f"a '{cfg.variant}' RAFT")
        model.load_state_dict(state, strict=set(state) == set(own))
    else:
        logger.warning("No torch-readable checkpoint (%s); using seeded "
                       "random weights (seed 0)", path or "none given")
    return model.to(device).eval()


class RaftFlow:
    """Host-facing RAFT flow wrapper on one device (default ``cuda``;
    raises without a card)."""

    def __init__(self, config, device=None):
        self.C = config
        self.device = resolve_device(device)
        self.cfg = raft_config(config)
        self.padding_mode = config.padding_mode or "nopad"
        self.model = load_model(self.cfg, config.model, self.device)

    def compute_flow_device(self, src, dst):
        """(B, H, W, 3) float RGB device tensors -> (flow (B, H, W, 2),
        weight logits (B, H, W, 1) or None under 'orig', visibility logits
        (B, H, W, 1) under 'weighted_masked' or None)."""
        padder = make_padder(self.padding_mode, src.shape)
        psrc, pdst = padder.pad(src, dst)
        out = weighted_raft_forward(self.model, self.cfg, psrc, pdst)
        return (padder.unpad(out["flow_up"]),
                *(padder.unpad(out[k]) if k in out else None
                  for k in ("weights_up", "mask_up")))

    def compute_flow(self, src_img, dst_img, mode="TC", numpy_out=False,
                     do_sigmoid=False):
        """Reference-compatible entry: BGR uint8 images -> flow or TCs,
        with the reference's outputs and arity for each variant."""
        if mode not in ("flow", "TC"):
            raise ValueError(f"mode must be 'flow' or 'TC', got {mode!r}")
        if src_img.shape != dst_img.shape:
            raise ValueError("source and destination shapes differ")
        flow, weights, mask = self.compute_flow_device(
            upload_bgr(src_img, self.device), upload_bgr(dst_img, self.device))
        if self.C.weights_postprocessing_fn and weights is not None:
            weights = self.C.weights_postprocessing_fn(weights)
        if do_sigmoid:
            weights, mask = (None if t is None else torch.sigmoid(t)
                             for t in (weights, mask))

        H, W = src_img.shape[:2]
        if mode == "flow":
            outs = [flow[0].permute(2, 0, 1)] + [
                None if t is None else t[0, ..., 0] for t in (weights, mask)]
        else:
            src_coords = featuremap_coords((H, W), self.device)   # (2, HW)
            dst_coords = src_coords + flow[0].reshape(-1, 2).T
            outs = [src_coords, dst_coords] + [
                None if t is None else t[0].reshape(1, -1)
                for t in (weights, mask)]
        if self.cfg.variant != "weighted_masked":
            outs = outs[:-1]
        if numpy_out:
            outs = [None if o is None else o.cpu().numpy() for o in outs]
        return tuple(outs)
