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
``RaftConfig.variant``, ``class_params.small`` RAFT-small;
``class_params.mask_head_structure`` (default three 128-channel 3x3
layers under 'weighted_masked'), ``class_params.alternate_corr`` and
``class_params.gma`` (GMA, ``models/gma.py``) pass through, as do ``config.corr_impl`` ('dense' or 'local'),
``config.local_margin`` and ``config.precision`` ('highest', 'default' or
'bf16'); ``config.weights_postprocessing_fn``, when set, maps the weight
logits before the optional sigmoid (the reference's hook);
``config.flow_cache_dir``, when set, is read for frames the caller
identifies (``flow/cache.py``).

Weights: ``config.model`` names a torch-readable state dict (``torch.save``
of ``WeightedRAFT.state_dict()``, or ``params_from_jax_numpy`` output).
Under ``gma`` a state dict of RAFT-large without GMA's tensors (the v4
export: no GMA checkpoint is in the repository) is grafted onto GMA
(``gma.graft``): every tensor the two share is copied, the SepConvGRU's
weights into the first 384 of its 512 input rows, and GMA's additions
(``att.to_qk``, ``update_block.aggregator``, the GRU's 128 new rows a
convolution) are drawn from ``GMA_SEED`` with the new rows at
``GMA_ROWS_SCALE`` of torch's default bound and ``gamma`` set to
``GMA_GAMMA``.
A state dict that lacks subtrees the variant has (the v4 weights under
'weighted_masked': no ``mask_head``) loads what it has and keeps the
seeded init for the rest; subtrees the variant lacks (``weight_head``
under 'orig') are dropped; either way with the reference's warning.
The weight head takes the checkpoint's own layers where they differ from
``class_params.weight_head_structure`` (a ``train_wraft_torch.py --small``
checkpoint under ``WOFT.py``'s config); ``RaftFlow.cfg`` names them. Without
a file the network gets seeded random weights and a warning.
"""

import logging
import os
from dataclasses import replace

import numpy as np
import torch

from ..device import resolve_device
from ..models import gma
from ..models.raft import RaftConfig, init_raft_params, weighted_raft_forward
from ..ops.pad import make_padder
from ..ops.resize import resize_down
from ..ops.sampling import featuremap_coords
from .cache import FlowCache

logger = logging.getLogger(__name__)

# GMA's additions over a RAFT-large state dict (``load_model``)
GMA_SEED = 2104
GMA_ROWS_SCALE = 1.0
GMA_GAMMA = 9.0


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
        precision=str(config.precision) if config.precision else "highest",
        small=bool(cp.small),
        gma=bool(cp.gma))


def _head_structure(state):
    """The (channels, kernel) layers of a state dict's weight head before
    its 1x1 output convolution, or None when it has no weight head."""
    prefix = "weight_head.net."
    convs = sorted((int(k[len(prefix):].split(".")[0]), v.shape)
                   for k, v in state.items()
                   if k.startswith(prefix) and k.endswith(".weight"))
    if not convs:
        return None
    return tuple((int(s[0]), int(s[-1])) for _, s in convs[:-1])


def load_model(cfg, path, device):
    """A seeded ``WeightedRAFT`` of ``cfg`` with the state dict at ``path``
    loaded over it, and the config it was built to: strictly when the keys
    match; otherwise the keys both have (the reference's merge of a partial
    match), with its warning. The weight head takes the layers of the
    checkpoint's own head where they differ from ``cfg``'s (a
    ``train_wraft_torch.py --small`` checkpoint has one 32-channel layer,
    the flow configs name three of 128). Under ``cfg.gma`` a state dict
    without GMA's tensors is grafted (``gma.graft``, the module docstring).
    Without a file: the seeded weights and a warning."""
    state = None
    if path and os.path.exists(str(path)):
        logger.info("Loading torch checkpoint %s", path)
        state = torch.load(str(path), map_location="cpu", weights_only=True)
        state = {k[len("module."):] if k.startswith("module.") else k: v
                 for k, v in state.items()}
        head = _head_structure(state)
        if (cfg.variant != "orig" and head is not None
                and head != tuple(cfg.weight_head_structure)):
            logger.info("checkpoint %s has the weight head %s; the config "
                        "names %s", path, head, cfg.weight_head_structure)
            cfg = replace(cfg, weight_head_structure=head)
    else:
        logger.warning("No torch-readable checkpoint (%s); using seeded "
                       "random weights (seed 0)", path or "none given")
    model = init_raft_params(cfg, seed=0)
    if state is not None and cfg.gma and not any(map(gma.gma_key, state)):
        logger.info("checkpoint %s has no GMA tensors: GMA's additions are "
                    "drawn from seed %d", path, GMA_SEED)
        gma.graft(model, state, GMA_SEED, GMA_ROWS_SCALE, GMA_GAMMA)
    elif state is not None:
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
    return model.to(device).eval(), cfg


class RaftFlow:
    """Host-facing RAFT flow wrapper on one device (default ``cuda``;
    raises without a card)."""

    def __init__(self, config, device=None):
        self.C = config
        self.device = resolve_device(device)
        self.padding_mode = config.padding_mode or "nopad"
        self.model, self.cfg = load_model(raft_config(config), config.model,
                                          self.device)

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

    def compute_flow(self, src_img, dst_img, mode="TC", vis=False,
                     src_img_identifier=None, numpy_out=False,
                     do_sigmoid=False):
        """Reference-compatible entry: BGR uint8 images -> flow or TCs,
        with the reference's outputs and arity for each variant. ``vis`` is
        accepted and unused, as in the reference. With a
        ``src_img_identifier`` (dataset, seq, frame_i) and the config's
        ``flow_cache_dir``, a cached flow (``flow/cache.py``) replaces the
        network: its float16 values, with no visibility mask; a miss is
        logged at debug level and computes the flow. The config's
        ``weights_postprocessing_fn`` and ``do_sigmoid`` apply either way."""
        if mode not in ("flow", "TC"):
            raise ValueError(f"mode must be 'flow' or 'TC', got {mode!r}")
        if src_img.shape != dst_img.shape:
            raise ValueError("source and destination shapes differ")
        cached = None
        if src_img_identifier is not None and self.C.flow_cache_dir:
            try:
                cached = FlowCache(self.C.flow_cache_dir).load(
                    src_img, src_img_identifier)
                logger.debug("Using pre-computed flow.")
            except FileNotFoundError as ex:
                logger.debug("no cached flow: %s", ex)
        if cached is None:
            flow, weights, mask = self.compute_flow_device(
                upload_bgr(src_img, self.device),
                upload_bgr(dst_img, self.device))
        else:
            flow, weights = (None if a is None else
                             torch.from_numpy(a).to(self.device)[None]
                             for a in cached)
            weights = None if weights is None else weights[..., None]
            mask = None
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
