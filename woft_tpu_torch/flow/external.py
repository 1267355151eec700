"""External-backend flow: a flow network plus a weight head over its local
cost volume (the LiteFlowNet2 role of the paper's ablations 10-12).

PyTorch twin of ``woft_tpu/flow/external.py``:

- ``local_cost_volume``: the 7x7 windowed correlation of two feature maps,
  zero outside, channel ``dy*7 + dx``, divided by sqrt(D);
- ``cost_volume_weight_head``: a conv stack over each cell's 7x7 patch of
  the volume, then the patch's mean: one reliability logit a cell (the
  separately trained ``WeightHead``, keys ``net.0/2/4/6``);
- ``make_raft_backend``: the default backend, an 'orig' RAFT
  (``backend_iters`` iterations, the config's padder) giving the flow and
  the cost volume of its feature maps. It loads ``backend_model``, a
  torch-readable WeightedRAFT state dict (the v3 export), without its
  weight head, where the reference merges the orbax ``wraft_tpu_v3``;
- ``ExternalFlowWrapper``: the flow seam for ``WOFTTracker``
  (``make_flow_fn``; uniform weights when ``use_weight_head`` is False, as
  in ablations 10 and 11) and the ``compute_flow`` protocol. A missing
  weight-head checkpoint raises ``FileNotFoundError`` at construction.

Plain PyTorch throughout: the reference computes all of it with XLA, with
no Pallas kernel.
"""

import math
import os

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.raft import RaftConfig, WeightHead, weighted_raft_forward
from ..ops.pad import make_padder
from ..ops.sampling import featuremap_coords
from ..ops.warp import upsample2d_align_corners
from .wrapper import load_model, upload_bgr

HEAD_STRUCTURE = ((128, 3),) * 3        # the shipped head: 1 -> 128 x 3 -> 1


def local_cost_volume(fmap1, fmap2, patch=7):
    """(B, Hf, Wf, D) x 2 -> (B, Hf, Wf, patch*patch): channel dy*patch + dx
    holds <f1(y, x), f2(y + dy - r, x + dx - r)> / sqrt(D), zero where the
    shifted position leaves the map (r = patch // 2)."""
    r = patch // 2
    B, H, W, D = fmap1.shape
    f2 = F.pad(fmap2, (0, 0, r, r, r, r))
    outs = [torch.sum(fmap1 * f2[:, dy:dy + H, dx:dx + W], dim=-1)
            for dy in range(patch) for dx in range(patch)]
    return torch.stack(outs, dim=-1) / math.sqrt(D)


def cost_volume_weight_head(head, cost_volume, patch=7):
    """Reliability logits (B, Hf, Wf, 1) from a (B, Hf, Wf, patch*patch)
    cost volume: ``head`` (a ``WeightHead`` of one input channel) convolves
    each cell's patch x patch image and the result is averaged."""
    B, Hf, Wf, kk = cost_volume.shape
    if kk != patch * patch:
        raise ValueError(f"cost volume has {kk} channels, expected "
                         f"{patch * patch}")
    x = cost_volume.reshape(B * Hf * Wf, 1, patch, patch)
    for mod in head.net:
        x = mod(x)
    return x.mean(dim=(2, 3)).reshape(B, Hf, Wf, 1)


def make_raft_backend(config, device):
    """The default backend ``(img1, img2) -> (flow (1, H, W, 2), cost
    volume (1, Hf, Wf, patch^2))``: an 'orig' RAFT-large of
    ``config.backend_iters`` iterations (12) in ``config.precision``,
    padded by ``config.padding_mode``; ``config.backend_model`` loads over
    its seeded weights, the weight head it lacks dropped (a missing file:
    seeded weights and a warning). The network is the function's
    ``model`` attribute."""
    cfg = RaftConfig(variant="orig", iters=int(config.backend_iters or 12),
                     precision=str(config.precision or "highest"))
    model, cfg = load_model(cfg, config.backend_model, device)
    patch = int(config.patch or 7)
    padding_mode = str(config.padding_mode or "nopad")

    def backend(img1, img2):
        padder = make_padder(padding_mode, img1.shape)
        p1, p2 = padder.pad(img1, img2)
        out = weighted_raft_forward(model, cfg, p1, p2)
        cv = local_cost_volume(out["fmap1"], out["fmap2"], patch)
        return padder.unpad(out["flow_up"]), cv

    backend.model = model
    return backend


class ExternalFlowWrapper:
    """The flow seam and the ``compute_flow`` protocol around an external
    flow backend, on one device (default ``cuda``; raises without a card).

    config: ``backend_fn`` (callable ``(src_rgb (1, H, W, 3), dst_rgb) ->
    (flow (1, H, W, 2), cost volume (1, Hf, Wf, patch^2))``; None: the
    RAFT backend above), ``model`` (the weight head's state dict, unless
    ``use_weight_head`` is False), ``patch`` (7)."""

    def __init__(self, config, device=None):
        self.C = config
        self.device = resolve_device(device)
        self.patch = int(config.patch or 7)
        self.head = None
        if config.use_weight_head is not False:
            path = str(config.model)
            if not (config.model and os.path.exists(path)):
                raise FileNotFoundError(
                    f"weight-head checkpoint not found: {path}")
            state = torch.load(path, map_location="cpu", weights_only=True)
            head = WeightHead(HEAD_STRUCTURE, 1)
            head.load_state_dict(state, strict=True)
            self.head = head.to(self.device).eval()
        self.backend_fn = config.backend_fn or make_raft_backend(
            config, self.device)
        self.model = getattr(self.backend_fn, "model", None)

    @torch.no_grad()
    def _weights(self, cost_volume, hw):
        """Weight logits at the images' size, (1, H, W, 1)."""
        logits = cost_volume_weight_head(self.head, cost_volume, self.patch)
        return upsample2d_align_corners(logits, hw)

    def make_flow_fn(self):
        """The tracker's flow seam ``(model, img1, img2, template_feats=None)
        -> (flow (1, H, W, 2), sigmoided weights (1, H, W, 1))``; uniform
        ones without the head (ablations 10 and 11)."""

        @torch.no_grad()
        def flow_fn(model, img1, img2, template_feats=None):
            flow, cost_volume = self.backend_fn(img1, img2)
            if self.head is None:
                return flow, torch.ones_like(flow[..., :1])
            return flow, torch.sigmoid(self._weights(cost_volume,
                                                     img2.shape[1:3]))

        return flow_fn

    @torch.no_grad()
    def compute_flow(self, src_img, dst_img, mode="TC", vis=False,
                     src_img_identifier=None, numpy_out=False,
                     do_sigmoid=False):
        """Reference-compatible entry: BGR uint8 images -> (flow, weights)
        or (src, dst, weights) TCs; the weights are None without a head
        (where the reference has no head to call). ``vis`` and
        ``src_img_identifier`` are accepted and unused, as in the
        reference."""
        if mode not in ("flow", "TC"):
            raise ValueError(f"mode must be 'flow' or 'TC', got {mode!r}")
        flow, cost_volume = self.backend_fn(upload_bgr(src_img, self.device),
                                            upload_bgr(dst_img, self.device))
        H, W = src_img.shape[:2]
        weights = (None if self.head is None
                   else self._weights(cost_volume, (H, W)))
        if do_sigmoid and weights is not None:
            weights = torch.sigmoid(weights)
        if mode == "flow":
            out = (flow[0].permute(2, 0, 1),
                   None if weights is None else weights[0, ..., 0])
        else:
            src_coords = featuremap_coords((H, W), self.device)
            dst_coords = src_coords + flow[0].reshape(-1, 2).T
            out = (src_coords, dst_coords,
                   None if weights is None else weights[0].reshape(1, -1))
        if numpy_out:
            out = tuple(None if o is None else o.cpu().numpy() for o in out)
        return out
