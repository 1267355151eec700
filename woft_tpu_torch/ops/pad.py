"""Input padding policies for /8-divisible flow-network inputs (NHWC).

PyTorch twin of ``woft_tpu/ops/pad.py``; every policy's shape arithmetic
depends on the input shape only:

- ``NoPadder`` requires /8 sizes and leaves the images as they are;
- ``CropPadder`` crops bottom/right to /8 (the flow keeps the cropped
  size, as in the reference);
- ``ReplicatePadder`` edge-replicates to /8, the padding centred ('sintel'
  mode), the policy RAFT's ``InputPadder`` and the ``RAFT`` mode name;
- ``ResizePadder`` bilinearly resizes to /8 and back, rescaling the flow
  on unpad (the ``Michal`` mode).

Where the reference asserts /8 sizes, ``NoPadder`` raises ``ValueError``.
"""

import torch
import torch.nn.functional as F


class NoPadder:
    name = "nopad"

    def __init__(self, shape):
        H, W = shape[1], shape[2]
        if H % 8 or W % 8:
            raise ValueError(f"nopad needs /8 sizes, got {H}x{W}")

    def pad(self, *imgs):
        return imgs

    def unpad(self, x):
        return x


class CropPadder:
    name = "crop"

    def __init__(self, shape):
        H, W = shape[1], shape[2]
        self.crop_h = (H // 8) * 8
        self.crop_w = (W // 8) * 8

    def pad(self, *imgs):
        return tuple(img[:, :self.crop_h, :self.crop_w, :] for img in imgs)

    def unpad(self, x):
        return x


class ReplicatePadder:
    """Replicate-pad to /8, the padding centred (RAFT's 'sintel' mode, the
    one the reference's configs use)."""

    name = "RAFT"

    def __init__(self, shape):
        H, W = shape[1], shape[2]
        pad_h = (((H // 8) + 1) * 8 - H) % 8
        pad_w = (((W // 8) + 1) * 8 - W) % 8
        self._pad = (pad_w // 2, pad_w - pad_w // 2,
                     pad_h // 2, pad_h - pad_h // 2)

    def pad(self, *imgs):
        if not any(self._pad):
            return imgs
        # F.pad's replicate mode takes NCHW
        return tuple(F.pad(img.permute(0, 3, 1, 2), self._pad,
                           mode="replicate").permute(0, 2, 3, 1)
                     for img in imgs)

    def unpad(self, x):
        if x is None:
            return None
        left, right, top, bottom = self._pad
        H, W = x.shape[1], x.shape[2]
        return x[:, top:H - bottom, left:W - right, :]


def _resize(x, hw, shrink):
    """Half-pixel bilinear resize of NHWC ``x`` to ``hw``: the reference's
    ``jax.image.resize(method='linear')``. That resize widens its triangle
    kernel by the scale on an axis that shrinks (antialiasing) and not on
    one that grows; ``F.interpolate``'s ``antialias`` does the same on
    shrinking axes, and on growing ones its edge weights differ, so it is
    set only for a resize that shrinks (an axis of equal size is the
    identity either way)."""
    out = F.interpolate(x.permute(0, 3, 1, 2), size=hw, mode="bilinear",
                        align_corners=False, antialias=shrink)
    return out.permute(0, 2, 3, 1)


class ResizePadder:
    """Bilinear-resize to /8 multiples; rescale flow on unpad. Padding only
    grows an axis, unpadding only shrinks it."""

    name = "Michal"

    def __init__(self, shape):
        H, W = shape[1], shape[2]
        self.h_orig, self.w_orig = H, W
        self.h_new = ((H + 7) // 8) * 8
        self.w_new = ((W + 7) // 8) * 8

    def pad(self, *imgs):
        return tuple(_resize(img, (self.h_new, self.w_new), shrink=False)
                     for img in imgs)

    def unpad(self, x):
        if x is None:
            return None
        if x.shape[1:3] != (self.h_new, self.w_new):
            raise ValueError(f"unpad expects {self.h_new}x{self.w_new}, got "
                             f"{x.shape[1]}x{x.shape[2]}")
        resized = _resize(x, (self.h_orig, self.w_orig), shrink=True)
        if x.shape[3] == 2:  # flow field: rescale displacement values
            resized = torch.stack(
                [resized[..., 0] * (self.w_orig / self.w_new),
                 resized[..., 1] * (self.h_orig / self.h_new)], dim=-1)
        return resized


_PADDERS = {
    "nopad": NoPadder,
    "crop": CropPadder,
    "RAFT": ReplicatePadder,
    "Michal": ResizePadder,
}


def make_padder(mode, shape):
    """Padding-policy factory keyed by the reference's config strings."""
    try:
        padder = _PADDERS[mode]
    except KeyError:
        raise ValueError(f"invalid padding_mode '{mode}'") from None
    return padder(shape)
