"""Integer downscales of uint8 images: the twin of ``cv2.resize(img, None,
fx=1/s, fy=1/s)`` (``INTER_LINEAR``), the resize the reference's tracker
shell runs on the host for its ``downscale`` option.

OpenCV computes these in fixed point, and for s = 2, 3, 4 its results have
closed forms (``tests/test_torch_downscale.py`` holds them against
``cv2.resize``):

- the output is ``cvRound(H / s) x cvRound(W / s)``, halves rounded to
  even (1280 / 3 -> 427);
- s = 2: OpenCV takes its area path: the 2x2 block at (2y, 2x) as
  ``(a + b + c + d + 2) >> 2``; where the output rounds up and the last
  row or column of blocks lies partly outside the image, the mean of the
  pixels inside, rounded half to even;
- s = 3: the linear weights are (1, 0): the pixel at (3y + 1, 3x + 1);
- s = 4: the weights are (1/2, 1/2): ``(a + b + c + d + 2) >> 2`` over the
  2x2 block at (4y + 1, 4x + 1), indices clamped to the image.

Plain PyTorch on integer tensors, on whatever device the image is on: the
port's shell resizes the uploaded frame on the card.
"""

import torch

SCALES = (1, 2, 3, 4)


def downscaled_size(h, w, s):
    """OpenCV's output size for ``fx = fy = 1/s``: ``cvRound(n * (1/s))``
    (Python's ``round`` of a float also rounds halves to even)."""
    return round(h * (1.0 / s)), round(w * (1.0 / s))


def resize_down(img, s):
    """``img`` (H, W) or (H, W, C) uint8 tensor, downscaled by the integer
    factor ``s`` in {1, 2, 3, 4} as ``cv2.resize(INTER_LINEAR)`` does (1:
    unchanged). Returns a uint8 tensor of ``downscaled_size`` on ``img``'s
    device."""
    if s not in SCALES:
        raise ValueError(f"downscale factor {s} is not supported; use one "
                         f"of {SCALES}")
    if img.dtype != torch.uint8:
        raise ValueError(f"resize_down takes uint8 images, got {img.dtype}")
    if s == 1:
        return img
    H, W = img.shape[:2]
    oh, ow = downscaled_size(H, W, s)
    dev = img.device
    ys = torch.arange(oh, device=dev)
    xs = torch.arange(ow, device=dev)
    if s == 3:
        return img[(3 * ys + 1).clamp(max=H - 1)][:, (3 * xs + 1).clamp(
            max=W - 1)]
    off = 0 if s == 2 else 1
    y0, x0 = s * ys + off, s * xs + off
    y1, x1 = y0 + 1, x0 + 1
    vy, vx = y1 < H, x1 < W                 # the block's second row / column
    y0, x0 = y0.clamp(max=H - 1), x0.clamp(max=W - 1)
    y1, x1 = y1.clamp(max=H - 1), x1.clamp(max=W - 1)
    v = img.to(torch.int32)
    r0, r1 = v[y0], v[y1]
    a, b, c, d = r0[:, x0], r0[:, x1], r1[:, x0], r1[:, x1]
    if s == 4:                              # clamped corners are replicas
        return ((a + b + c + d + 2) >> 2).to(torch.uint8)
    # s = 2: full blocks, and the partial last row / column of an output
    # that rounded up (OpenCV: the float mean of the pixels inside)
    shape = (oh, ow) + (1,) * (img.dim() - 2)
    my = vy.to(torch.int32).reshape((oh, 1) + shape[2:])
    mx = vx.to(torch.int32).reshape((1, ow) + shape[2:])
    total = a + b * mx + c * my + d * (mx * my)
    count = (1 + mx) * (1 + my)
    partial = torch.round(total.to(torch.float32) / count).to(torch.int32)
    out = torch.where(count == 4, (total + 2) >> 2, partial)
    return out.to(torch.uint8)
