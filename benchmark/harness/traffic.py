"""The traffic generator: frames of a textured plane following a walk.

A traffic file (``benchmark/traffic/<name>.json``) gives the parameters:
the frame size, the texture's octaves, the walk's step (pose t is a
rotation of ``t * theta`` and a scale of ``1 + t * scale`` about the
frame's centre, then a shift of ``t * (tx, ty)`` and a perspective row
``t * (px, py)``), the number of poses and how the frames visit them
(``pingpong``: 1, 2, ..., n, n-1, ..., 2, 1, 2, ...), and the target (the
centred box of ``target_frac`` of each side). The seed draws the texture;
every seed gets the same sizes, poses and order. Frames are rendered by
the benchmark's own plain warp and held on the host as BGR uint8.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..reference import warp as rwarp


def textured_frame(h, w, seed, octaves):
    """(h, w, 3) uint8 BGR: octaves (cell size, amplitude) of smooth noise
    drawn from ``seed``."""
    g = torch.Generator().manual_seed(int(seed))
    img = torch.zeros(1, 3, h, w)
    for cell, amp in octaves:
        noise = torch.rand(1, 3, h // cell + 1, w // cell + 1, generator=g)
        img += amp * F.interpolate(noise, size=(h, w), mode="bilinear",
                                   align_corners=False)
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    return np.ascontiguousarray(
        img[0].permute(1, 2, 0).round().to(torch.uint8).numpy())


def pose(t, step, h, w):
    """Pose ``t`` of the walk (template -> frame), (3, 3) float64."""
    theta, scale = t * step["theta"], 1 + t * step["scale"]
    c, s = math.cos(theta) * scale, math.sin(theta) * scale
    cx, cy = w / 2, h / 2
    return np.array([[c, -s, cx - c * cx + s * cy + t * step["tx"]],
                     [s, c, cy - s * cx - c * cy + t * step["ty"]],
                     [t * step["px"], t * step["py"], 1.0]], np.float64)


def schedule(n_poses, kind):
    """One period of pose indices."""
    if kind != "pingpong":
        raise ValueError(f"unknown schedule {kind!r}")
    up = list(range(1, n_poses + 1))
    return up + up[-2:0:-1]


def target(h, w, frac):
    """(h, w) bool mask of the centred box of ``frac`` of each side, and
    its corners (4, 2) (x, y), inclusive."""
    mask = np.zeros((h, w), bool)
    y0, y1 = int(h * (1 - frac) / 2), int(h * (1 + frac) / 2)
    x0, x1 = int(w * (1 - frac) / 2), int(w * (1 + frac) / 2)
    mask[y0:y1, x0:x1] = True
    corners = np.array([[x0, y0], [x1 - 1, y0], [x1 - 1, y1 - 1],
                        [x0, y1 - 1]], np.float64)
    return mask, corners


class Traffic:
    """The frames of one seed: ``template`` and ``frames[i]`` (BGR uint8,
    frame i at pose i + 1), ``order`` (one period of frame indices),
    ``mask`` and ``corners`` of the target, ``poses``."""

    def __init__(self, spec, seed, device):
        h, w = spec["height"], spec["width"]
        self.hw = (h, w)
        self.template = textured_frame(h, w, seed, spec["octaves"])
        self.mask, self.corners = target(h, w, spec["target_frac"])
        n = spec["poses"]
        self.poses = [pose(t, spec["step"], h, w) for t in range(1, n + 1)]
        src = torch.from_numpy(self.template).to(device).float()[None]
        Hs = torch.tensor(np.stack(self.poses), dtype=torch.float32,
                          device=device)
        self.frames = []
        for H in Hs:
            f = rwarp.warp(src, H)[0].round().clamp(0, 255)
            self.frames.append(f.to(torch.uint8).cpu().numpy())
        self.order = [t - 1 for t in schedule(n, spec["schedule"])]

    def frame_index(self, k):
        """The frame handed k-th (k = 0 first after the template)."""
        return self.order[k % len(self.order)]
