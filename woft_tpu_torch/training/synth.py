"""Synthetic homography pairs for the weight head's training.

PyTorch twin of ``woft_tpu/training/synth.py``: given a batch of source
images, draw a random perspective warp per image (a 4-corner perturbation
plus a global translation, fitted exactly by the DLT through the four
corners), render the warped view, and jitter brightness, contrast and
noise on both sides. The draws (``synth_draws``, from an explicit
``torch.Generator`` on its device; JAX's PRNG is not reproduced) are kept
apart from the arithmetic (``homographies_from_draws``, ``photometric``,
``synth_from_draws``), so the arithmetic can be held against the JAX
package's on given draws.

The render is ``ops/warp.py:warp_perspective_fast``: on the card, kernel A
warps the N sources by their N homographies in one launch; on the CPU, the
plain ``warp_perspective``, the twin of the JAX package's render.
"""

import torch

from ..geometry.homography import find_homography_wls_qr
from ..ops.warp import warp_perspective_fast


def _corners(height, width, device):
    return torch.tensor([[0.0, 0.0], [width - 1.0, 0.0],
                         [width - 1.0, height - 1.0], [0.0, height - 1.0]],
                        device=device)


def homographies_from_draws(shift, translation, height, width, *,
                            max_corner_shift=0.2, max_translation=0.1):
    """(B, 3, 3) source -> warped homographies from draws in [-1, 1]:
    shift (B, 4, 2) moves each corner by up to ``max_corner_shift`` of the
    image size, translation (B, 1, 2) all four by up to
    ``max_translation``; the exact DLT through the four correspondences."""
    size = torch.tensor([width, height], dtype=torch.float32,
                        device=shift.device)
    corners = _corners(height, width, shift.device)
    warped = (corners + shift * size * max_corner_shift
              + translation * size * max_translation)
    return find_homography_wls_qr(corners.expand_as(warped), warped)


def photometric(img, gain, bias, noise):
    """Brightness/contrast jitter plus noise, clipped to [0, 255]: img (B,
    H, W, 3), gain and bias (B,), noise (B, H, W, 3) (3 x a standard
    normal draw)."""
    return torch.clamp(img * gain[:, None, None, None]
                       + bias[:, None, None, None] + noise, 0.0, 255.0)


def synth_draws(generator, batch, height, width, jitter=True):
    """Every random number of one synthetic batch, drawn from
    ``generator`` on its device: 'shift' (B, 4, 2) and 'translation' (B,
    1, 2) uniform in [-1, 1); with ``jitter`` 'gain' (B, 2) in [0.8, 1.2),
    'bias' (B, 2) in [-20, 20) and 'noise' (B, 2, H, W, 3) = 3 x standard
    normal, index 0 for img1 and 1 for img2."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=dev)

    draws = {"shift": uniform((batch, 4, 2), -1.0, 1.0),
             "translation": uniform((batch, 1, 2), -1.0, 1.0)}
    if jitter:
        draws.update(
            gain=uniform((batch, 2), 0.8, 1.2),
            bias=uniform((batch, 2), -20.0, 20.0),
            noise=3.0 * torch.randn((batch, 2, height, width, 3),
                                    generator=generator, device=dev))
    return draws


def synth_from_draws(images, draws, *, max_corner_shift=0.2,
                     max_translation=0.1):
    """The training pairs of ``synth_homography_batch`` from given draws
    (``synth_draws``; without 'gain' no jitter)."""
    B, H, W, _ = images.shape
    draws = {k: v.to(images.device) for k, v in draws.items()}
    hs = homographies_from_draws(
        draws["shift"], draws["translation"], H, W,
        max_corner_shift=max_corner_shift, max_translation=max_translation)
    img2 = warp_perspective_fast(images, hs)
    img1 = images
    if "gain" in draws:
        img1 = photometric(images, draws["gain"][:, 0], draws["bias"][:, 0],
                           draws["noise"][:, 0])
        img2 = photometric(img2, draws["gain"][:, 1], draws["bias"][:, 1],
                           draws["noise"][:, 1])
    return {"img1": img1, "img2": img2, "h_gt": hs}


def random_homography(generator, height, width, *, max_corner_shift=0.2,
                      max_translation=0.1):
    """One random (3, 3) homography, source pixels -> warped pixels."""
    d = synth_draws(generator, 1, height, width, jitter=False)
    return homographies_from_draws(
        d["shift"], d["translation"], height, width,
        max_corner_shift=max_corner_shift,
        max_translation=max_translation)[0]


@torch.no_grad()
def synth_homography_batch(generator, images, *, max_corner_shift=0.2,
                           max_translation=0.1, jitter=True):
    """Training pairs from a batch of images.

    generator: a ``torch.Generator`` (its device draws the numbers);
    images: (B, H, W, 3) float RGB in [0, 255] on the device the pairs are
    made on. Returns dict(img1, img2 (B, H, W, 3), h_gt (B, 3, 3)), h_gt
    mapping img1 pixels to img2 pixels."""
    B, H, W, _ = images.shape
    return synth_from_draws(
        images, synth_draws(generator, B, H, W, jitter),
        max_corner_shift=max_corner_shift, max_translation=max_translation)
