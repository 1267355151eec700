#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check its CUDA kernels.

Run from the root of a checkout:

    python3 chip_smoke.py

It imports neither JAX nor the JAX package, and exits non-zero (printing no
result) when there is no CUDA device or no ``woft_tpu_torch`` beside it.
Phases; any failure ends the script with a non-zero exit:

1. the card's name and power limit (``nvidia-smi``), the TF32 flags;
2. build the kernels from ``woft_tpu_torch/csrc/*.cu`` with ``nvcc``;
3. hold each kernel (A pre-warp, B pyramid lookup, C block-local volume,
   D, E, F block-local lookups, D and E both from the coordinates, as the
   main path calls them, and from explicit operands, G fused GRU
   direction, H motion-encoder tail, I flow head) against its plain
   PyTorch version on the card at the 1280x720 main-path shapes (D and E
   from coordinates also at an odd shape, bf16 and float32; A also at the
   window tracker's crop, 1920x1080 into 192x344 at scale 0.3, partly off
   the image), and time
   kernel, plain version, a PyTorch library yardstick the port never calls
   (G, H, I have none, ``library_ms`` null: beside them the port's own
   unfused cuDNN path for the same function, several calls,
   ``unfused_ms``), and the memory/compute bound; A at three poses, B dense and indexed, C (all four
   levels in one launch), E (every level of a lookup in one launch, with
   the guard's flagged blocks and with none), D, G (each direction), H
   (its two launches) and I, each beside its time before the redesign,
   B's reads also counted in the 32-byte sectors device memory moves, as
   are D's (the union of each 16-query row's patches), E's bound counting the flagged blocks only; one guarded block-local
   lookup traced with ``torch.profiler``: two kernel launches;
4. track 1280x720 frames through ``WOFTTracker`` with the canonical
   ``configs/WOFT.py``, with ``configs/WOFT_fast.py`` (block-local
   correlation, bf16), and with ``WOFT_fast.py`` plus the fused refinement
   loop (``gru_fused``, ``tail_fused``: kernels G and I); all full-width
   RAFT-large on the trained full-frame weights
   (``weights/wraft_tpu_v4_torch.pt``), each with the launch counters
   zeroed before and read after, and each followed by the local-flow
   fallback (``redetection='never'``), C expected once a flow and D and E
   13 times (once a lookup), each printing its fallback rate and its
   per-frame corner error against the walk it tracks; then the ablation
   configs, each counted from 0 the same way: A pre-warping a 427x240
   frame and B on the four padded grids of the downscale paths against
   their plain versions, then ``configs/WOFT_downscale_3x.py`` at 1280x720
   (427x240, not /8) and 1920x1080 (640x360), ``WOFT_downscale_2x.py`` at
   1920x1080 (960x540), ``WOFT_downscale_4x.py`` at 1280x720 (320x180),
   ``WOFT_wIRLSq.py`` and ``WOFT.py`` with the dense weight head at
   1280x720 (8 frames of the walk and 3 fallback frames each: A once a
   frame and B 13 times a flow, exactly; corner errors in full-resolution
   pixels after the downscale compensation, held to the CPU path's bound,
   ``ABLATION_CORNER_BOUND_PX``), the dense head held to the sparse head
   on the same frames (``DENSE_HEAD_TOL_PX``); then, where ``cv2`` can be
   imported, ``WOFT_cvransac.py`` and ``WOFT_trs.py`` at 1280x720 (their
   host fits need it) the same way, else one line says so; then the rest
   of the flow-network family, each track counted from 0 the same way:
   kernel B's bf16-level form against its plain version on the same bf16
   levels (exact; the 720p pyramid dense and indexed, the 8-window batch's
   pyramid), timed beside its 2-byte-read bound and ``F.grid_sample`` x4;
   ``WOFT_rep.py`` (the v3 export), ``ablation_10.py`` (the external
   backend: 'orig' RAFT on v3's backbone, no head, plain QR; B 12 times a
   flow), ``WOFT_origraft.py`` (seeded weights, 24 iterations, B 24 times a
   flow, no accuracy bound), ``WOFT_masked.py`` (v4 and a seeded mask
   head) and ``WOFT.py`` in float32 and with ``precision='default'`` on the
   720p walk (corners held to ``FAMILY_CORNER_BOUND_PX`` where the weights
   are trained, 'default' also to the float32 track, each frame traced for
   device busy time); the masked forward on the card against the CPU path;
   ``MultiTargetTracker`` x8 on ``WOFT_window.py`` in bf16; the alternate
   correlation against kernel B at 720p, one flow's time beside the dense
   path's, and ``WOFT.py`` with ``alternate_corr`` at 3840x2160 (2 frames,
   peak memory); then the window
   paths on the trained window-mode weights
   (``weights/wraft_tpu_v5_torch.pt``), each counted from 0 the same way:
   ``WOFTWindowTracker`` under ``configs/WOFT_window.py`` at 1280x720 and
   1920x1080 and under ``configs/WOFT_window_native.py`` at 1280x720
   (kernel A twice a frame, B 13 times a flow), and ``bench.py``'s
   device-resident window step (``build_window_track_step``, block-local
   bf16, the 192x344 window at 1920x1080: A twice a frame, C once, D and E
   13 times a flow), each printing frame times, peak device memory,
   fallback rate, corner error against the walk (held to the CPU path's
   bound, ``WINDOW_CORNER_BOUND_PX``) and launches a frame; then one
   block-local forward whose
   ``flow_init`` makes blocks violate their fine windows, so that kernel E
   rewrites them;
5. references: the block-local forward must equal the dense one at
   1280x720 and at the 192x344 window in float32, and the fused bf16
   forward the unfused one to bf16 rounding noise; the window tracker on
   the card must match its CPU path on 3 frames at a 128 window; on small
   inputs an oracle-flow tracker must recover a
   known homography, and the RAFT forward on the card (dense, block-local,
   fused) must match the CPU path;
6. multi-target tracking at 1920x1080: kernels A-E at its shapes against
   their plain versions, timed beside their bounds (A cropping 8 windows
   of 256x256 from one frame in one launch, B on the pyramid of 8 windows
   of 32 x 32 cells and indexed at 36,000 rows, C, D, E on the 135 x 240
   grid); then, counted from 0 each, ``SharedMultiTracker`` under
   ``configs/WOFT_fast.py`` with 8 targets (``bench.py``'s layout, 8
   frames of the walk: every check passes, corners within
   ``MULTI_CORNER_BOUND_PX`` of the walk, two chunks of 4 equal to the
   per-frame run with no synchronizing operation in a chunk, fits in
   groups of 3 equal to one batch) and with 64 (one chunk of 4 frames;
   the launches a frame must not grow with the targets), and
   ``MultiTargetTracker`` under ``configs/WOFT_window.py`` with 8 windows
   of 256 (the same checks, and each target against the single-target
   window step); each prints frame ms, targets·frames/s, launches and
   device busy a frame (``torch.profiler``) and peak device memory;
7. a ``kernels`` JSON line (A-E with their launches on the multi-target
   paths and their times at its shapes; A and B also with their launches
   on the ablation paths, ``downscale_launches`` and
   ``ablation_launches``, their times at the downscale shapes, and their
   launches on the flow-family tracks, ``family_launches``; two rows for
   B's bf16-level form), then the device JSON as the last line.
"""

import json
import math
import os
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM dense bf16 on the tensor cores
WARP_TOL = 1e-4                  # same float32 ops in the same order: 0 expected
LOOKUP_TOL = 1e-5                # same float32 ops in the same order: 0 expected
FLOW_TOL_PX = 1e-3               # cuDNN vs CPU convolutions, 12 GRU iterations
BF16_FLOW_TOL_PX = 0.05          # the same in bf16 mode: each rounding of a
#                                  differently ordered sum may fall either way
# kernel C sums its D products in another order than the plain einsum:
# float32 accumulation error, then (bf16) at most one bf16 ulp
CORR_ATOL, CORR_RTOL_FP32, CORR_RTOL_BF16 = 2e-5, 1e-5, 2.0 ** -7
LOCAL_LOOKUP_TOL = 1e-6          # same float32 ops in the same order: 0 expected
CORNER_TOL_PX = 0.05             # oracle-flow homography recovery
# kernels G, H, I round to bf16 inside and sum in another order than their
# plain versions, so a rounding may fall the other way on a small share of
# entries. Stated in bf16 ulps (2^-8 relative) of the rounded quantity:
BF16_ULP = 2.0 ** -8
GRU_TOL_ULPS = 4         # G, float32 result: a flipped z, 1 - z, q or z * q
#                          moves it by one ulp of max(1, |h|); a few coincide
TAIL_TOL_ULPS = 2        # H, bf16 result: one ulp (2 bounds any mantissa),
#                          plus one ulp of the map's scale from flipped
#                          first-stage activations
HEAD_TOL_ULPS = 1        # I, float32 delta: one ulp of the map's scale
UPDATE_DIFF_SHARE = 0.02         # G, H: at most this share of entries differs
H_IMG, W_IMG = 720, 1280
# the window paths' feature grids (1/8 of the window): the 192x344 window of
# bench.py's step and of WOFT_window.py at 720p and 1080p, and the 320x512
# window of WOFT_window_native.py at 720p. The block-local step's is the
# first: 43 columns are not a multiple of the 16-column block
WINDOW_GRIDS = ((24, 43), (40, 64))
# the multi-target paths' frame, and its feature grid (the shared-flow
# path's block-local volume: 17 x 15 = 255 query blocks)
MULTI_H, MULTI_W = 1080, 1920
MULTI_GRID = (MULTI_H // 8, MULTI_W // 8)
# The bound on each target's corner error against the walk on the multi-
# target paths (template pixels), set before their first card run: the
# window paths' bound at 1080p (CPU window track 0.931 px on the walk,
# tools/torch_window_walks.py), where the full-frame tracks read 0.17-0.26
# px at 720p on the card
MULTI_CORNER_BOUND_PX = 1.5
CHUNK_TOL_PX = 1e-3     # a chunk queues the same steps without host syncs
# a batch of N windows, or fits in groups, through other convolution
# algorithms than one window or one group: other summation orders, passed
# on through 8 frames of crops chosen from the last estimate (5e-5 px over
# 3 frames on a CPU, tests/test_torch_pipeline.py); held to the bound the
# CPU tests hold the two packages to
BATCH_TOL_PX = CORNER_TOL_PX
# Kernels A and B before their redesign (A: one thread a pixel over 256 x 1
# strips; B: one thread an output element), ms at the same shapes, measured
# with time_ms on an NVIDIA H100 80GB HBM3, power limit 700.00 W
PARENT_WARP_MS = {"near identity": 0.0150, "30 deg, 1.5x scale": 0.0154,
                  "partly off-image": 0.0106}
PARENT_LOOKUP_MS = {"dense": 0.2095, "indexed": 0.0670}
# Kernels C and E before their redesign (C: four launches a flow, mma.sync;
# E: four launches a lookup), ms at the 720p shapes, the mean of two runs
# of tools/torch_local_times.py --root <parent checkout> in one call on an
# NVIDIA H100 80GB HBM3, power limit 700.00 W
PARENT_LOCAL_CORR_MS = {"bfloat16": 0.2734, "float32": 1.2105}
PARENT_LOCAL_EXACT_MS = {"flagged": 0.0157, "none": 0.0103}
# Kernel D before its redesign (one CTA a window row, explicit operands
# computed by some 20 tensor ops a lookup), ms at the 720p shapes, measured
# by this script on the tree before the redesign on an NVIDIA H100 80GB
# HBM3, power limit 700.00 W
PARENT_LOCAL_FINE_MS = 0.0195
# Kernels G and I before their redesign (mma.sync fed by a two-stage
# cp.async ring of taps; G: blocks of 2 lines x 36 positions, I: 6 x 6
# output tiles), ms at the 720p shapes, measured by this script on the tree
# before the redesign on an NVIDIA H100 80GB HBM3, power limit 700.00 W
PARENT_GRU_MS = {"w": 0.1105, "h": 0.1134}
PARENT_HEAD_MS = 0.0974
# Kernel H before its redesign (one launch on the mma.sync pass, 6 x 6
# output tiles recomputing 44 % of the first stage as halo), ms at the 720p
# shape, measured by this script on the tree before the redesign on an
# NVIDIA H100 80GB HBM3, power limit 700.00 W
PARENT_TAIL_MS = 0.3174


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events). The
    device first spins for a few milliseconds, so the calls queue up behind
    the spin and run back to back: a kernel shorter than its Python launch
    is timed on the device, not at the rate the host can enqueue it."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_flops, flops_per_s=FP32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def textured_frame(h, w, seed):
    """(h, w, 3) uint8 BGR frame: octaves of smooth seeded noise."""
    g = torch.Generator().manual_seed(seed)
    img = torch.zeros(1, 3, h, w)
    for scale, amp in ((64, 1.0), (16, 0.5), (4, 0.25)):
        noise = torch.rand(1, 3, h // scale + 1, w // scale + 1, generator=g)
        img += amp * F.interpolate(noise, size=(h, w), mode="bilinear",
                                   align_corners=False)
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    return np.ascontiguousarray(
        img[0].permute(1, 2, 0).round().to(torch.uint8).numpy())


def pose(theta=0.0, scale=1.0, tx=0.0, ty=0.0, persp=(0.0, 0.0),
         center=(W_IMG / 2, H_IMG / 2)):
    """Rotation + scale about ``center``, then translation and a
    perspective row: (3, 3) float32."""
    c, s = math.cos(theta) * scale, math.sin(theta) * scale
    cx, cy = center
    H = np.array([[c, -s, cx - c * cx + s * cy + tx],
                  [s, c, cy - s * cx - c * cy + ty],
                  [persp[0], persp[1], 1.0]], np.float64)
    return torch.tensor(H, dtype=torch.float32)


def warp_poses():
    """The three 720p poses kernel A is checked and timed at."""
    return {
        "near identity": pose(0.002, 1.003, 1.5, -0.7),
        "30 deg, 1.5x scale": pose(math.radians(30), 1.5, 20.0, -10.0),
        "partly off-image": pose(0.05, 0.9, 600.0, 300.0, (2e-5, -1e-5)),
    }


def check_warp(kernels, warp, frame, dev):
    """Kernel A against the plain warp at three 720p poses, each timed; the
    ``kernels`` row is the near-identity pose, the tracker's steady case."""
    poses = warp_poses()
    img_nchw = frame.permute(0, 3, 1, 2).contiguous()
    px = H_IMG * W_IMG
    # per pixel: 3 back-projection rows (2 mul + 2 add), 2 div,
    # floor/fraction (4), 3 channels x 4 corners x (2 mul + 1 add)
    bnd, by = bound_ms(2 * px * 3 * 4 + 36, px * (12 + 2 + 4 + 36))
    result = None
    for name, H in poses.items():
        H = H.to(dev)
        hinv = warp.inverse_h(H[None])
        want = warp.warp_perspective(frame, H)
        got = kernels.warp_perspective_bilinear(frame, hinv, H_IMG, W_IMG)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        log(f"kernel A [{name}]: max_abs_err {err:.3g} (tol {WARP_TOL})")
        if not err <= WARP_TOL:
            raise AssertionError(f"kernel A disagrees at '{name}': {err}")
        coords = warp.perspective_coords(H[None], (H_IMG, W_IMG))
        grid = torch.stack([2 * coords[..., 0] / (W_IMG - 1) - 1,
                            2 * coords[..., 1] / (H_IMG - 1) - 1], -1)
        ms = time_ms(lambda: kernels.warp_perspective_bilinear(
            frame, hinv, H_IMG, W_IMG))
        library_ms = time_ms(lambda: F.grid_sample(
            img_nchw, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True))
        log(f"kernel A timing ({name}): kernel {ms:.4f} ms (before the "
            f"redesign {PARENT_WARP_MS[name]:.4f} ms), F.grid_sample "
            f"{library_ms:.4f} ms, bound {bnd:.4f} ms ({by})")
        if result is None:
            plain_ms = time_ms(lambda: warp.warp_perspective(frame, H))
            log(f"kernel A timing ({name}): plain {plain_ms:.4f} ms")
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bnd, bound_by=by, library_ms=library_ms)
        result["max_abs_err"] = max(result["max_abs_err"], err)
    result["max_abs_err"] = max(result["max_abs_err"],
                                check_window_crop(kernels, warp, dev))
    return result


def check_window_crop(kernels, warp, dev):
    """Kernel A at the window tracker's crop: a 1920x1080x3 frame into the
    192x344 window of ``bench.py``'s 256 budget at scale 0.3, partly off
    the image. One warp's 32 pixels span about 107 source columns; the
    kernel must stay exact there. Timed beside ``F.grid_sample``; its time
    is the crop's, not a bound's. Returns its max abs error."""
    src = torch.tensor(textured_frame(1080, 1920, seed=4),
                       dtype=torch.float32, device=dev)[None]
    out_hw = (192, 344)
    s = 0.3
    H = torch.tensor([[s, 0.0, -s * 1500.0], [0.0, s, -s * 520.0],
                      [0.0, 0.0, 1.0]], device=dev)     # x 1500..2647 of 1919
    hinv = warp.inverse_h(H[None])
    want = warp.warp_perspective(src, H, out_hw)
    got = kernels.warp_perspective_bilinear(src, hinv, *out_hw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    off = (want[0].abs().sum(-1) == 0).float().mean().item()
    log(f"kernel A [window crop 1920x1080 -> 192x344, scale {s}, "
        f"{off:.0%} of the window off the image]: max_abs_err {err:.3g} "
        f"(tol {WARP_TOL})")
    if not err <= WARP_TOL or not 0.2 < off < 0.8:
        raise AssertionError(f"kernel A disagrees at the window crop: {err}")
    coords = warp.perspective_coords(H[None], out_hw)
    grid = torch.stack([2 * coords[..., 0] / (1920 - 1) - 1,
                        2 * coords[..., 1] / (1080 - 1) - 1], -1)
    src_nchw = src.permute(0, 3, 1, 2).contiguous()
    ms = time_ms(lambda: kernels.warp_perspective_bilinear(src, hinv,
                                                           *out_hw))
    plain_ms = time_ms(lambda: warp.warp_perspective(src, H, out_hw))
    library_ms = time_ms(lambda: F.grid_sample(
        src_nchw, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True))
    log(f"kernel A timing (window crop): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, F.grid_sample {library_ms:.4f} ms")
    return err


def _window_bytes(levels, coords, rows, radius, sector=None):
    """Bytes of the in-bounds (2r+2)^2 windows this lookup needs, each
    (pyramid row, level) window counted once, at the levels' element size
    (4 bytes float32, 2 bf16). With ``sector`` every row segment of a
    window is widened to the edges of the sectors of that many bytes it
    touches: what device memory moves for it (the levels start
    sector-aligned)."""
    elem = levels[0].element_size()
    if rows is None:
        rows = torch.arange(coords.shape[0], device=coords.device)
    else:
        uniq, first = np.unique(rows.cpu().numpy(), return_index=True)
        rows = torch.as_tensor(uniq, device=coords.device)
        coords = coords[torch.as_tensor(first, device=coords.device)]
    total = 0
    for lvl, p in enumerate(levels):
        hl, wl = p.shape[1:]
        c = torch.floor(coords / 2 ** lvl).long()
        xa = (c[:, 0] - radius).clamp(min=0)
        ya = (c[:, 1] - radius).clamp(min=0)
        nx = ((c[:, 0] + radius + 1).clamp(max=wl - 1) - xa + 1).clamp(min=0)
        ny = ((c[:, 1] + radius + 1).clamp(max=hl - 1) - ya + 1).clamp(min=0)
        if sector is None:
            total += int((nx * ny).sum().item()) * elem
            continue
        dy = torch.arange(2 * radius + 2, device=coords.device)
        live = (dy[None, :] < ny[:, None]) & (nx[:, None] > 0)
        start = ((rows[:, None] * hl + ya[:, None] + dy) * wl
                 + xa[:, None]) * elem
        end = start + nx[:, None] * elem
        n_sec = (end - 1) // sector - start // sector + 1
        total += int((n_sec * live).sum().item()) * sector
    return total


def lookup_case(corr, dev, H1=H_IMG // 8, W1=W_IMG // 8):
    """Kernel B's inputs, by default at 720p: the 4-level pyramid of seeded
    features (1.1 GB at 720p), Q = H1 * W1 coordinates up to 20 cells off
    their own cell with a few far outside, and M = 4,500 cells (with
    duplicates) with their coordinates for the indexed form."""
    g = torch.Generator(device=dev).manual_seed(1)
    D = 256
    f1 = torch.randn(1, H1, W1, D, device=dev, generator=g)
    f2 = torch.randn(1, H1, W1, D, device=dev, generator=g)
    pyramid, _ = corr.corr_pyramid_fused(f1, f2, 4)
    flow = (torch.rand(1, H1, W1, 2, device=dev, generator=g) - 0.5) * 40
    coords = (_cell_grid(dev, H1, W1) + flow).contiguous()
    coords[0, :4] = torch.tensor([-300.0, 1e4], device=dev)   # far outside
    cells = torch.randint(0, H1 * W1, (4500,), device=dev, generator=g)
    cells[1::7] = cells[0::7][:cells[1::7].shape[0]]              # duplicates
    return pyramid, coords, cells, coords.reshape(-1, 2)[cells].contiguous()


def check_lookup(kernels, corr, dev):
    """Kernel B against the plain lookup on the 720p pyramid, dense
    (Q = 90 * 160) and indexed (M = 4,500 cells, with duplicates), and
    dense on the pyramids of the window paths' grids (``WINDOW_GRIDS``)."""
    radius = 4
    pyramid, coords, cells, c_cells = lookup_case(corr, dev)
    Q, M = coords.numel() // 2, cells.numel()

    want = corr.corr_lookup_plain(pyramid, coords, radius)
    got = kernels.corr_pyramid_lookup(pyramid, coords, radius)
    got = got.reshape(want.shape)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    log(f"kernel B [dense Q={Q}]: max_abs_err {err:.3g} (tol {LOOKUP_TOL})")
    if not err <= LOOKUP_TOL:
        raise AssertionError(f"kernel B (dense) disagrees: {err}")
    if got[0, :4].abs().max().item() != 0.0:
        raise AssertionError("kernel B: far out-of-bounds windows not zero")

    want_i = corr.corr_lookup_plain([p[cells] for p in pyramid], c_cells,
                                    radius)
    got_i = kernels.corr_pyramid_lookup(pyramid, c_cells, radius, rows=cells)
    torch.cuda.synchronize()
    err_i = (got_i - want_i).abs().max().item()
    log(f"kernel B [indexed M={M}]: max_abs_err {err_i:.3g} (tol {LOOKUP_TOL})")
    if not err_i <= LOOKUP_TOL:
        raise AssertionError(f"kernel B (indexed) disagrees: {err_i}")
    for h1, w1 in WINDOW_GRIDS:
        pyr_w, coords_w, _, _ = lookup_case(corr, dev, h1, w1)
        want_w = corr.corr_lookup_plain(pyr_w, coords_w, radius)
        got_w = kernels.corr_pyramid_lookup(pyr_w, coords_w, radius)
        torch.cuda.synchronize()
        err_w = (got_w.reshape(want_w.shape) - want_w).abs().max().item()
        log(f"kernel B [dense, window grid {h1}x{w1}, Q={h1 * w1}]: "
            f"max_abs_err {err_w:.3g} (tol {LOOKUP_TOL})")
        if not err_w <= LOOKUP_TOL:
            raise AssertionError(f"kernel B (dense, {h1}x{w1}) disagrees: "
                                 f"{err_w}")
        err = max(err, err_w)
        del pyr_w, want_w, got_w

    # library yardstick: one F.grid_sample a level; the indexed form first
    # gathers the cells' rows of each level, inside the timed call
    k = 2 * radius + 1
    d = torch.arange(k, device=dev, dtype=torch.float32) - radius
    grids = []
    for lvl, p in enumerate(pyramid):
        hl, wl = p.shape[1:]
        c = coords.reshape(Q, 1, 1, 2) / 2 ** lvl
        gx = c[..., 0] + d[:, None]                # (Q, k, k): [q, i, j]
        gy = c[..., 1] + d[None, :]
        gx, gy = torch.broadcast_tensors(gx, gy)
        grids.append(torch.stack([2 * gx / (wl - 1) - 1,
                                  2 * gy / (hl - 1) - 1], -1))
    grids_i = [gr[cells] for gr in grids]
    levels_nchw = [p[:, None] for p in pyramid]

    def library(index=None):
        return [F.grid_sample(lv if index is None else lv[index], gr,
                              mode="bilinear", padding_mode="zeros",
                              align_corners=True)
                for lv, gr in zip(levels_nchw,
                                  grids if index is None else grids_i)]

    lib = torch.cat([o.reshape(Q, k * k) for o in library()], -1)
    lib_i = torch.cat([o.reshape(M, k * k) for o in library(cells)], -1)
    log(f"kernel B: F.grid_sample per level vs plain: max_abs_err "
        f"{(lib - want.reshape(Q, -1)).abs().max().item():.3g} dense, "
        f"{(lib_i - want_i).abs().max().item():.3g} indexed (yardstick)")
    del lib, lib_i
    ms = time_ms(lambda: kernels.corr_pyramid_lookup(pyramid, coords, radius))
    plain_ms = time_ms(lambda: corr.corr_lookup_plain(pyramid, coords,
                                                       radius))
    library_ms = time_ms(library)
    ms_i = time_ms(lambda: kernels.corr_pyramid_lookup(pyramid, c_cells,
                                                       radius, rows=cells))
    library_ms_i = time_ms(lambda: library(cells), iters=5, warmup=1)
    n_out = Q * 4 * k * k
    flat = coords.reshape(Q, 2)
    # per output: 4 corners x (2 mul + 1 add), fraction/weights ~6
    bnd, by = bound_ms(_window_bytes(pyramid, flat, None, radius) + Q * 8
                       + n_out * 4, n_out * 18)
    bnd_i, _ = bound_ms(_window_bytes(pyramid, c_cells, cells, radius)
                        + M * 16 + M * 4 * k * k * 4, M * 4 * k * k * 18)
    # the same reads in the 32-byte sectors device memory moves: no kernel
    # gets under this figure, the table's bound counts exact bytes
    sec = _window_bytes(pyramid, flat, None, radius, sector=32)
    sec_i = _window_bytes(pyramid, c_cells, cells, radius, sector=32)
    sec_ms, _ = bound_ms(sec + Q * 8 + n_out * 4, 0)
    sec_ms_i, _ = bound_ms(sec_i + M * 16 + M * 4 * k * k * 4, 0)
    log(f"kernel B timing (dense): kernel {ms:.4f} ms (before the redesign "
        f"{PARENT_LOOKUP_MS['dense']:.4f} ms), plain {plain_ms:.4f} ms, "
        f"F.grid_sample x4 levels {library_ms:.4f} ms, bound {bnd:.4f} ms "
        f"({by}); in 32-byte sectors the windows are {sec / 1e6:.1f} MB, "
        f"{sec_ms:.4f} ms with the output")
    log(f"kernel B timing (indexed M={M}): kernel {ms_i:.4f} ms (before the "
        f"redesign {PARENT_LOOKUP_MS['indexed']:.4f} ms), gather + "
        f"F.grid_sample x4 levels {library_ms_i:.4f} ms, bound {bnd_i:.4f} "
        f"ms; in 32-byte sectors {sec_i / 1e6:.1f} MB, {sec_ms_i:.4f} ms "
        f"with the output")
    # host side: the wrapper keeps the checked level table of the pyramid it
    # saw last (12 of a flow's 13 lookups reuse it)
    def rebuilt():
        kernels._level_table[0] = None
        kernels.corr_pyramid_lookup(pyramid, coords, radius)

    reused_us = host_us(lambda: kernels.corr_pyramid_lookup(pyramid, coords,
                                                            radius))
    log(f"kernel B wrapper, host time a call: {reused_us:.1f} us with the "
        f"pyramid's level table reused, {host_us(rebuilt):.1f} us with it "
        f"rebuilt every call")
    return dict(max_abs_err=max(err, err_i), ms=ms, plain_ms=plain_ms,
                bound_ms=bnd, bound_by=by, library_ms=library_ms)


def _cell_grid(dev, H1=H_IMG // 8, W1=W_IMG // 8):
    """(1, H1, W1, 2) (x, y) cell coordinates of a 1/8-resolution grid,
    by default 720p's 90 x 160."""
    ys, xs = torch.meshgrid(
        torch.arange(H1, device=dev, dtype=torch.float32),
        torch.arange(W1, device=dev, dtype=torch.float32),
        indexing="ij")
    return torch.stack([xs, ys], -1)[None]


def _local_coords(dev, kind, seed=5):
    """(1, 90, 160, 2) lookup centroids at 720p. 'smooth': a small affine
    residual plus a block row pushed far out (saturation), every full
    block inside its fine window. 'violating': a rotation-like field plus
    +-12 cells of jitter on some blocks, beyond their fine windows.

    90 rows are not a multiple of the 8-row block, so the last block row
    holds padding queries at coordinate (0, 0), as in the JAX package: their
    starts lie far from the real queries' and those 10 blocks violate their
    fine windows on every field."""
    H1, W1 = H_IMG // 8, W_IMG // 8
    grid = _cell_grid(dev)
    xs, ys = grid[0, ..., 0], grid[0, ..., 1]
    if kind == "smooth":
        res = torch.stack([0.02 * ys - 0.015 * xs + 2.3,
                           0.012 * xs + 0.01 * ys - 3.1], -1)[None]
        coords = grid + res
        coords[0, :8] += 400.0
    else:
        g = torch.Generator(device=dev).manual_seed(seed)
        res = torch.stack([-0.12 * (ys - H1 / 2), 0.12 * (xs - W1 / 2)],
                          -1)[None]
        jitter = (torch.rand(grid.shape, device=dev, generator=g) - 0.5) * 24
        res[0, 16:40, 32:96] += jitter[0, 16:40, 32:96]
        coords = grid + res
    return coords.contiguous()


def _local_corr_case(corr, dev, H1, W1, dtype):
    """Kernel C's operands at an H1 x W1 grid of seeded D = 256 features,
    4 levels, margin 16: (layout meta, f1 blocked (NB, 128, D), the
    levels, their geometries), in ``dtype``."""
    from woft_tpu_torch.ops.warp import avg_pool2d

    g = torch.Generator(device=dev).manual_seed(6)
    D = 256
    f1 = torch.randn(1, H1, W1, D, device=dev, generator=g)
    f2 = torch.randn(1, H1, W1, D, device=dev, generator=g)
    meta = corr._local_layout(H1, W1, 4, 4, 16)
    levels = [f2]
    for _ in meta["levels"][1:]:
        levels.append(avg_pool2d(levels[-1]))
    nb = meta["nbh"] * meta["nbw"]
    f1b = corr._to_blocked(f1.reshape(H1 * W1, D), meta).reshape(
        nb, -1, D).to(dtype).contiguous()
    lvs = [lv[0].to(dtype).contiguous() for lv in levels]
    geoms = [(d["pad"], d["sh"], d["sw"], d["wh"], d["ww"])
             for d in meta["levels"]]
    return meta, f1b, lvs, geoms


def _compare_local_corr(kernels, corr, case, dtype, rtol, grid):
    """Kernel C on ``case`` (``_local_corr_case``), all levels in one
    launch, against the plain construction level by level; raises on an
    entry beyond ``CORR_ATOL`` + ``rtol``. Returns the largest error."""
    meta, f1b, lvs, geoms = case
    nbh, nbw = meta["nbh"], meta["nbw"]
    name = str(dtype).split(".")[-1]
    n0 = kernels.local_corr_build.launches
    got_all = kernels.local_corr_build(f1b, lvs, geoms, nbh, nbw, dtype)
    torch.cuda.synchronize()
    if kernels.local_corr_build.launches != n0 + 1:
        raise AssertionError("kernel C took more than one launch")
    err = 0.0
    for d, lv, got in zip(meta["levels"], lvs, got_all):
        want = corr.block_local_corr_plain(f1b, lv, d, nbh, nbw, dtype)
        diff = (got.float() - want.float()).abs()
        bad = int((diff > CORR_ATOL + rtol * want.float().abs()).sum())
        share = (diff > 0).float().mean().item()
        err = max(err, diff.max().item())
        log(f"kernel C [{grid}, {name}, window {d['wh']}x{d['ww']}]: "
            f"max_abs_err {diff.max().item():.3g}, entries that differ "
            f"{100 * share:.3f} %, beyond atol {CORR_ATOL} + rtol "
            f"{rtol:.3g}: {bad}")
        if bad:
            raise AssertionError(f"kernel C ({grid}, {name}) disagrees on "
                                 f"{bad} entries at window "
                                 f"{d['wh']}x{d['ww']}")
    return err


def _time_local_corr(kernels, corr, case, dtype, rate, grid):
    """Times kernel C on ``case`` (all levels, one launch) beside its plain
    version, ``torch.bmm`` on pre-gathered windows and its bound; logs them
    and returns the row's numbers (``max_abs_err`` left to the caller)."""
    meta, f1b, lvs, geoms = case
    nbh, nbw = meta["nbh"], meta["nbw"]
    nb = nbh * nbw
    name = str(dtype).split(".")[-1]
    n_bytes, n_flops = f1b.numel() * f1b.element_size(), 0
    patches = []
    for d, lv in zip(meta["levels"], lvs):
        n_out = nb * f1b.shape[1] * d["wh"] * d["ww"]
        n_bytes += (lv.numel() + n_out) * lv.element_size()
        n_flops += 2 * n_out * f1b.shape[2]
        # the library yardstick's operand: the windows gathered as the
        # plain version gathers them (not timed)
        fp = F.pad(lv, (0, 0, d["pad"], d["wp"] - lv.shape[1] - d["pad"],
                        d["pad"], d["hp"] - lv.shape[0] - d["pad"]))
        patches.append(torch.stack([
            fp[by * d["sh"]:by * d["sh"] + d["wh"],
               bx * d["sw"] // 8 * 8:bx * d["sw"] // 8 * 8 + d["ww"]]
            for by in range(nbh) for bx in range(nbw)]).reshape(
                nb, -1, f1b.shape[2]))

    f1t = f1b.transpose(1, 2)
    ms = time_ms(lambda: kernels.local_corr_build(f1b, lvs, geoms, nbh,
                                                  nbw, dtype), iters=10)
    plain_ms = time_ms(lambda: [corr.block_local_corr_plain(
        f1b, lv, d, nbh, nbw, dtype)
        for d, lv in zip(meta["levels"], lvs)], iters=3, warmup=1)
    library_ms = time_ms(lambda: [torch.bmm(p, f1t) for p in patches],
                         iters=10)
    bnd, by = bound_ms(n_bytes, n_flops, rate)
    parent = (f" (the parent's four launches "
              f"{PARENT_LOCAL_CORR_MS[name]:.4f} ms)" if grid == "720p"
              else "")
    log(f"kernel C timing ({grid}, {nb} blocks, {name}, 4 levels = one "
        f"flow, one launch): kernel {ms:.4f} ms "
        f"({n_flops / ms / 1e9:.1f} TFLOP/s){parent}, plain "
        f"{plain_ms:.4f} ms, torch.bmm on gathered windows "
        f"{library_ms:.4f} ms, bound {bnd:.4f} ms ({by}; "
        f"{n_flops / 1e9:.1f} GFLOP, {n_bytes / 1e6:.1f} MB)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                library_ms=library_ms)


def check_local_corr(kernels, corr, dev):
    """Kernel C against the plain construction at the four 720p level
    shapes (120 blocks of 128 queries, D = 256) and at the window step's
    (24 x 43 cells: padding columns as well as rows), bf16 and float32:
    all four levels in one launch, each level compared; timed at 720p
    beside the parent's four launches, ``torch.bmm`` on pre-gathered
    windows and the bound."""
    H1, W1 = H_IMG // 8, W_IMG // 8
    result = {}
    for dtype, rtol, rate in ((torch.bfloat16, CORR_RTOL_BF16, BF16_FLOPS),
                              (torch.float32, CORR_RTOL_FP32, FP32_FLOPS)):
        name = str(dtype).split(".")[-1]
        err = _compare_local_corr(
            kernels, corr, _local_corr_case(corr, dev, *WINDOW_GRIDS[0],
                                            dtype),
            dtype, rtol, "%dx%d" % WINDOW_GRIDS[0])
        case = _local_corr_case(corr, dev, H1, W1, dtype)
        err = max(err, _compare_local_corr(kernels, corr, case, dtype, rtol,
                                           f"{H1}x{W1}"))
        result[name] = dict(max_abs_err=err, **_time_local_corr(
            kernels, corr, case, dtype, rate, "720p"))
    # the parameter block (tensor maps) is kept for the last pointer set:
    # host time of a call with it reused and with it rebuilt
    meta, f1b, lvs, geoms = _local_corr_case(corr, dev, H1, W1,
                                             torch.bfloat16)
    nbh, nbw = meta["nbh"], meta["nbw"]

    def rebuilt():
        kernels._corr_plan[0] = None
        kernels.local_corr_build(f1b, lvs, geoms, nbh, nbw, torch.bfloat16)

    reused_us = host_us(lambda: kernels.local_corr_build(
        f1b, lvs, geoms, nbh, nbw, torch.bfloat16))
    log(f"kernel C wrapper, host time a call: {reused_us:.1f} us with the "
        f"parameter block reused, {host_us(rebuilt):.1f} us with it rebuilt "
        f"(tensor maps encoded) every call")
    return result["bfloat16"]        # the WOFT_fast path builds bf16 volumes


def host_us(fn, calls=200):
    """Host time of one call of ``fn``, the device drained before and
    after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _grid_sample_lookup(vol_q, starts, frac, k):
    """Library yardstick of one level's lookup: ``F.grid_sample`` on the
    volume re-laid query-major, vol_q (NB*BQ, 1, wh, ww) float32."""
    n, _, wh, ww = vol_q.shape
    off = torch.arange(k, device=vol_q.device, dtype=torch.float32)
    cy = (starts[0].reshape(n, 1, 1) + frac[0].reshape(n, 1, 1)
          + off[None, :, None])
    cx = (starts[1].reshape(n, 1, 1) + frac[1].reshape(n, 1, 1)
          + off[None, None, :])
    cy, cx = torch.broadcast_tensors(cy, cx)
    grid = torch.stack([2 * cx / (ww - 1) - 1, 2 * cy / (wh - 1) - 1], -1)
    return F.grid_sample(vol_q, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def _row_sector_bytes(local, corr, coords, k):
    """Bytes of the 32-byte sectors kernel D must read at these coordinates:
    at one (y, x) the 16 queries of a query row are one bf16 sector, so it
    is the union of each query row's (k+1) x (k+1) patches, counted in
    positions, times 16 queries' bytes."""
    starts, _ = corr._local_level_coords(local, coords)
    rcs, rel, _ = corr._fine_anchor_flags(local, starts)
    dev = coords.device
    total = 0
    for lvl, vol in enumerate(local.volumes):
        nb, wh, ww, bq = vol.shape
        ys = (rcs[:, lvl, 0:1] + rel[lvl, 0]).long().clamp(0, wh - k - 1)
        xs = (rcs[:, lvl, 1:2] + rel[lvl, 1]).long().clamp(0, ww - k - 1)
        d = torch.arange(k + 1, device=dev)
        row = (torch.arange(nb, device=dev)[:, None] * (bq // 16)
               + torch.arange(bq, device=dev)[None] // 16)     # (nb, bq)
        y = ys[..., None, None] + d[:, None]
        x = xs[..., None, None] + d[None, :]
        ids = (row[..., None, None] * wh + y) * ww + x
        total += torch.unique(ids).numel() * 16 * vol.element_size()
    return total


def check_coord_lookups(kernels, corr, dev):
    """Kernels D and E from coordinates (the main path's lookup) against
    their plain versions, bf16 and float32, at the 720p layout (volume from
    kernel C), at the window step's (24 x 43 cells, 4 levels, margin 16),
    at the 1080p shared-flow path's (135 x 240 cells: 255 blocks, the last
    block row half padding) and at a layout of 3 levels and margin 8, the
    last three of whose grids cut the blocks on both axes:
    data and flags equal, E rewriting exactly the flagged blocks; then one
    guarded lookup traced: two kernel launches. Returns the worst error of
    D and of E."""
    from torch.profiler import ProfilerActivity, profile

    k = 9
    errs = {"D": 0.0, "E": 0.0}
    for (H1, W1, L, margin) in ((H_IMG // 8, W_IMG // 8, 4, 16),
                                (*WINDOW_GRIDS[0], 4, 16),
                                (*MULTI_GRID, 4, 16),
                                (37, 83, 3, 8)):
        g = torch.Generator(device=dev).manual_seed(12)
        f1 = torch.randn(1, H1, W1, 256, device=dev, generator=g)
        f2 = torch.randn(1, H1, W1, 256, device=dev, generator=g)
        grid = torch.stack(torch.meshgrid(
            torch.arange(W1, device=dev, dtype=torch.float32),
            torch.arange(H1, device=dev, dtype=torch.float32),
            indexing="xy"), -1)[None]
        fields = {"smooth": grid + torch.tensor([2.3, -3.1], device=dev),
                  "violating": grid + (torch.rand(grid.shape, device=dev,
                                                  generator=g) - 0.5) * 30,
                  "saturated": grid + torch.tensor([40.0, -35.0],
                                                   device=dev)}
        if H1 == H_IMG // 8:
            fields = {kind: _local_coords(dev, kind)
                      for kind in ("smooth", "violating")}
        for dtype in (torch.bfloat16, torch.float32):
            local = corr.build_local_corr(
                f1, f2, 4, L, margin,
                out_dtype=dtype if dtype == torch.bfloat16 else None)
            for kind, coords in fields.items():
                coords = coords.contiguous()
                got, bad = kernels.local_lookup_coords(
                    coords, local.volumes, local.consts["table"], k, dtype)
                want, bad_p = corr.block_local_lookup_coords_plain(
                    local, coords, k, dtype)
                torch.cuda.synchronize()
                e = (got.float() - want.float()).abs().max().item()
                errs["D"] = max(errs["D"], e)
                if not torch.equal(bad, bad_p):
                    raise AssertionError(f"kernel D's flags differ ({kind})")
                out_k, out_p = got.clone(), got.clone()
                kernels.local_lookup_exact_coords(
                    coords, local.volumes, local.consts["table"], k, bad=bad,
                    out=out_k)
                corr.block_local_lookup_exact_coords_plain(
                    local, coords, k, bad=bad, out=out_p)
                torch.cuda.synchronize()
                e_e = (out_k.float() - out_p.float()).abs().max().item()
                errs["E"] = max(errs["E"], e_e)
                keep = ~bad.bool().any(1)
                kept = torch.equal(out_k[keep], got[keep])
                log(f"kernels D, E from coordinates [{H1}x{W1}, {L} levels, "
                    f"{str(dtype)[6:]}, {kind}]: D max_abs_err {e:.3g}, "
                    f"flags equal, {int((~keep).sum())} of {keep.numel()} "
                    f"blocks flagged; E max_abs_err {e_e:.3g}, other "
                    f"blocks' rows kept {kept}")
                if not kept:
                    raise AssertionError("kernel E wrote rows it was not "
                                         "flagged for")
    if max(errs.values()) > 0.0:
        raise AssertionError(f"kernels D, E from coordinates differ from "
                             f"their plain versions: {errs}")

    # one guarded lookup on the card: D then E, nothing else
    for fine, names in ((True, ["local_lookup_fine_kernel",
                                "local_lookup_exact_kernel"]),
                        (False, ["local_lookup_exact_kernel"])):
        corr.corr_lookup_local_blocked(local, coords, 4, fine=fine)
        torch.cuda.synchronize()
        # the trace may miss the first kernels of its window: two spins
        # lead, and are not counted
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda._sleep(1000)
            corr.corr_lookup_local_blocked(local, coords, 4, fine=fine)
            torch.cuda.synchronize()
        seen = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "spin" not in e.name]
        log(f"corr_lookup_local_blocked (fine={fine}) on the card: "
            f"{len(seen)} kernel launches: {[n[:40] for n in seen]}")
        if len(seen) != len(names) or not all(
                n in e for n, e in zip(names, seen)):
            raise AssertionError(f"the lookup launched {seen}, expected "
                                 f"{names}")
    return errs


def check_local_lookups(kernels, corr, dev):
    """Kernels D, E, F against their plain versions on a 720p bf16 volume
    (built by kernel C), on a smooth field and on one with violating
    blocks: D and E as the main path calls them (from coordinates) and from
    explicit operands (D's and E's own arguments in the JAX package), F (D
    for one level). Times D from coordinates beside its byte and sector
    bounds, its plain version and ``F.grid_sample`` x4, and E under the
    guard's flags."""
    coord_errs = check_coord_lookups(kernels, corr, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    H1, W1, D, k = H_IMG // 8, W_IMG // 8, 256, 9
    f1 = torch.randn(1, H1, W1, D, device=dev, generator=g)
    f2 = torch.randn(1, H1, W1, D, device=dev, generator=g)
    local = corr.build_local_corr(f1, f2, 4, 4, 16, out_dtype=torch.bfloat16)
    vols = local.volumes
    table = local.consts["table"]
    nb, bq, L = vols[0].shape[0], vols[0].shape[3], len(vols)
    od = torch.bfloat16
    errs = {"D": coord_errs["D"], "E": coord_errs["E"], "F": 0.0}
    fields = {}
    for kind in ("smooth", "violating"):
        coords = _local_coords(dev, kind)
        starts, frac = corr._local_level_coords(local, coords)
        rcs, rel, ok = corr._fine_anchor_starts(local, starts)
        n_bad = int((~ok).sum().item())
        n_full = int((~ok[:nb - local.meta["nbw"]]).sum().item())
        fields[kind] = (coords, starts, frac, rcs, rel, ok)
        # the last block row's padding queries always violate (see
        # _local_coords); the full blocks only on the violating field
        if (n_full > 0) != (kind == "violating"):
            raise AssertionError(f"{kind} field: {n_full} full blocks "
                                 f"violate")

        got = kernels.local_lookup_fine_multi(rcs, vols, rel, frac, k, od)
        want = corr.block_local_lookup_fine_multi_plain(rcs, vols, rel, frac,
                                                        k, od)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        errs["D"] = max(errs["D"], e)
        log(f"kernel D from explicit operands [{kind}, {n_bad} of {nb} "
            f"blocks violate]: max_abs_err {e:.3g} (tol {LOCAL_LOOKUP_TOL})")
        got_c, _ = kernels.local_lookup_coords(coords, vols, table, k, od)
        if not torch.equal(got_c, got):
            raise AssertionError("kernel D from coordinates differs from "
                                 "kernel D from its explicit operands")

        rc0 = rcs[:, 0].contiguous()
        got_f = kernels.local_lookup_fine(rc0, vols[0], rel[0], frac[0], k, od)
        want_f = corr.block_local_lookup_fine_plain(rc0, vols[0], rel[0],
                                                    frac[0], k, od)
        e = (got_f.float() - want_f.float()).abs().max().item()
        errs["F"] = max(errs["F"], e)
        log(f"kernel F [{kind}, level 0]: max_abs_err {e:.3g}")
        if not torch.equal(got_f, got[:, :k * k]):
            raise AssertionError("kernel F is not kernel D's level 0")

        # E from explicit starts: one level (its one-level call) and every
        # level in one launch
        got_e = corr.block_local_lookup(vols[0], starts[0], frac[0], k)
        want_e = corr.block_local_lookup_plain(vols[0], starts[0], frac[0], k)
        e = (got_e - want_e).abs().max().item()
        errs["E"] = max(errs["E"], e)
        log(f"kernel E from explicit starts [{kind}, level 0, all blocks]: "
            f"max_abs_err {e:.3g}")
        n0 = kernels.local_lookup_exact.launches
        got_e = kernels.local_lookup_exact(vols, starts, frac, k)
        want_e = corr.block_local_lookup_levels_plain(vols, starts, frac, k)
        e = (got_e - want_e).abs().max().item()
        errs["E"] = max(errs["E"], e)
        log(f"kernel E from explicit starts [{kind}, {L} levels in one "
            f"launch, all blocks]: max_abs_err {e:.3g}")
        # with the flag: flagged blocks rewritten in D's output, rest kept
        flag = (~ok).to(torch.uint8)
        flag[::17] = 1
        out_k, out_p = got.clone(), want.clone()
        kernels.local_lookup_exact(vols, starts, frac, k, flag=flag,
                                   out=out_k)
        corr.block_local_lookup_levels_plain(vols, starts, frac, k,
                                             flag=flag, out=out_p)
        torch.cuda.synchronize()
        if kernels.local_lookup_exact.launches != n0 + 2:
            raise AssertionError("kernel E took more than one launch a "
                                 "lookup")
        e = (out_k.float() - out_p.float()).abs().max().item()
        errs["E"] = max(errs["E"], e)
        kept = torch.equal(out_k[flag == 0], got[flag == 0])
        log(f"kernel E from explicit starts [{kind}, {L} levels, flag on "
            f"{int(flag.sum())} blocks]: max_abs_err {e:.3g}, other blocks' "
            f"rows kept {kept}")
        if not kept:
            raise AssertionError("kernel E wrote rows it was not flagged for")

        # the guarded lookup equals the exact one everywhere
        guarded = corr.corr_lookup_local_blocked(local, coords, 4).data
        exact = corr.corr_lookup_local_blocked(local, coords, 4,
                                               fine=False).data
        e = (guarded.float() - exact.to(od).float()).abs().max().item()
        log(f"guarded lookup (D then E under the flags) vs exact [{kind}]: "
            f"max_abs_err {e:.3g}")
        if e > LOCAL_LOOKUP_TOL:
            raise AssertionError("the guarded lookup is not exact")
    for name, e in errs.items():
        if not e <= LOCAL_LOOKUP_TOL:
            raise AssertionError(f"kernel {name} disagrees: {e}")

    coords, starts, frac, rcs, rel, ok = fields["smooth"]
    rows = _time_coord_lookups(kernels, corr, local, coords, "720p")
    rows["D"]["max_abs_err"] = errs["D"]
    rows["E"]["max_abs_err"] = errs["E"]
    explicit_ms = time_ms(lambda: kernels.local_lookup_fine_multi(
        rcs, vols, rel, frac, k, od))
    lookup_ms = time_ms(lambda: corr.corr_lookup_local_blocked(local, coords,
                                                               4))
    log(f"kernel D before the redesign {PARENT_LOCAL_FINE_MS:.4f} ms from "
        f"explicit operands, after some 20 launches of coordinate "
        f"arithmetic; now from explicit operands {explicit_ms:.4f} ms; the "
        f"whole guarded lookup (D and E, two launches): {lookup_ms:.4f} ms")
    sel = (~ok).to(torch.uint8)
    scratch = torch.empty_like(kernels.local_lookup_coords(
        coords, vols, table, k, od)[0])
    explicit_ms = time_ms(lambda: kernels.local_lookup_exact(
        vols, starts, frac, k, flag=sel, out=scratch))
    log(f"kernel E from explicit starts on the same blocks: "
        f"{explicit_ms:.4f} ms; before its redesign, in four launches, "
        f"{PARENT_LOCAL_EXACT_MS['flagged']:.4f} ms")

    vq0 = vols[0].permute(0, 3, 1, 2).reshape(nb * bq, 1,
                                               *vols[0].shape[1:3]).float()
    taps = (k + 1) ** 2
    esz = vols[0].element_size()
    n_q = nb * bq
    rc0 = rcs[:, 0].contiguous()
    ms = time_ms(lambda: kernels.local_lookup_fine(rc0, vols[0], rel[0],
                                                   frac[0], k, od))
    plain_ms = time_ms(lambda: corr.block_local_lookup_fine_plain(
        rc0, vols[0], rel[0], frac[0], k, od), iters=5, warmup=1)
    library_ms = time_ms(lambda: _grid_sample_lookup(vq0, starts[0],
                                                     frac[0], k),
                         iters=5, warmup=1)
    bnd, by = bound_ms(n_q * taps * esz + n_q * 2 * (4 + 4) + n_q * k * k * 2
                       + rc0.numel() * 4, n_q * k * (3 * (k + 1) + 3 * k))
    log(f"kernel F timing (1 level, smooth field): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, F.grid_sample on the query-major volume "
        f"{library_ms:.4f} ms, bound {bnd:.4f} ms ({by})")
    rows["F"] = dict(max_abs_err=errs["F"], ms=ms, plain_ms=plain_ms,
                     bound_ms=bnd, bound_by=by, library_ms=library_ms)
    return rows


def _time_coord_lookups(kernels, corr, local, coords, grid):
    """Times kernels D and E from coordinates, as a guarded lookup runs
    them, on ``local`` (bf16) at ``coords``: D over every block beside its
    byte and sector bounds, its plain version and ``F.grid_sample`` x L on
    the query-major volume; E on the blocks D flags (and with none flagged)
    beside its bound over the flagged blocks' work and ``F.grid_sample`` on
    those blocks' queries. Logs them; returns {"D": row, "E": row} without
    ``max_abs_err``."""
    k = 9
    vols, table = local.volumes, local.consts["table"]
    od = torch.bfloat16
    nb, bq, L = vols[0].shape[0], vols[0].shape[3], len(vols)
    H1, W1 = coords.shape[1:3]
    starts, frac = corr._local_level_coords(local, coords)
    esz = vols[0].element_size()
    n_q = nb * bq
    taps = (k + 1) ** 2                       # each query's own 10 x 10 patch
    out_bytes = n_q * k * k * 2               # per level, bf16
    flops = n_q * k * (3 * (k + 1) + 3 * k)   # per level: column and x blends
    vq = [v.permute(0, 3, 1, 2).reshape(n_q, 1, *v.shape[1:3]).float()
          for v in vols]
    lib = _grid_sample_lookup(vq[0], starts[0], frac[0], k).reshape(
        nb, bq, k * k).permute(0, 2, 1)
    lib_err = (lib - corr.block_local_lookup_plain(vols[0], starts[0],
                                                   frac[0], k)).abs().max()
    log(f"kernels D, E [{grid}]: F.grid_sample on level 0 vs plain: "
        f"max_abs_err {lib_err.item():.3g} (yardstick)")
    rows = {}
    # D from coordinates, the main path's form: it reads the coordinates
    # (8 bytes a pixel) and writes the flags; its yardstick samples the four
    # levels with F.grid_sample at the starts the plain version computes
    coord_bytes = H1 * W1 * 8 + nb * L
    ms = time_ms(lambda: kernels.local_lookup_coords(coords, vols, table, k,
                                                     od))
    plain_ms = time_ms(lambda: corr.block_local_lookup_coords_plain(
        local, coords, k, od), iters=5, warmup=1)
    library_ms = time_ms(lambda: [_grid_sample_lookup(vq[l], starts[l],
                                                      frac[l], k)
                                  for l in range(L)], iters=5, warmup=1)
    bnd, by = bound_ms(L * (n_q * taps * esz + out_bytes) + coord_bytes,
                       L * flops)
    sec = _row_sector_bytes(local, corr, coords, k)
    sec_ms, _ = bound_ms(sec + L * out_bytes + coord_bytes, 0)
    log(f"kernel D timing [{grid}, {nb} blocks, from coordinates, {L} "
        f"levels, smooth field]: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, F.grid_sample x{L} on the query-major volume {library_ms:.4f} "
        f"ms, bound {bnd:.4f} ms ({by}); the query rows' patches in 32-byte "
        f"sectors {sec / 1e6:.2f} MB, sector bound {sec_ms:.4f} ms with the "
        f"output and the coordinates")
    rows["D"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                     library_ms=library_ms, sector_bound_ms=sec_ms)

    # E as the guard runs it: one launch a lookup, every level, from the
    # coordinates into D's output, on the blocks the field flags and with
    # no block flagged. The bound counts the flagged blocks' work only.
    scratch, bad = kernels.local_lookup_coords(coords, vols, table, k, od)
    none = torch.zeros_like(bad)
    sel = bad.bool().any(1)
    nf = int(sel.sum().item())
    vq_f = [v[sel].permute(0, 3, 1, 2).reshape(nf * bq, 1, *v.shape[1:3])
            .float() for v in vols]
    s_f, fr_f = starts[:, :, sel].contiguous(), frac[:, :, sel].contiguous()
    scratch_p = scratch.clone()
    ms = time_ms(lambda: kernels.local_lookup_exact_coords(
        coords, vols, table, k, bad=bad, out=scratch))
    ms_none = time_ms(lambda: kernels.local_lookup_exact_coords(
        coords, vols, table, k, bad=none, out=scratch))
    plain_ms = time_ms(lambda: corr.block_local_lookup_exact_coords_plain(
        local, coords, k, bad=bad, out=scratch_p), iters=5, warmup=1)
    library_ms = time_ms(lambda: [_grid_sample_lookup(vq_f[l], s_f[l],
                                                      fr_f[l], k)
                                  for l in range(L)], iters=5, warmup=1)
    n_qf = nf * bq
    bnd, by = bound_ms(L * n_qf * (taps * esz + k * k * 2) + nf * 128 * 8
                       + nb * L, L * n_qf * k * (3 * (k + 1) + 3 * k))
    log(f"kernel E timing [{grid}, from coordinates, one lookup, {L} levels "
        f"in one launch, the {nf} flagged of {nb} blocks]: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, F.grid_sample x{L} on the "
        f"flagged blocks' queries {library_ms:.4f} ms, bound {bnd:.4f} ms "
        f"({by}, flagged blocks only); with no block flagged {ms_none:.4f} "
        f"ms")
    rows["E"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                     library_ms=library_ms, ms_none_flagged=ms_none)
    return rows


def update_case(dev):
    """The 720p loop shape (90 x 160 cells) of kernels G, H and I, with the
    update block's seeded weights: NCHW maps as the unfused path holds them
    (``net``, ``motion``, ``cor1``, ``flo1``, ``flow``), the block ``ub``,
    G's per-direction operands ``gru`` (``fused``: for the kernel, ending in
    the axis; ``unfused``: the unfused path's), channels-minor ``h`` and
    ``x``, and I's taps ``head``."""
    from woft_tpu_torch.models import layers, update
    from woft_tpu_torch.models import raft as traft

    H1, W1 = H_IMG // 8, W_IMG // 8
    cfg = traft.RaftConfig(precision="bf16")
    ub = traft.init_raft_params(cfg, seed=0, device=dev).update_block
    g = torch.Generator(device=dev).manual_seed(11)

    def randn(c):
        return torch.randn(1, c, H1, W1, device=dev, generator=g)

    net = torch.tanh(randn(128))
    inp = torch.relu(randn(128))
    case = dict(net=net, motion=torch.relu(randn(128)).bfloat16(),
                cor1=torch.relu(randn(256)).bfloat16(),
                flo1=torch.relu(randn(128)).bfloat16(), flow=3.0 * randn(2),
                ub=ub)
    with layers.precision_scope("bf16"), torch.no_grad():
        case["fused"] = traft.precompute_gru_context(ub.gru, inp, 128,
                                                     fused=True)
        case["unfused"] = traft.precompute_gru_context(ub.gru, inp, 128)
    case["h"], case["x"] = update.nhwc(net), update.nhwc(case["motion"])
    case["head"] = update.flow_head_params(ub.flow_head)
    return case


def check_update_kernels(kernels, dev):
    """Kernels G (both directions), H and I against their plain versions at
    the 720p loop shape (90 x 160 cells), with the update block's seeded
    weights. The yardstick of each is the port's own unfused path for the
    same function: several cuDNN and elementwise calls, not one. Each is
    also printed beside its time before the redesign."""
    from woft_tpu_torch.models import layers, update
    from woft_tpu_torch.models import raft as traft

    case = update_case(dev)
    px = (H_IMG // 8) * (W_IMG // 8)
    net, motion, ub = case["net"], case["motion"], case["ub"]
    cor1, flo1, flow = case["cor1"], case["flo1"], case["flow"]
    rows = {}

    def n_bytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def report(name, diff, allowed, kernel_fn, plain_fn, unfused_fn, bnd, by,
               label, max_share=UPDATE_DIFF_SHARE, parent_ms=None):
        torch.cuda.synchronize()
        share = (diff > 0).float().mean().item()
        worst = (diff / allowed).max().item()
        log(f"kernel {name}: max_abs_err {diff.max().item():.3g}, entries "
            f"that differ {100 * share:.3f} % (tol {100 * max_share:g} %), "
            f"largest difference {worst:.3g} of the tolerance")
        if not (worst <= 1.0 and share <= max_share):
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"version")
        with layers.precision_scope("bf16"), torch.no_grad():
            ms = time_ms(kernel_fn)
            plain_ms = time_ms(plain_fn, iters=5, warmup=1)
            unfused_ms = time_ms(unfused_fn)
        before = ("" if parent_ms is None else
                  f" (before the redesign {parent_ms:.4f} ms)")
        log(f"kernel {name} timing: kernel {ms:.4f} ms{before}, plain "
            f"{plain_ms:.4f} ms, {label} {unfused_ms:.4f} ms, bound "
            f"{bnd:.4f} ms ({by})")
        # no single PyTorch call computes these functions: library_ms is
        # null, and the unfused chain is reported beside it
        return dict(max_abs_err=diff.max().item(), ms=ms, plain_ms=plain_ms,
                    bound_ms=bnd, bound_by=by, library_ms=None,
                    unfused_ms=unfused_ms, unfused_is=label)

    fused, unfused = case["fused"], case["unfused"]
    h, x = case["h"], case["x"]
    # G, one launch: 5 taps x 256 channels into z|r (256) and q (128)
    g_flops = 2 * px * 5 * 256 * (256 + 128)
    per_dir = []
    for d, args in enumerate(fused):
        axis = args[-1]
        got = kernels.fused_gru_update(h, x, *args)
        want = update.gru_update_plain(h, x, *args)
        allowed = GRU_TOL_ULPS * BF16_ULP * h.abs().clamp(min=1.0)
        bnd, by = bound_ms(n_bytes(h, x, *args[:-1]) + n_bytes(got), g_flops,
                           BF16_FLOPS)
        per_dir.append(report(
            f"G [{axis}]", (got - want).abs(), allowed,
            lambda: kernels.fused_gru_update(h, x, *args),
            lambda: update.gru_update_plain(h, x, *args),
            lambda: traft._sep_conv_gru(net, motion, unfused[d:d + 1]),
            bnd, by, "one unfused _sep_conv_gru direction (~20 calls)",
            parent_ms=PARENT_GRU_MS[axis]))
    # the main path launches each direction once an iteration: one row with
    # the mean of the two
    rows["G"] = dict(per_dir[0],
                     max_abs_err=max(r["max_abs_err"] for r in per_dir))
    for key in ("ms", "plain_ms", "unfused_ms", "bound_ms"):
        rows["G"][key] = sum(r[key] for r in per_dir) / len(per_dir)

    enc = ub.encoder
    me = update.motion_encoder_params(enc)
    c1, f1, fl = update.nhwc(cor1), update.nhwc(flo1), update.nhwc(flow)
    got = kernels.motion_encoder_tail(c1, f1, fl, *me)
    want = update.motion_encoder_tail_plain(c1, f1, fl, *me)
    if not torch.equal(got[..., 126:], fl.bfloat16()):
        raise AssertionError("kernel H: lanes 126-127 are not bf16(flow)")
    wf = want.float()
    allowed = BF16_ULP * (TAIL_TOL_ULPS * wf.abs() + wf.abs().max())

    def tail_unfused():
        sd = torch.bfloat16
        cor = F.relu(layers.conv(enc.convc2, cor1, sd))
        flo = F.relu(layers.conv(enc.convf2, flo1, sd))
        out = F.relu(layers.conv(enc.conv, torch.cat([cor, flo], 1), sd))
        return torch.cat([out, flow.to(sd)], 1)

    bnd, by = bound_ms(
        n_bytes(c1, f1, fl, *me) + n_bytes(got),
        2 * px * 9 * (256 * 192 + 128 * 64 + 256 * 126), BF16_FLOPS)
    rows["H"] = report(
        "H", (got.float() - wf).abs(), allowed,
        lambda: kernels.motion_encoder_tail(c1, f1, fl, *me),
        lambda: update.motion_encoder_tail_plain(c1, f1, fl, *me),
        tail_unfused, bnd, by, "the three unfused tail convolutions and "
        "the cat (~12 calls)", parent_ms=PARENT_TAIL_MS)

    fh = case["head"]
    got = kernels.flow_head(h, *fh)
    want = update.flow_head_plain(h, *fh)
    allowed = (HEAD_TOL_ULPS * BF16_ULP * want.abs().max()).expand_as(want)
    bnd, by = bound_ms(n_bytes(h, *fh) + n_bytes(got),
                       2 * px * 9 * (128 * 256 + 256 * 2), BF16_FLOPS)
    rows["I"] = report(
        "I", (got - want).abs(), allowed,
        lambda: kernels.flow_head(h, *fh),
        lambda: update.flow_head_plain(h, *fh),
        lambda: ub.flow_head(net), bnd, by, "the unfused FlowHead (~9 calls)",
        max_share=1.0,      # unrounded float32 sums in another order: most
        parent_ms=PARENT_HEAD_MS)  # entries differ, in their last bits
    return rows


COUNTED = ("warp_perspective_bilinear", "corr_pyramid_lookup",
           "local_corr_build", "local_lookup_coords",
           "local_lookup_exact_coords", "local_lookup_fine_multi",
           "local_lookup_exact", "local_lookup_fine", "fused_gru_update",
           "motion_encoder_tail", "flow_head")
FUSED_FLAGS = {"gru_fused": True, "tail_fused": True}


def walk(h, w, dev, seed=2, n=8):
    """The homography walk every track follows: a textured (h, w) template
    and ``n`` frames, frame t the template warped by the t-th pose about
    the frame's centre (small rotation, scale, translation and a
    perspective row), rendered with the plain warp on ``dev``. Returns
    (template, frames) as BGR uint8 numpy and the poses (template ->
    frame, float64)."""
    from woft_tpu_torch.ops.warp import warp_perspective

    template = textured_frame(h, w, seed=seed)
    tmpl_dev = torch.from_numpy(template).to(dev).to(torch.float32)[None]
    frames, poses = [], []
    for t in range(1, n + 1):
        H = pose(0.004 * t, 1 + 0.004 * t, 2.0 * t, -1.5 * t,
                 (2e-7 * t, -1e-7 * t), center=(w / 2, h / 2))
        f = warp_perspective(tmpl_dev, H.to(dev))[0].round().clamp(0, 255)
        frames.append(f.to(torch.uint8).cpu().numpy())
        poses.append(H.double().numpy())
    return template, frames, poses


def centred_mask(h, w, frac):
    """(h, w) bool mask of the centred box of ``frac`` of each side, and
    its corners (2, 4) as the tracker's box has them (inclusive)."""
    mask = np.zeros((h, w), bool)
    y0, y1 = int(h * (1 - frac) / 2), int(h * (1 + frac) / 2)
    x0, x1 = int(w * (1 - frac) / 2), int(w * (1 + frac) / 2)
    mask[y0:y1, x0:x1] = True
    corners = np.array([[x0, x1 - 1, x1 - 1, x0], [y0, y0, y1 - 1, y1 - 1]],
                       np.float64)
    return mask, corners


def corner_errors(hs, poses, corners):
    """Per frame: the largest distance (template pixels) between a target
    corner and its image under the pose, mapped back by the tracker's
    current -> template H."""
    def proj(H, pts):
        p = H @ np.vstack([pts, np.ones(pts.shape[1])])
        return p[:2] / p[2:]

    return [float(np.linalg.norm(proj(np.asarray(H, np.float64),
                                      proj(P, corners)) - corners,
                                 axis=0).max())
            for H, P in zip(hs, poses)]


def zero_counts(kernels):
    for name in COUNTED:
        getattr(kernels, name).launches = 0


def read_counts(kernels):
    return {name: getattr(kernels, name).launches for name in COUNTED}


def check_counts(what, launches, want, exact=(), n_frames=0, n_flows=0):
    """``want``: launches expected of each counted wrapper (others 0); at
    least that many, or exactly for the names in ``exact``."""
    want = {**dict.fromkeys(COUNTED, 0), **want}
    for name, n in want.items():
        if (launches[name] < n or (n == 0 and launches[name])
                or (name in exact and launches[name] != n)):
            least = "at least " if n and name not in exact else ""
            raise AssertionError(f"{what}: {name} launched {launches[name]} "
                                 f"times, expected {least}{n} ({n_frames} "
                                 f"frames, {n_flows} flows)")


def track_720p(kernels, dev, config, fused=False):
    """A main path: ``WOFTTracker`` at 1280x720 through ``configs/<config>``
    (``WOFT.py``: dense pyramid, float32; ``WOFT_fast.py``: block-local
    volume, bf16; ``fused``: with the fused refinement loop, kernels G and
    I), on the trained full-frame weights the configs load. Returns the
    launch counts of the run and its steady frame times."""
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.tracker import TrackerParams, WOFTTracker

    template, frames, poses = walk(H_IMG, W_IMG, dev)
    mask, corners = centred_mask(H_IMG, W_IMG, 0.5)
    conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                    config))
    fast = conf.flow_config.corr_impl == "local"
    flags = FUSED_FLAGS if fused else None
    log(f"--- {config}: corr_impl {conf.flow_config.corr_impl or 'dense'}, "
        f"precision {conf.flow_config.precision}, raft_flags {flags}, "
        f"weights {os.path.relpath(str(conf.flow_config.model), ROOT)}")
    tracker = WOFTTracker(conf, raft_flags=flags)
    torch.cuda.synchronize()

    zero_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    n_flows = 0
    t0 = time.perf_counter()
    tracker.init(template, mask)
    torch.cuda.synchronize()
    log(f"tracker init: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    hs, frame_ms, fallbacks = [], [], 0
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        H, meta = tracker.track(f)
        ms = (time.perf_counter() - t0) * 1e3
        fell_back = not meta.global_H_success
        fallbacks += fell_back
        n_flows += 1 + fell_back
        hs.append(H)
        frame_ms.append(ms)
        log(f"frame {i + 1}: {ms:.1f} ms, check passed {meta.global_H_success}"
            f", inlier_frac {float(meta.inlier_frac):.3f}, fallback "
            f"{fell_back}")
    # the local-flow fallback with the lost-counter ladder on every frame
    conf.tracker_params = TrackerParams(redetection="never",
                                        no_prewarp_after_n=1)
    never = WOFTTracker(conf, raft_flags=flags)
    never.init(template, mask)
    for i, f in enumerate(frames[:3]):
        t0 = time.perf_counter()
        H, meta = never.track(f)
        ms = (time.perf_counter() - t0) * 1e3
        n_flows += 2
        hs.append(H)
        log(f"fallback frame {i + 1}: {ms:.1f} ms, N_lost {meta.N_lost}")
    torch.cuda.synchronize()
    launches = read_counts(kernels)
    n_frames = len(frames) + 3
    steady = frame_ms[1:]
    errs = corner_errors(hs, poses + poses[:3], corners)
    log(f"{config}: first frame {frame_ms[0]:.1f} ms, steady frames "
        f"{min(steady):.1f}-{max(steady):.1f} ms (mean "
        f"{sum(steady) / len(steady):.1f}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches} over {n_frames} frames and {n_flows} flows")
    log(f"{config}: fallback rate {fallbacks}/{len(frames)}; corner error "
        f"against the walk (px) "
        f"{', '.join(f'{e:.3f}' for e in errs[:len(frames)])}; on the "
        f"fallback frames {', '.join(f'{e:.3f}' for e in errs[len(frames):])}")
    if not all(np.isfinite(h).all() for h in hs):
        raise AssertionError("non-finite homography")
    # per flow: 12 iterations and one more lookup for the weight head; the
    # block-local path builds its 4 levels in one launch of C, and each
    # lookup is one launch of D and one of E (every level, the guard), both
    # from the coordinates; the explicit-operand forms stay idle; the fused
    # loop launches G once a direction and I once, every iteration
    want = {"warp_perspective_bilinear": n_frames}
    if fast:
        want.update(local_corr_build=n_flows,
                    local_lookup_coords=13 * n_flows,
                    local_lookup_exact_coords=13 * n_flows)
    else:
        want.update(corr_pyramid_lookup=13 * n_flows)
    if fused:
        want.update(fused_gru_update=2 * 12 * n_flows, flow_head=12 * n_flows)
    # C, D and E: exactly one launch a flow and a lookup
    exact = (("local_corr_build", "local_lookup_coords",
              "local_lookup_exact_coords") if fast else ())
    check_counts(config, launches, want, exact, n_frames, n_flows)
    return launches, steady


# The window tracks' bounds on the corner error against the walk (template
# pixels, the largest over the 8 frames of the walk, then over the 3
# fallback frames): the CPU path's own largest errors on the same walk
# (tools/torch_window_walks.py runs these tracks on the CPU), plus
# headroom for the card's other summation orders (about half the CPU's
# error on the walk, an eighth on the float32 fallback frames). The
# fallback's first frame flows from the template window to a search window
# whose box carries the margins twice (the reference's window shell and
# step do the same), 1.5x the scale of the template's, and the later
# fallback frames chain onto it: hence errors of 11-22 px there in the
# fixed-area modes and about 1 px at native scale, where both boxes have
# one source size. That flow is ill-conditioned: in float32 the card
# matches the CPU to 0.001 px, but in bf16 the order of the roundings moves
# it by pixels (12.264 px on one CPU, 11.704 on another, 14.103 on the
# card; tools/torch_window_walks.py --precisions). The bf16 step's
# fallback bound, a quarter of the CPU's error as headroom, was set after
# the card read 14.103 px: like the other fallback bounds it is a sanity
# check only. check_window_step_card_vs_cpu holds that step tightly.
WINDOW_CORNER_BOUND_PX = {
    # (what, frame): (walk: CPU 8 frames -> bound, fallback: CPU -> bound)
    ("WOFT_window.py", "1280x720"): (1.5, 25.0),          # 0.886, 22.233
    ("WOFT_window.py", "1920x1080"): (1.5, 13.0),         # 0.931, 11.251
    ("WOFT_window_native.py", "1280x720"): (1.0, 2.0),    # 0.550, 1.189
    ("window_step", "1920x1080"): (1.5, 15.5),            # 0.930, 12.264
}


# The ablation tracks' bounds on the corner error against the walk (full-
# resolution pixels after the downscale compensation, the largest over the
# 8 frames of the walk, then over the 3 fallback frames): the CPU path's
# own largest errors on the same walk (tools/torch_downscale_walks.py runs
# these tracks on the CPU, 8 threads) plus headroom for the card's other
# summation orders, about half again on the walk and a third or more on
# the fallback frames. Sanity bounds: the downscaled frames carry a quarter
# to a sixteenth of the pixels, and a pixel of theirs is s full ones.
ABLATION_CORNER_BOUND_PX = {
    # (label, frame): (walk: CPU 8 frames -> bound, fallback: CPU -> bound)
    ("WOFT_downscale_3x.py", "1280x720"): (1.5, 2.0),     # 0.896, 1.481
    ("WOFT_downscale_3x.py", "1920x1080"): (1.2, 2.0),    # 0.720, 1.392
    ("WOFT_downscale_2x.py", "1920x1080"): (1.0, 2.0),    # 0.570, 1.457
    ("WOFT_downscale_4x.py", "1280x720"): (1.5, 2.0),     # 1.020, 1.348
    ("WOFT_wIRLSq.py", "1280x720"): (0.5, 0.6),           # 0.255, 0.403
    ("WOFT.py dense head", "1280x720"): (0.5, 0.6),       # 0.255, 0.403
    ("WOFT_cvransac.py", "1280x720"): (0.5, 0.6),         # 0.277, 0.419
    ("WOFT_trs.py", "1280x720"): (0.7, 0.6),              # 0.406, 0.345
}
# the dense weight head against the sparse one on the same frames: the
# logits are the same per cell, the upsample and the head run through
# other convolution calls (other cuDNN algorithms, other sums)
DENSE_HEAD_TOL_PX = 1e-3


def window_runner(dev, what, template, frames, mask, cfg=None):
    """``runner(tp=None) -> (track, (Sh, Sw))`` for one window path on
    ``dev``: ``track(i) -> (H_cur2init float64, check passed)`` tracks
    ``frames[i]`` after an init on ``template`` and ``mask``, under
    TrackerParams ``tp`` (by default the path's own: its config's, or the
    defaults for the step).
    ``what``: a config of ``woft_tpu_torch/configs``
    (``WOFTWindowTracker``, upload and crop included), or
    ``"window_step"``: ``build_window_track_step`` with ``bench.py``'s
    settings (block-local correlation, bf16, 12 iterations, the
    aspect-matched 256 window of ``window_params_for_mask``, frames staged
    on the device as float32 RGB; ``cfg``, a ``RaftConfig``, replaces
    those settings); both on the trained window-mode weights
    (``weights/wraft_tpu_v5_torch.pt``)."""
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow import RaftFlow
    from woft_tpu_torch.models.raft import RaftConfig
    from woft_tpu_torch.tracker import (TrackerParams, WOFTWindowTracker,
                                        build_window_track_step,
                                        window_init_state,
                                        window_params_for_mask)

    conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                    "WOFT_window.py" if what == "window_step"
                                    else what))
    if what != "window_step":
        canonical = conf.tracker_params

        def runner(tp=None):
            conf.tracker_params = tp or canonical
            tracker = WOFTWindowTracker(conf, device=dev)
            tracker.init(template, mask)

            def track(i):
                H, meta = tracker.track(frames[i])
                return H, bool(meta.global_H_success)
            return track, tracker.win_hw
        return runner

    cfg = cfg or RaftConfig(corr_impl="local", precision="bf16", iters=12)
    model = RaftFlow(conf.flow_config, device=dev).model
    wp = window_params_for_mask(mask, size=256)

    def rgb(bgr):
        return torch.from_numpy(np.ascontiguousarray(
            bgr[..., ::-1])).to(dev).to(torch.float32)[None]

    staged = [rgb(f) for f in frames]

    def runner(tp=None):
        tp = tp or TrackerParams()
        step = build_window_track_step(cfg, tp, wp)
        state = window_init_state(model, cfg, tp, wp, rgb(template), mask)

        def track(i):
            nonlocal state
            state, H, meta = step(model, state, staged[i])
            return (H.cpu().numpy().astype(np.float64),
                    meta["global_H_success"])
        return track, wp.shape
    return runner


def window_walk(dev, what, h, w, kernels=None):
    """One window track (``window_runner``) on ``dev``: 8 frames of the
    walk at h x w under the config's tracker parameters (the canonical ones
    for the step), then 3 with ``redetection='never'`` (the local-flow
    fallback on every frame, the pre-warp reset after one lost frame); the
    target is the centred third of each side (``bench.py``'s mask).
    Returns a dict of the track's numbers; ``kernels``' counters are zeroed
    first and read after."""
    from woft_tpu_torch.tracker import TrackerParams

    template, frames, poses = walk(h, w, dev)
    mask, corners = centred_mask(h, w, 1 / 3)
    runner = window_runner(dev, what, template, frames, mask)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    if kernels is not None:
        zero_counts(kernels)
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    track, shape = runner()
    sync()
    init_ms = (time.perf_counter() - t0) * 1e3
    hs, frame_ms, fallbacks, n_flows = [], [], 0, 0
    for i in range(len(frames)):
        t0 = time.perf_counter()
        H, ok = track(i)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        fallbacks += not ok
        n_flows += 2 - ok
        hs.append(H)
    track, _ = runner(TrackerParams(redetection="never",
                                    no_prewarp_after_n=1))
    for i in range(3):
        H, _ = track(i)
        n_flows += 2
        hs.append(H)
    sync()
    n_frames = len(frames) + 3
    errs = corner_errors(hs, poses + poses[:3], corners)
    res = dict(what=what, frame=f"{w}x{h}", window=shape, init_ms=init_ms,
               frame_ms=frame_ms, fallbacks=fallbacks, n_frames=n_frames,
               n_flows=n_flows, n_inits=2, errs=errs, hs=hs)
    if kernels is not None:
        res["launches"] = read_counts(kernels)
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def report_window_walk(res):
    steady = res["frame_ms"][1:]
    n = len(res["frame_ms"])
    log(f"{res['what']} at {res['frame']}: window {res['window'][0]}x"
        f"{res['window'][1]}; init {res['init_ms']:.1f} ms; first frame "
        f"{res['frame_ms'][0]:.1f} ms, steady frames {min(steady):.1f}-"
        f"{max(steady):.1f} ms (mean {sum(steady) / len(steady):.1f}); "
        f"fallback rate {res['fallbacks']}/{n}; corner error against the "
        f"walk (px) {', '.join(f'{e:.3f}' for e in res['errs'][:n])}; on "
        f"the fallback frames "
        f"{', '.join(f'{e:.3f}' for e in res['errs'][n:])}")
    if "launches" in res:
        per_frame = {k: round(v / res["n_frames"], 2)
                     for k, v in res["launches"].items() if v}
        log(f"{res['what']} at {res['frame']}: peak device memory "
            f"{res['peak_gib']:.2f} GiB; launches {res['launches']} over "
            f"{res['n_frames']} frames, {res['n_flows']} flows and "
            f"{res['n_inits']} inits; per frame {per_frame}")


def track_window(kernels, dev, what, h, w):
    """A window path on the card (``window_walk``), its launches held to
    the path's kernels: A twice a frame (the crop and the pre-warp) and
    once an init (the template crop); the dense configs B 13 times a flow;
    the block-local step C once, D and E 13 times a flow; nothing else.
    Its corner error against the walk is held to the CPU path's bound."""
    res = window_walk(dev, what, h, w, kernels)
    report_window_walk(res)
    if not all(np.isfinite(H).all() for H in res["hs"]):
        raise AssertionError("non-finite homography")
    n_frames, n_flows = res["n_frames"], res["n_flows"]
    want = {"warp_perspective_bilinear": 2 * n_frames + res["n_inits"]}
    exact = ["warp_perspective_bilinear"]
    if what == "window_step":
        want.update(local_corr_build=n_flows,
                    local_lookup_coords=13 * n_flows,
                    local_lookup_exact_coords=13 * n_flows)
        exact += ["local_corr_build", "local_lookup_coords",
                  "local_lookup_exact_coords"]
    else:
        want.update(corr_pyramid_lookup=13 * n_flows)
        exact += ["corr_pyramid_lookup"]
    check_counts(f"{what} at {res['frame']}", res["launches"], want, exact,
                 n_frames, n_flows)
    n = len(res["frame_ms"])
    for errs, bound, which in zip(
            (res["errs"][:n], res["errs"][n:]),
            WINDOW_CORNER_BOUND_PX[(what, res["frame"])],
            ("the walk", "the fallback frames")):
        if not (np.isfinite(errs).all() and max(errs) <= bound):
            raise AssertionError(f"{what} at {res['frame']}: corner error "
                                 f"{max(errs):.3f} px on {which}, bound "
                                 f"{bound} px")
    return res


WINDOW_TRACKS = (("WOFT_window.py", 720, 1280),
                 ("WOFT_window.py", 1080, 1920),
                 ("WOFT_window_native.py", 720, 1280),
                 ("window_step", 1080, 1920))


# The ablation tracks: (config, frame h, w, TrackerParams overrides). The
# downscale configs resize the walk on the card (1280x720 / 3 = 427x240,
# not /8: padded 432x240, a 54x30 grid; 1920x1080 / 3 = 640x360, 80x45;
# 1920x1080 / 2 = 960x540, padded 960x544, 120x68; 1280x720 / 4 = 320x180,
# padded 320x184, 40x23), replicate-padded, the dense weight head
ABLATION_TRACKS = (("WOFT_downscale_3x.py", 720, 1280, {}),
                   ("WOFT_downscale_3x.py", 1080, 1920, {}),
                   ("WOFT_downscale_2x.py", 1080, 1920, {}),
                   ("WOFT_downscale_4x.py", 720, 1280, {}),
                   ("WOFT_wIRLSq.py", 720, 1280, {}),
                   ("WOFT.py", 720, 1280, {"sparse_weights": False}))
# the host fits' tracks (OpenCV RANSAC, the similarity fit): run where cv2
# can be imported
HOST_FIT_TRACKS = (("WOFT_cvransac.py", 720, 1280, {}),
                   ("WOFT_trs.py", 720, 1280, {}))
# (H1, W1) of the downscale paths' padded grids, as kernel B sees them
DOWNSCALE_GRIDS = {"54x30 (3x of 1280x720)": (30, 54),
                   "80x45 (3x of 1920x1080)": (45, 80),
                   "120x68 (2x of 1920x1080)": (68, 120),
                   "40x23 (4x of 1280x720)": (23, 40)}


def ablation_label(config, overrides, flow=None):
    label = config + (" dense head" if overrides.get("sparse_weights")
                      is False else "")
    return label + "".join(f" {k}={v}" for k, v in (flow or {}).items())


def ablation_walk(dev, config, h, w, overrides=None, kernels=None,
                  flow=None, n_frames=8, n_fallback=3, profile=False):
    """One full-frame track through ``WOFTTracker`` under
    ``configs/<config>`` (its tracker parameters with ``overrides``, its
    flow config with ``flow``: ``alternate_corr`` goes to its class
    parameters), on ``dev``, on the weights the config loads: ``n_frames``
    frames of the walk at h x w, then ``n_fallback`` with
    ``redetection='never'`` and the pre-warp reset after one lost frame
    (the local fallback on every frame), the target half of each side
    (``track_720p``'s). Returns a dict of the track's numbers;
    ``kernels``' counters are zeroed first and read after; ``profile``:
    then one more frame traced (device busy ms, launches)."""
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.tracker import WOFTTracker

    overrides = overrides or {}
    template, frames, poses = walk(h, w, dev, n=n_frames)
    mask, corners = centred_mask(h, w, 0.5)
    conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                    config))
    conf.tracker_params = replace(conf.tracker_params, **overrides)
    for k, v in (flow or {}).items():
        setattr(conf.flow_config.class_params if k == "alternate_corr"
                else conf.flow_config, k, v)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    tracker = WOFTTracker(conf, device=dev)
    sync()
    if kernels is not None:
        zero_counts(kernels)
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tracker.init(template, mask)
    sync()
    init_ms = (time.perf_counter() - t0) * 1e3
    hs, frame_ms, fallbacks, n_flows = [], [], 0, 0
    for f in frames:
        t0 = time.perf_counter()
        H, meta = tracker.track(f)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        fallbacks += not meta.global_H_success
        n_flows += 2 - bool(meta.global_H_success)
        hs.append(H)
    if n_fallback:
        conf.tracker_params = replace(tracker.tp, redetection="never",
                                      no_prewarp_after_n=1)
        never = WOFTTracker(conf, device=dev)
        never.init(template, mask)
        for f in frames[:n_fallback]:
            H, _ = never.track(f)
            n_flows += 2
            hs.append(H)
        del never
    sync()
    label = ablation_label(config, overrides, flow)
    small = tracker.state.template_img.shape[1:3]
    res = dict(what=label, frame=f"{w}x{h}", tracked=f"{small[1]}x{small[0]}",
               padding=tracker.tp.padding_mode, init_ms=init_ms,
               frame_ms=frame_ms, fallbacks=fallbacks,
               n_frames=len(frames) + n_fallback, n_flows=n_flows, hs=hs,
               errs=corner_errors(hs, poses + poses[:n_fallback], corners),
               corners=corners)
    if kernels is not None:
        res["launches"] = read_counts(kernels)
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if profile:
        res["frame_launches"], res["busy_ms"] = profile_launches(
            lambda: tracker.track(frames[-1]))
    return res


def report_ablation_walk(res):
    steady = res["frame_ms"][1:] or res["frame_ms"]
    n = len(res["frame_ms"])
    log(f"{res['what']} at {res['frame']} (tracked at {res['tracked']}, "
        f"{res['padding']}): init {res['init_ms']:.1f} ms; first frame "
        f"{res['frame_ms'][0]:.1f} ms, steady frames {min(steady):.1f}-"
        f"{max(steady):.1f} ms (mean {sum(steady) / len(steady):.1f}); "
        f"fallback rate {res['fallbacks']}/{n}; corner error against the "
        f"walk (full-resolution px) "
        f"{', '.join(f'{e:.3f}' for e in res['errs'][:n])}; on the "
        f"fallback frames {', '.join(f'{e:.3f}' for e in res['errs'][n:])}")
    if "launches" in res:
        per_frame = {k: round(v / res["n_frames"], 2)
                     for k, v in res["launches"].items() if v}
        log(f"{res['what']} at {res['frame']}: peak device memory "
            f"{res['peak_gib']:.2f} GiB; launches {res['launches']} over "
            f"{res['n_frames']} frames and {res['n_flows']} flows; per "
            f"frame {per_frame}")
    if "busy_ms" in res:
        mean = sum(steady) / len(steady)
        log(f"{res['what']} at {res['frame']}: one more frame traced: "
            f"{res['frame_launches']} launches, device busy "
            f"{res['busy_ms']:.2f} ms, {100 * res['busy_ms'] / mean:.1f} % "
            f"of the steady frame")


def check_downscale_shapes(kernels, corr, warp, dev):
    """Kernels A and B at the shapes the downscale paths give them, against
    their plain versions and timed beside their bounds, plain versions and
    PyTorch calls: A pre-warping a 427x240 frame (3x of 720p, not /8: the
    tracker pre-warps the unpadded frame), B dense on the pyramids of the
    four padded grids (``DOWNSCALE_GRIDS``; levels of odd sizes such as 23,
    11, 5). Returns {shape: row}."""
    out = {}
    h, w = 240, 427
    src = torch.tensor(textured_frame(h, w, seed=6), dtype=torch.float32,
                       device=dev)[None]
    H = pose(0.004, 1.004, 0.7, -0.5, (6e-7, -3e-7),
             center=(w / 2, h / 2)).to(dev)
    hinv = warp.inverse_h(H[None])
    want = warp.warp_perspective(src, H)
    got = kernels.warp_perspective_bilinear(src, hinv, h, w)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    px = h * w
    bnd, by = bound_ms(2 * px * 3 * 4 + 36, px * (12 + 2 + 4 + 36))
    coords = warp.perspective_coords(H[None], (h, w))
    grid = torch.stack([2 * coords[..., 0] / (w - 1) - 1,
                        2 * coords[..., 1] / (h - 1) - 1], -1)
    src_nchw = src.permute(0, 3, 1, 2).contiguous()
    ms = time_ms(lambda: kernels.warp_perspective_bilinear(src, hinv, h, w))
    plain_ms = time_ms(lambda: warp.warp_perspective(src, H))
    library_ms = time_ms(lambda: F.grid_sample(
        src_nchw, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True))
    log(f"kernel A [pre-warp of a {w}x{h} frame]: max_abs_err {err:.3g} "
        f"(tol {WARP_TOL}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"F.grid_sample {library_ms:.4f} ms, bound {bnd:.4f} ms ({by})")
    if not err <= WARP_TOL:
        raise AssertionError(f"kernel A disagrees at {w}x{h}: {err}")
    out[f"A {w}x{h}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bnd, bound_by=by,
                             library_ms=library_ms)

    radius, k = 4, 9
    for name, (h1, w1) in DOWNSCALE_GRIDS.items():
        pyramid, coords, _, _ = lookup_case(corr, dev, h1, w1)
        flat = coords.reshape(-1, 2)
        Q = flat.shape[0]
        want = corr.corr_lookup_plain(pyramid, coords, radius)
        got = kernels.corr_pyramid_lookup(pyramid, coords, radius)
        torch.cuda.synchronize()
        err = (got.reshape(want.shape) - want).abs().max().item()
        ms = time_ms(lambda: kernels.corr_pyramid_lookup(pyramid, coords,
                                                         radius))
        plain_ms = time_ms(lambda: corr.corr_lookup_plain(pyramid, coords,
                                                           radius), iters=5)
        library_ms = time_ms(lambda: _grid_sample_levels(pyramid, flat,
                                                         radius))
        n_out = Q * 4 * k * k
        bnd, by = bound_ms(_window_bytes(pyramid, flat, None, radius)
                           + Q * 8 + n_out * 4, n_out * 18)
        levels = ", ".join("%dx%d" % tuple(p.shape[1:]) for p in pyramid)
        log(f"kernel B [dense, grid {name}, Q={Q}, levels {levels}]: "
            f"max_abs_err {err:.3g} (tol {LOOKUP_TOL}); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, F.grid_sample x4 levels "
            f"{library_ms:.4f} ms, bound {bnd:.4f} ms ({by})")
        if not err <= LOOKUP_TOL:
            raise AssertionError(f"kernel B disagrees on grid {name}: {err}")
        out[f"B {name}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bnd, bound_by=by,
                                library_ms=library_ms)
        del pyramid, want, got
    return out


def dense_vs_sparse_px(dev, dense, config, h, w):
    """The largest corner distance over a dense-head track's frames
    (``ablation_walk`` with ``sparse_weights=False``) to the same track
    with the config's sparse head."""
    sparse = ablation_walk(dev, config, h, w)
    return max(h_diff_px(a, b, dense["corners"])
               for a, b in zip(dense["hs"], sparse["hs"]))


def track_ablations(kernels, corr, warp, dev):
    """The ablation paths on the card: A and B at the downscale shapes
    (``check_downscale_shapes``), then each of ``ABLATION_TRACKS``
    (``ablation_walk``) with the counters zeroed before and read after,
    its launches held to A once a frame and B 13 times a flow, exactly,
    nothing else, and its corner error to ``ABLATION_CORNER_BOUND_PX``;
    the dense-head track against the canonical sparse-head track on the
    same frames within ``DENSE_HEAD_TOL_PX``; then, where ``cv2`` can be
    imported, the host fits' tracks (``HOST_FIT_TRACKS``) the same way,
    else one line says they were not run. Returns (the shape rows, {label
    at frame: the track's numbers})."""
    import importlib.util

    t_phase = time.perf_counter()
    shapes = check_downscale_shapes(kernels, corr, warp, dev)
    tracks = {}
    has_cv2 = importlib.util.find_spec("cv2") is not None
    for config, h, w, overrides in ABLATION_TRACKS + (
            HOST_FIT_TRACKS if has_cv2 else ()):
        torch.cuda.empty_cache()
        res = ablation_walk(dev, config, h, w, overrides, kernels)
        report_ablation_walk(res)
        key = (res["what"], res["frame"])
        if not all(np.isfinite(H).all() for H in res["hs"]):
            raise AssertionError(f"{key}: non-finite homography")
        check_counts(f"{res['what']} at {res['frame']}", res["launches"],
                     {"warp_perspective_bilinear": res["n_frames"],
                      "corr_pyramid_lookup": 13 * res["n_flows"]},
                     ("warp_perspective_bilinear", "corr_pyramid_lookup"),
                     res["n_frames"], res["n_flows"])
        n = len(res["frame_ms"])
        for errs, bound, which in zip(
                (res["errs"][:n], res["errs"][n:]),
                ABLATION_CORNER_BOUND_PX[key],
                ("the walk", "the fallback frames")):
            if not (np.isfinite(errs).all() and max(errs) <= bound):
                raise AssertionError(f"{key}: corner error {max(errs):.3f} "
                                     f"px on {which}, bound {bound} px")
        tracks[f"{res['what']} {res['frame']}"] = res
    # the dense head against the sparse one: the same track with the
    # config's sparse head, uncounted, on the same frames
    config, h, w, overrides = next(t for t in ABLATION_TRACKS
                                   if t[3].get("sparse_weights") is False)
    dense = tracks[f"{ablation_label(config, overrides)} {w}x{h}"]
    diff = dense_vs_sparse_px(dev, dense, config, h, w)
    log(f"{dense['what']} against the sparse head, {w}x{h}, "
        f"{len(dense['hs'])} frames: largest corner distance {diff:.2e} px "
        f"(tol {DENSE_HEAD_TOL_PX})")
    if not diff <= DENSE_HEAD_TOL_PX:
        raise AssertionError(f"dense head disagrees with the sparse head: "
                             f"{diff} px")
    if not has_cv2:
        log("WOFT_cvransac.py, WOFT_trs.py: not run (their host fits need "
            "cv2, which this machine cannot import)")
    log(f"ablation phase: {time.perf_counter() - t_phase:.1f} s")
    return shapes, tracks


def check_guard_on_a_path(kernels, corr, dev):
    """Kernel E doing work on a path: a 720p block-local forward whose
    ``flow_init`` (rotation-like, with jitter on some blocks) makes blocks
    violate their fine windows. The guarded lookup at those coordinates must
    equal the CPU path's (plain versions, ``check=True``) on the same
    volume, and differ from the unguarded fine lookup."""
    from woft_tpu_torch.models.raft import (RaftConfig, init_raft_params,
                                            weighted_raft_forward)

    cfg = RaftConfig(corr_impl="local", precision="bf16")
    model = init_raft_params(cfg, seed=0, device=dev)
    img1 = torch.tensor(textured_frame(H_IMG, W_IMG, seed=8),
                        dtype=torch.float32, device=dev)[None]
    img2 = torch.roll(img1, shifts=(3, -5), dims=(1, 2))
    coords = _local_coords(dev, "violating")
    flow_init = coords - _cell_grid(dev)

    for name in COUNTED:
        getattr(kernels, name).launches = 0
    out = weighted_raft_forward(model, cfg, img1, img2, flow_init=flow_init)
    torch.cuda.synchronize()
    counts = {name: getattr(kernels, name).launches for name in COUNTED}
    if not torch.isfinite(out["flow_up"]).all():
        raise AssertionError("non-finite flow on the flow_init path")
    if counts["local_lookup_exact_coords"] < 13:
        raise AssertionError(f"kernel E launched "
                             f"{counts['local_lookup_exact_coords']} times")

    # the first iteration's lookup, rebuilt from the same features
    from woft_tpu_torch.models.raft import encode_template
    f1 = encode_template(model, cfg, img1)[0]
    f2 = encode_template(model, cfg, img2)[0]
    local = corr.build_local_corr(f1.contiguous(), f2.contiguous(), 4, 4, 16,
                                  out_dtype=torch.bfloat16)
    starts, _ = corr._local_level_coords(local, coords)
    n_bad = int((~corr._fine_anchor_starts(local, starts)[2]).sum().item())
    guarded = corr.corr_lookup_local_blocked(local, coords, 4).data
    unguarded = corr.corr_lookup_local_blocked(local, coords, 4,
                                               check=False).data
    cpu = corr.LocalCorrVolumes([v.cpu() for v in local.volumes], local.meta)
    want = corr.corr_lookup_local_blocked(cpu, coords.cpu(), 4).data
    torch.cuda.synchronize()
    err = (guarded.float().cpu() - want.float()).abs().max().item()
    moved = (guarded.float() - unguarded.float()).abs().max().item()
    log(f"flow_init path: {n_bad} of {guarded.shape[0]} blocks violate at the "
        f"first lookup; launches {counts}; guarded lookup vs the CPU path "
        f"(check=True) max_abs_err {err:.3g} (tol {LOCAL_LOOKUP_TOL}); "
        f"kernel E moved the violating blocks' rows by up to {moved:.3g}")
    if n_bad <= local.meta["nbw"] or moved == 0.0:
        raise AssertionError("no full block violated on the flow_init path")
    if err > LOCAL_LOOKUP_TOL:
        raise AssertionError("guarded lookup disagrees with the CPU path")


def check_local_equals_dense_720p(dev):
    """The block-local path against the dense path at 1280x720, float32,
    full width, on the card: while the flow stays within the margin the two
    read the same correlation values, so the flows agree to the tolerance of
    two float32 summation orders over 12 iterations."""
    from woft_tpu_torch.models.raft import (RaftConfig, init_raft_params,
                                            weighted_raft_forward)

    img1 = torch.tensor(textured_frame(H_IMG, W_IMG, seed=9),
                        dtype=torch.float32, device=dev)[None]
    img2 = torch.roll(img1, shifts=(3, -5), dims=(1, 2))
    model = init_raft_params(RaftConfig(), seed=0, device=dev)
    dense = weighted_raft_forward(model, RaftConfig(), img1, img2)
    local = weighted_raft_forward(model, RaftConfig(corr_impl="local"), img1,
                                  img2)
    torch.cuda.synchronize()
    reach = dense["flow"].abs().max().item()          # 1/8-resolution cells
    ferr = (dense["flow_up"] - local["flow_up"]).abs().max().item()
    werr = (dense["weights_up"] - local["weights_up"]).abs().max().item()
    log(f"720p float32 forward, block-local vs dense: flow {ferr:.3g} px "
        f"(tol {FLOW_TOL_PX}), weights {werr:.3g}; largest flow {reach:.3g} "
        f"cells of a margin of 16")
    if reach >= 16:
        raise AssertionError("the test flow left the block-local margin")
    if not ferr <= FLOW_TOL_PX:
        raise AssertionError("block-local and dense forwards disagree")


def check_fused_equals_unfused_720p(dev):
    """The fused refinement loop against the unfused one at 1280x720 in
    bf16, full width, on the card. Both round at bf16 but not at the very
    same places (the unfused path rounds a bias before its bf16
    convolution, and cuDNN sums in its own order), so they agree to bf16
    rounding noise over 12 iterations."""
    from woft_tpu_torch.models.raft import (RaftConfig, init_raft_params,
                                            weighted_raft_forward)

    img1 = torch.tensor(textured_frame(H_IMG, W_IMG, seed=9),
                        dtype=torch.float32, device=dev)[None]
    img2 = torch.roll(img1, shifts=(3, -5), dims=(1, 2))
    base = RaftConfig(corr_impl="local", precision="bf16")
    model = init_raft_params(base, seed=0, device=dev)
    unfused = weighted_raft_forward(model, base, img1, img2)
    fused = weighted_raft_forward(
        model, RaftConfig(corr_impl="local", precision="bf16", **FUSED_FLAGS),
        img1, img2)
    torch.cuda.synchronize()
    ferr = (fused["flow_up"] - unfused["flow_up"]).abs().max().item()
    werr = (fused["weights_up"] - unfused["weights_up"]).abs().max().item()
    log(f"720p bf16 forward, fused loop vs unfused: flow {ferr:.3g} px (tol "
        f"{BF16_FLOW_TOL_PX}), weights {werr:.3g}; largest flow "
        f"{unfused['flow'].abs().max().item():.3g} cells")
    if not (torch.isfinite(fused["flow_up"]).all()
            and ferr <= BF16_FLOW_TOL_PX):
        raise AssertionError("fused and unfused forwards disagree")


def check_window_card_vs_cpu(dev):
    """``WOFTWindowTracker`` under ``configs/WOFT_window.py`` with a
    128-pixel window on the card against the same tracker on the CPU path
    (the kernels' plain versions), 3 frames of the walk at 640x360: the
    per-frame H within ``CORNER_TOL_PX`` at the target's corners (float32
    both, the convolutions summed in other orders)."""
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.tracker import WOFTWindowTracker

    h, w = 360, 640
    template, frames, poses = walk(h, w, dev, n=3)
    mask, corners = centred_mask(h, w, 1 / 3)
    hs = {}
    for d in (dev, torch.device("cpu")):
        conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                        "WOFT_window.py"))
        conf.window_size = 128
        tracker = WOFTWindowTracker(conf, device=d)
        tracker.init(template, mask)
        hs[d.type] = [tracker.track(f)[0] for f in frames]
    shape = tracker.win_hw
    diff = [corner_errors([a], [np.linalg.inv(b)], corners)[0]
            for a, b in zip(hs["cuda"], hs["cpu"])]
    errs = corner_errors(hs["cuda"], poses, corners)
    log(f"window tracker {shape[0]}x{shape[1]} at {w}x{h}, card vs CPU: "
        f"{', '.join(f'{e:.3g}' for e in diff)} px (tol {CORNER_TOL_PX}); "
        f"against the walk {', '.join(f'{e:.3f}' for e in errs)} px")
    if not max(diff) <= CORNER_TOL_PX:
        raise AssertionError("the window tracker on the card disagrees with "
                             "its CPU path")


def check_window_local_equals_dense(dev):
    """The block-local forward against the dense one at ``bench.py``'s
    192x344 window (24 x 43 cells: padding columns in the last block
    column), float32, the trained window-mode weights, on the card: while
    the flow stays within the margin both read the same correlation
    values."""
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow import RaftFlow
    from woft_tpu_torch.models.raft import RaftConfig, weighted_raft_forward

    conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                    "WOFT_window.py"))
    model = RaftFlow(conf.flow_config, device=dev).model
    img1 = torch.tensor(textured_frame(192, 344, seed=9),
                        dtype=torch.float32, device=dev)[None]
    img2 = torch.roll(img1, shifts=(3, -5), dims=(1, 2))
    dense = weighted_raft_forward(model, RaftConfig(), img1, img2)
    local = weighted_raft_forward(model, RaftConfig(corr_impl="local"), img1,
                                  img2)
    torch.cuda.synchronize()
    reach = dense["flow"].abs().max().item()
    ferr = (dense["flow_up"] - local["flow_up"]).abs().max().item()
    werr = (dense["weights_up"] - local["weights_up"]).abs().max().item()
    log(f"192x344 float32 forward, block-local vs dense: flow {ferr:.3g} px "
        f"(tol {FLOW_TOL_PX}), weights {werr:.3g}; largest flow {reach:.3g} "
        f"cells of a margin of 16")
    if reach >= 16:
        raise AssertionError("the test flow left the block-local margin")
    if not ferr <= FLOW_TOL_PX:
        raise AssertionError("block-local and dense window forwards disagree")


# bench.py's bf16 block-local step on the card against the same step on
# the CPU path, at the target's corners on the first 3 frames of the 1080p
# walk (well conditioned, unlike the fallback frames). Both round at bf16
# in their own orders. On these frames a CPU's bf16 track lies at most
# 0.0553 px from its float32 track (0.0276, 0.0308, 0.0251 px on one CPU;
# 0.0206, 0.0267, 0.0553 on another, whose bf16 track lies 0.0448 px from
# the first's at most; tools/torch_window_walks.py --precisions --save).
# Card vs CPU is at most the card's distance from float32 plus the CPU's;
# the card's is allowed twice the CPUs' largest: 3 x 0.0553 px
WINDOW_STEP_BF16_TOL_PX = 0.17


def check_window_step_card_vs_cpu(dev):
    """``bench.py``'s window step (``window_runner``'s ``"window_step"``:
    block-local, bf16, 12 iterations, the 192x344 window, the trained
    window-mode weights) on the card against the same step on the CPU path
    (the kernels' plain versions), on the first 3 frames of the 1080p walk:
    the per-frame H within ``WINDOW_STEP_BF16_TOL_PX`` at the target's
    corners."""
    h, w = 1080, 1920
    template, frames, poses = walk(h, w, torch.device("cpu"), n=3)
    mask, corners = centred_mask(h, w, 1 / 3)
    hs = {}
    for d in (dev, torch.device("cpu")):
        track, _ = window_runner(d, "window_step", template, frames, mask)()
        hs[d.type] = [track(i)[0] for i in range(3)]
    diff = [corner_errors([a], [np.linalg.inv(b)], corners)[0]
            for a, b in zip(hs["cuda"], hs["cpu"])]
    errs = corner_errors(hs["cuda"], poses, corners)
    log(f"window step 192x344 at {w}x{h}, block-local bf16, card vs CPU: "
        f"{', '.join(f'{e:.4f}' for e in diff)} px (tol "
        f"{WINDOW_STEP_BF16_TOL_PX}); against the walk "
        f"{', '.join(f'{e:.3f}' for e in errs)} px")
    if not max(diff) <= WINDOW_STEP_BF16_TOL_PX:
        raise AssertionError("the bf16 window step on the card disagrees "
                             "with its CPU path")


def check_small_references(dev):
    """Oracle-flow tracker on the card, and the RAFT forward card vs CPU."""
    from woft_tpu_torch.models.raft import (RaftConfig, init_raft_params,
                                            weighted_raft_forward)
    from woft_tpu_torch.ops.warp import warp_perspective
    from woft_tpu_torch.tracker import (TrackerParams, build_track_step,
                                        tracker_init_state)
    from woft_tpu_torch.geometry import h_proj

    h, w = 96, 128
    rng = np.random.default_rng(0)
    template = torch.tensor(rng.uniform(0, 255, (1, h, w, 3)),
                            dtype=torch.float32, device=dev)
    mask = torch.zeros(h, w, dtype=torch.bool, device=dev)
    mask[24:72, 32:96] = True
    h_true = torch.tensor([[0.98, 0.03, 4.0], [-0.02, 1.01, -3.0],
                           [1e-5, -2e-5, 1.0]], device=dev)   # cur -> tmpl
    h_obs = torch.linalg.inv(h_true)

    def oracle_flow(model, img1, img2, template_feats=None):
        i = torch.arange(h * w, device=dev)
        src = torch.stack([(i % w).float(), (i // w).float(),
                           torch.ones(h * w, device=dev)])
        proj = h_obs @ src
        flow = (proj[:2] / proj[2:] - src[:2]).T.reshape(1, h, w, 2)
        return flow, torch.ones(1, h, w, 1, device=dev)

    cfg = RaftConfig(iters=2)
    tp = TrackerParams()
    step = build_track_step(cfg, tp, flow_fn=oracle_flow)
    state = tracker_init_state(None, cfg, tp, template, mask, encode=False)
    _, H, meta = step(None, state, warp_perspective(template, h_obs))
    corners = torch.tensor([[[32.0, 96.0, 96.0, 32.0], [24.0, 24.0, 72.0,
                                                        72.0]]], device=dev)
    err = (h_proj(H[None], corners) - h_proj(h_true[None], corners)).norm(
        dim=1).max().item()
    log(f"oracle-flow tracker: corner error {err:.4g} px (tol "
        f"{CORNER_TOL_PX}), check passed {meta['global_H_success']}")
    if not (err < CORNER_TOL_PX and meta["global_H_success"]):
        raise AssertionError("oracle-flow tracker missed the homography")

    img1 = torch.tensor(rng.uniform(0, 255, (1, 64, 96, 3)),
                        dtype=torch.float32)
    img2 = torch.roll(img1, shifts=(2, 3), dims=(1, 2))
    for what, cfg, tol in (
            ("dense, float32", RaftConfig(iters=12), FLOW_TOL_PX),
            ("block-local, float32",
             RaftConfig(iters=12, corr_impl="local", local_margin=8),
             FLOW_TOL_PX),
            ("block-local, bf16",
             RaftConfig(iters=12, corr_impl="local", local_margin=8,
                        precision="bf16"), BF16_FLOW_TOL_PX),
            ("block-local, bf16, fused loop",
             RaftConfig(iters=12, corr_impl="local", local_margin=8,
                        precision="bf16", **FUSED_FLAGS), BF16_FLOW_TOL_PX)):
        outs = {}
        for d in ("cpu", dev):
            model = init_raft_params(cfg, seed=0, device=d)
            o = weighted_raft_forward(model, cfg, img1.to(d), img2.to(d))
            outs[str(d)] = {k: o[k].cpu() for k in ("flow_up", "weights_up")}
        ferr = (outs["cpu"]["flow_up"]
                - outs[str(dev)]["flow_up"]).abs().max().item()
        werr = (outs["cpu"]["weights_up"]
                - outs[str(dev)]["weights_up"]).abs().max().item()
        log(f"RAFT forward 64x96, 12 iters ({what}), card vs CPU: flow "
            f"{ferr:.3g} px (tol {tol}), weights {werr:.3g}")
        if not ferr <= tol:
            raise AssertionError(f"RAFT forward ({what}) on the card "
                                 f"disagrees with CPU")


# ---------------------------------------------------------------------------
# multi-target tracking at 1920x1080: kernels at its shapes, then the paths
# ---------------------------------------------------------------------------

def shared_masks(n, h=MULTI_H, w=MULTI_W):
    """``bench.py``'s shared-flow layout (bench_multi, shared mode): a grid
    of 4 columns and ceil(n / 4) rows, each target the middle half of its
    cell's height and an eighth of the frame's width."""
    rows = max(1, (n + 3) // 4)
    ch = h // rows
    masks = np.zeros((n, h, w), bool)
    for t in range(n):
        y, x = (t // 4) * ch, (t % 4) * (w // 4)
        masks[t, y + ch // 4:y + 3 * ch // 4, x + w // 16:x + 3 * w // 16] = 1
    return masks


def window_masks(n, h=MULTI_H, w=MULTI_W):
    """``bench.py``'s per-window layout (bench_multi): two rows of four
    targets, each a quarter of the frame's height and an eighth of its
    width."""
    masks = np.zeros((n, h, w), bool)
    for t in range(n):
        y, x = (t // 4) * (h // 2), (t % 4) * (w // 4)
        masks[t, y + h // 8:y + 3 * h // 8, x + w // 16:x + 3 * w // 16] = 1
    return masks


def mask_corners(mask):
    """(2, 4) corners of a box mask, inclusive, as ``centred_mask``'s."""
    ys, xs = np.where(mask)
    x0, x1, y0, y1 = xs.min(), xs.max(), ys.min(), ys.max()
    return np.array([[x0, x1, x1, x0], [y0, y0, y1, y1]], np.float64)


def h_diff_px(Ha, Hb, corners):
    """Largest distance between the corners mapped by two homographies."""
    def proj(H):
        p = np.asarray(H, np.float64) @ np.vstack([corners, np.ones(4)])
        return p[:2] / p[2:]
    return float(np.linalg.norm(proj(Ha) - proj(Hb), axis=0).max())


def crop_homographies(masks, size=256, margin=0.5):
    """The template crops of ``window_init_state`` for box masks at
    ``WindowParams(size)``: each target's box with the margins, squared,
    scaled into size x size. (N, 3, 3) float32."""
    hs = []
    for m in masks:
        c = mask_corners(m)
        w, h = c[0, 1] - c[0, 0] + 1, c[1, 2] - c[1, 0] + 1
        side = max(w, h) * (1 + 2 * margin)
        x0 = c[0, 0] + w / 2 - side / 2
        y0 = c[1, 0] + h / 2 - side / 2
        s = size / side
        hs.append([[s, 0.0, -s * x0], [0.0, s, -s * y0], [0.0, 0.0, 1.0]])
    return torch.tensor(hs, dtype=torch.float32)


def _grid_sample_levels(pyramid, flat, radius, rows=None):
    """Library yardstick of kernel B: one ``F.grid_sample`` a level, the
    indexed form gathering the rows' levels inside the call."""
    k = 2 * radius + 1
    d = torch.arange(k, device=flat.device, dtype=torch.float32) - radius
    outs = []
    for lvl, p in enumerate(pyramid):
        hl, wl = p.shape[1:]
        c = flat.reshape(-1, 1, 1, 2) / 2 ** lvl
        gx, gy = torch.broadcast_tensors(c[..., 0] + d[:, None],
                                         c[..., 1] + d[None, :])
        grid = torch.stack([2 * gx / (wl - 1) - 1, 2 * gy / (hl - 1) - 1],
                           -1).to(p.dtype)          # the call wants one dtype
        lv = p[:, None] if rows is None else p[rows][:, None]
        outs.append(F.grid_sample(lv, grid, mode="bilinear",
                                  padding_mode="zeros", align_corners=True))
    return outs


def check_multi_shapes(kernels, corr, warp, dev):
    """Kernels A-E at the shapes the multi-target paths give them, each
    against its plain version and timed beside its bound, its plain
    version and a PyTorch call: A cropping 8 windows of 256 x 256 from one
    1920x1080 frame in one launch; B dense over the pyramid of 8 windows of
    32 x 32 cells (Q = 8,192) and indexed at the sparse weight head's
    M = 8 x 4,500 rows; C, D and E on the 1080p grid (135 x 240 cells; D
    and E in bf16 and float32 on three fields in ``check_coord_lookups``).
    Returns {kernel: row}."""
    out = {}
    # A: one source, 8 homographies (the per-window path's crops)
    src = torch.tensor(textured_frame(MULTI_H, MULTI_W, seed=4),
                       dtype=torch.float32, device=dev)[None]
    H = crop_homographies(window_masks(8)).to(dev)
    hinv = warp.inverse_h(H)
    want = warp.warp_perspective(src, H, (256, 256))
    n0 = kernels.warp_perspective_bilinear.launches
    got = kernels.warp_perspective_bilinear(src, hinv, 256, 256)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if kernels.warp_perspective_bilinear.launches != n0 + 1:
        raise AssertionError("kernel A took more than one launch")
    coords = warp.perspective_coords(H, (256, 256))
    x0, y0 = torch.floor(coords[..., 0]).long(), torch.floor(
        coords[..., 1]).long()
    read = torch.cat([(y0 + dy).clamp(0, MULTI_H - 1) * MULTI_W
                      + (x0 + dx).clamp(0, MULTI_W - 1)
                      for dy in (0, 1) for dx in (0, 1)]).unique().numel()
    px = got.numel() // 3
    bnd, by = bound_ms(read * 12 + got.numel() * 4 + hinv.numel() * 4,
                       px * (12 + 2 + 4 + 36))
    grid = torch.stack([2 * coords[..., 0] / (MULTI_W - 1) - 1,
                        2 * coords[..., 1] / (MULTI_H - 1) - 1], -1)
    src8 = src.permute(0, 3, 1, 2).contiguous().expand(8, -1, -1, -1)
    ms = time_ms(lambda: kernels.warp_perspective_bilinear(src, hinv, 256,
                                                           256))
    plain_ms = time_ms(lambda: warp.warp_perspective(src, H, (256, 256)),
                       iters=5, warmup=1)
    library_ms = time_ms(lambda: F.grid_sample(
        src8, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True))
    log(f"kernel A [one 1920x1080 source, 8 homographies -> 8 x 256x256, "
        f"one launch]: max_abs_err {err:.3g} (tol {WARP_TOL}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, F.grid_sample on the "
        f"expanded source {library_ms:.4f} ms, bound {bnd:.4f} ms ({by}; "
        f"{read} source pixels read)")
    if not err <= WARP_TOL:
        raise AssertionError(f"kernel A (one source, 8 homographies) "
                             f"disagrees: {err}")
    out["A"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                    bound_by=by, library_ms=library_ms)

    # B: the batched window forward's pyramid, dense and indexed
    radius, k = 4, 9
    g = torch.Generator(device=dev).manual_seed(11)
    f1 = torch.randn(8, 32, 32, 256, device=dev, generator=g)
    f2 = torch.randn(8, 32, 32, 256, device=dev, generator=g)
    pyramid, _ = corr.corr_pyramid_fused(f1, f2, 4)
    coords = (_cell_grid(dev, 32, 32) + (torch.rand(
        8, 32, 32, 2, device=dev, generator=g) - 0.5) * 40).contiguous()
    flat = coords.reshape(-1, 2)
    Q, M = flat.shape[0], 8 * 4500
    rows = torch.randint(0, Q, (M,), device=dev, generator=g)
    c_rows = flat[rows].contiguous()
    got = kernels.corr_pyramid_lookup(pyramid, coords, radius)
    want = corr.corr_lookup_plain(pyramid, coords, radius).reshape(Q, -1)
    got_i = kernels.corr_pyramid_lookup(pyramid, c_rows, radius, rows=rows)
    want_i = corr.corr_lookup_plain([p[rows] for p in pyramid], c_rows,
                                    radius)
    torch.cuda.synchronize()
    err, err_i = ((a - b).abs().max().item()
                  for a, b in ((got, want), (got_i, want_i)))
    ms = time_ms(lambda: kernels.corr_pyramid_lookup(pyramid, coords,
                                                     radius))
    plain_ms = time_ms(lambda: corr.corr_lookup_plain(pyramid, coords,
                                                       radius), iters=3)
    library_ms = time_ms(lambda: _grid_sample_levels(pyramid, flat, radius))
    ms_i = time_ms(lambda: kernels.corr_pyramid_lookup(pyramid, c_rows,
                                                       radius, rows=rows))
    plain_ms_i = time_ms(lambda: corr.corr_lookup_plain(
        [p[rows] for p in pyramid], c_rows, radius), iters=3)
    library_ms_i = time_ms(lambda: _grid_sample_levels(pyramid, c_rows,
                                                       radius, rows),
                           iters=5, warmup=1)
    n_out, n_out_i = Q * 4 * k * k, M * 4 * k * k
    bnd, by = bound_ms(_window_bytes(pyramid, flat, None, radius) + Q * 8
                       + n_out * 4, n_out * 18)
    bnd_i, by_i = bound_ms(_window_bytes(pyramid, c_rows, rows, radius)
                           + M * 16 + n_out_i * 4, n_out_i * 18)
    log(f"kernel B [dense, pyramid of 8 windows x 32x32 cells, Q={Q}]: "
        f"max_abs_err {err:.3g} (tol {LOOKUP_TOL}); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, F.grid_sample x4 levels "
        f"{library_ms:.4f} ms, bound {bnd:.4f} ms ({by})")
    log(f"kernel B [indexed M={M}, the weight head's rows of 8 windows]: "
        f"max_abs_err {err_i:.3g}; kernel {ms_i:.4f} ms, plain "
        f"{plain_ms_i:.4f} ms, gather + F.grid_sample x4 {library_ms_i:.4f} "
        f"ms, bound {bnd_i:.4f} ms ({by_i})")
    if not max(err, err_i) <= LOOKUP_TOL:
        raise AssertionError(f"kernel B disagrees on the batched pyramid: "
                             f"{err}, {err_i}")
    out["B"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                    bound_by=by, library_ms=library_ms)
    out["B indexed"] = dict(max_abs_err=err_i, ms=ms_i, plain_ms=plain_ms_i,
                            bound_ms=bnd_i, bound_by=by_i,
                            library_ms=library_ms_i)
    del pyramid, got, want, got_i, want_i

    # C on the 1080p grid, bf16 (the path's) and float32
    grid_name = "%dx%d" % MULTI_GRID
    for dtype, rtol, rate in ((torch.bfloat16, CORR_RTOL_BF16, BF16_FLOPS),
                              (torch.float32, CORR_RTOL_FP32, FP32_FLOPS)):
        case = _local_corr_case(corr, dev, *MULTI_GRID, dtype)
        err = _compare_local_corr(kernels, corr, case, dtype, rtol,
                                  grid_name)
        if dtype == torch.bfloat16:
            out["C"] = dict(max_abs_err=err, **_time_local_corr(
                kernels, corr, case, dtype, rate, grid_name))
        del case

    # D and E timed on a bf16 1080p volume at a smooth field (checked in
    # check_coord_lookups at this grid on three fields, both dtypes)
    g = torch.Generator(device=dev).manual_seed(13)
    f1 = torch.randn(1, *MULTI_GRID, 256, device=dev, generator=g)
    f2 = torch.randn(1, *MULTI_GRID, 256, device=dev, generator=g)
    local = corr.build_local_corr(f1, f2, 4, 4, 16, out_dtype=torch.bfloat16)
    coords = (_cell_grid(dev, *MULTI_GRID)
              + torch.tensor([2.3, -3.1], device=dev)).contiguous()
    out.update(_time_coord_lookups(kernels, corr, local, coords, grid_name))
    return out


def profile_launches(fn):
    """Device kernel launches and busy ms of one call of ``fn`` (ending in
    a host read), traced by ``torch.profiler``; a spin leads the window (not
    counted), so the call's kernels run after the trace has started."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "spin" not in e.name and not e.name.startswith("Mem")]
    if not ev:
        raise AssertionError("the profiler recorded no kernel")
    return len(ev), sum(e.time_range.elapsed_us() for e in ev) / 1e3


def assert_no_host_sync(what, fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode('warn')``: a chunk
    loop must queue its frames without one synchronizing operation."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message)[:200] for w in caught
             if "called a synchronizing" in str(w.message)]
    log(f"{what}: {len(syncs)} synchronizing operations "
        f"(torch.cuda.set_sync_debug_mode)")
    if syncs:
        raise AssertionError(f"{what} synced to the host: {syncs[:3]}")
    torch.cuda.synchronize()
    return out


def _frames_on(frames, dev):
    """BGR uint8 frames as a (T, 1, H, W, 3) chunk on the card."""
    return torch.from_numpy(np.stack(frames)).to(dev)[:, None]


def _report_multi(what, n, frame_ms, hs, poses, masks, oks, bound=None):
    """Logs a multi-target track: steady frame ms, targets·frames/s, check
    passes, each target's worst corner error against the walk; holds them
    to ``bound`` and every check to pass when ``bound`` is given. hs: (T,
    N, 3, 3) numpy; oks: (T, N) bool. Returns the worst corner errors."""
    steady = frame_ms[1:] or frame_ms
    mean = sum(steady) / len(steady)
    errs = [max(corner_errors(hs[:, t], poses, mask_corners(masks[t])))
            for t in range(n)]
    log(f"{what}: first frame {frame_ms[0]:.1f} ms, steady frames "
        f"{min(steady):.1f}-{max(steady):.1f} ms (mean {mean:.1f}), "
        f"{n * 1e3 / mean:.1f} targets·frames/s; checks passed "
        f"{int(oks.sum())}/{oks.size}; worst corner error against the walk "
        f"a target (px) {', '.join(f'{e:.3f}' for e in errs)}")
    if not np.isfinite(hs).all():
        raise AssertionError(f"{what}: non-finite homography")
    if bound is not None:
        if not oks.all():
            raise AssertionError(f"{what}: a target failed its check")
        if not max(errs) <= bound:
            raise AssertionError(f"{what}: corner error {max(errs):.3f} px, "
                                 f"bound {bound} px")
    return errs


def track_shared(kernels, dev, model, cfg, tp):
    """Shared-flow multi-target tracking at 1920x1080 on ``WOFT_fast.py``
    (``SharedMultiTracker``: one block-local bf16 flow a frame, 8 fits):
    8 frames of the walk per frame, counted from 0 (A, C once, D and E 13
    times a frame); every target passes its check on every frame, its
    corners within ``MULTI_CORNER_BOUND_PX`` of the walk; the same frames
    in two chunks of 4 equal the per-frame run, with no host sync in a
    chunk; fits in groups of 3 equal the ungrouped ones; launches and
    device busy a frame. Returns the path's numbers."""
    from woft_tpu_torch.pipeline import SharedMultiTracker

    template, frames, poses = walk(MULTI_H, MULTI_W, dev)
    masks = shared_masks(8)
    n = len(masks)
    log(f"--- shared flow x{n} at {MULTI_W}x{MULTI_H}: WOFT_fast.py "
        f"(corr_impl {cfg.corr_impl}, precision {cfg.precision})")
    torch.cuda.synchronize()
    zero_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    tracker = SharedMultiTracker(model, cfg, tp, device=dev)
    tracker.init(template, masks)
    hs, oks, frame_ms = [], [], []
    for f in frames:
        t0 = time.perf_counter()
        h, meta = tracker.track(f)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        hs.append(h)
        oks.append(meta["global_H_success"])
    launches = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    hs, oks = np.stack(hs), np.stack(oks)
    T = len(frames)
    check_counts(f"shared x{n}", launches, {
        "warp_perspective_bilinear": T, "local_corr_build": T,
        "local_lookup_coords": 13 * T, "local_lookup_exact_coords": 13 * T},
        ("warp_perspective_bilinear", "local_corr_build",
         "local_lookup_coords", "local_lookup_exact_coords"), T, T)
    errs = _report_multi(f"shared x{n}", n, frame_ms, hs, poses, masks, oks,
                         MULTI_CORNER_BOUND_PX)

    chunked = SharedMultiTracker(model, cfg, tp, device=dev)
    chunked.init(template, masks)
    hs_c = np.concatenate([chunked.track_chunk(np.stack(frames[i:i + 4]))[0]
                           for i in (0, 4)])
    diff = max(h_diff_px(a, b, mask_corners(masks[t]))
               for a_t, b_t in zip(hs, hs_c)
               for t, (a, b) in enumerate(zip(a_t, b_t)))
    log(f"shared x{n}: two chunks of 4 frames vs per-frame: {diff:.3g} px "
        f"(tol {CHUNK_TOL_PX})")
    if not diff <= CHUNK_TOL_PX:
        raise AssertionError("the shared chunk disagrees with per-frame")
    staged = _frames_on(frames[:4], dev)
    assert_no_host_sync(f"shared x{n}, a chunk of 4 frames", lambda: (
        chunked._chunk_step(model, chunked.state, chunked.masks,
                            chunked.h_last, staged)))

    grouped = SharedMultiTracker(model, cfg, replace(tp, multi_fit_chunk=3),
                                 device=dev)
    grouped.init(template, masks)
    hs_g = np.stack([grouped.track(f)[0] for f in frames[:3]])
    gdiff = max(h_diff_px(a, b, mask_corners(masks[t]))
                for a_t, b_t in zip(hs[:3], hs_g)
                for t, (a, b) in enumerate(zip(a_t, b_t)))
    log(f"shared x{n}: fits in 3 groups of 3 (the last padded) vs one "
        f"batch: {gdiff:.3g} px (tol {BATCH_TOL_PX})")
    if not gdiff <= BATCH_TOL_PX:
        raise AssertionError("grouped fits disagree with the ungrouped ones")

    n_launch, busy = profile_launches(lambda: tracker.track(frames[-1]))
    n_grouped, _ = profile_launches(lambda: grouped.track(frames[-1]))
    mean = sum(frame_ms[1:]) / (T - 1)
    log(f"shared x{n}: {n_launch} launches a frame ({n_grouped} with fits "
        f"in 3 groups); device busy {busy:.2f} ms a frame, "
        f"{100 * busy / mean:.1f} % of the steady frame; peak device memory "
        f"{peak:.2f} GiB")
    return dict(launches=launches, frame_ms=mean, per_frame_launches=n_launch,
                grouped_launches=n_grouped, busy_ms=busy, peak_gib=peak,
                errs=errs)


def track_shared_x64(kernels, dev, model, cfg, tp, x8):
    """Shared flow, 64 targets at 1920x1080 (``bench.py``'s grid of 16 rows
    of 4), one group of fits: one chunk of 4 frames after a warm-up chunk,
    counted from 0; the launches a frame must not grow with the targets
    (fewer than one more launch a target than ``x8``'s)."""
    from woft_tpu_torch.pipeline import SharedMultiTracker

    template, frames, poses = walk(MULTI_H, MULTI_W, dev)
    masks = shared_masks(64)
    n = len(masks)
    log(f"--- shared flow x{n} at {MULTI_W}x{MULTI_H}: WOFT_fast.py, fits "
        f"in one group of {tp.multi_fit_chunk}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tracker = SharedMultiTracker(model, cfg, tp, device=dev)
    tracker.init(template, masks)
    tracker.track_chunk(np.stack(frames[:4]))
    torch.cuda.synchronize()
    zero_counts(kernels)
    t0 = time.perf_counter()
    hs, meta = tracker.track_chunk(np.stack(frames[4:8]))
    wall = (time.perf_counter() - t0) * 1e3
    launches = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_counts(f"shared x{n}", launches, {
        "warp_perspective_bilinear": 4, "local_corr_build": 4,
        "local_lookup_coords": 52, "local_lookup_exact_coords": 52},
        ("warp_perspective_bilinear", "local_corr_build",
         "local_lookup_coords", "local_lookup_exact_coords"), 4, 4)
    errs = _report_multi(f"shared x{n}, frames 5-8 in one chunk", n,
                         [wall / 4] * 4, hs, poses[4:8], masks,
                         meta["global_H_success"])
    # the pre-warp follows target 0, here a strip at the top left edge
    # that the walk carries off the frame; with the target nearest the
    # frame's centre as the control instead:
    centre = np.array([MULTI_W / 2, MULTI_H / 2])
    c = int(np.argmin([np.linalg.norm(mask_corners(m).mean(1) - centre)
                       for m in masks]))
    order = [c] + [t for t in range(n) if t != c]
    ctl = SharedMultiTracker(model, cfg, tp, device=dev)
    ctl.init(template, masks[order])
    ctl.track_chunk(np.stack(frames[:4]))
    hs_c2, meta_c2 = ctl.track_chunk(np.stack(frames[4:8]))
    _report_multi(f"shared x{n}, target {c} (the centre) as the control, "
                  f"frames 5-8", n, [wall / 4] * 4, hs_c2, poses[4:8],
                  masks[order], meta_c2["global_H_success"])
    n_launch, busy = profile_launches(lambda: tracker.track(frames[-1]))
    log(f"shared x{n}: chunk of 4 frames {wall:.1f} ms, "
        f"{n * 4e3 / wall:.1f} targets·frames/s; {n_launch} launches a "
        f"frame (x{8}: {x8['per_frame_launches']}); device busy {busy:.2f} "
        f"ms a frame; peak device memory {peak:.2f} GiB")
    if n_launch - x8["per_frame_launches"] >= n - 8:
        raise AssertionError("the shared step's launches grow with the "
                             "targets")
    return dict(launches=launches, chunk_ms=wall, per_frame_launches=n_launch,
                busy_ms=busy, peak_gib=peak, worst_err=max(errs))


def track_window_batch(kernels, dev, precision=None):
    """Per-window batched tracking, 8 targets at 1920x1080 on
    ``WOFT_window.py`` (dense float32, the v5 export), ``WindowParams(
    size=256)`` as ``bench.py``: ``MultiTargetTracker`` over 8 frames of the
    walk, counted from 0 (A twice a frame and once an init, B 13 times a
    frame: one forward of the 8 windows); checks and corners as the shared
    path; each target against the single-target ``no_local_h`` window step
    (``BATCH_TOL_PX``); two chunks of 4 against the per-frame run, with no
    host sync in a chunk; launches and device busy a frame. ``precision``
    ('bf16': ``bench.py``'s default batch, the bf16 dense pyramid read by
    B's bf16 form) replaces the config's; then the track, its checks,
    corners, launches and busy time only."""
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow import RaftFlow
    from woft_tpu_torch.pipeline import MultiTargetTracker
    from woft_tpu_torch.tracker import (WindowParams, build_window_track_step,
                                        window_init_state)

    conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                    "WOFT_window.py"))
    flower = RaftFlow(conf.flow_config, device=dev)
    model, cfg, tp = flower.model, flower.cfg, conf.tracker_params
    if precision:
        cfg = replace(cfg, precision=precision)
    wp = WindowParams(size=256)
    template, frames, poses = walk(MULTI_H, MULTI_W, dev)
    masks = window_masks(8)
    n = len(masks)
    log(f"--- per-window batch x{n} at {MULTI_W}x{MULTI_H}: WOFT_window.py "
        f"(corr_impl {cfg.corr_impl}, precision {cfg.precision}), window "
        f"{wp.shape[0]}x{wp.shape[1]}, weights "
        f"{os.path.relpath(str(conf.flow_config.model), ROOT)}")
    torch.cuda.synchronize()
    zero_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    tracker = MultiTargetTracker(model, cfg, tp, wp, device=dev)
    tracker.init(template, masks)
    hs, oks, frame_ms = [], [], []
    for f in frames:
        t0 = time.perf_counter()
        h, meta = tracker.track(f)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        hs.append(h)
        oks.append(meta["global_H_success"])
    launches = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    hs, oks = np.stack(hs), np.stack(oks)
    T = len(frames)
    check_counts(f"window batch x{n}", launches, {
        "warp_perspective_bilinear": 2 * T + n, "corr_pyramid_lookup": 13 * T},
        ("warp_perspective_bilinear", "corr_pyramid_lookup"), T, T)
    errs = _report_multi(f"window batch x{n}", n, frame_ms, hs, poses, masks,
                         oks, MULTI_CORNER_BOUND_PX)
    if precision:
        n_launch, busy = profile_launches(lambda: tracker.track(frames[-1]))
        mean = sum(frame_ms[1:]) / (T - 1)
        log(f"window batch x{n} ({precision}): {n_launch} launches a frame; "
            f"device busy {busy:.2f} ms a frame; peak device memory "
            f"{peak:.2f} GiB")
        return dict(launches=launches, frame_ms=mean,
                    per_frame_launches=n_launch, busy_ms=busy, peak_gib=peak,
                    errs=errs)

    # each target through the single-target step on the same frames
    tp1 = replace(tp, no_local_h=True)
    step = build_window_track_step(cfg, tp1, wp)
    rgb = [torch.from_numpy(np.ascontiguousarray(f[..., ::-1])).to(dev)
           .to(torch.float32)[None] for f in [template] + frames]
    single = 0.0
    for t, m in enumerate(masks):
        state = window_init_state(model, cfg, tp1, wp, rgb[0], m)
        for i, f in enumerate(rgb[1:]):
            state, h, _ = step(model, state, f)
            single = max(single, h_diff_px(h.cpu().numpy(), hs[i, t],
                                           mask_corners(m)))
    log(f"window batch x{n} vs the single-target step, target by target: "
        f"{single:.3g} px (tol {BATCH_TOL_PX})")
    if not single <= BATCH_TOL_PX:
        raise AssertionError("the window batch disagrees with single steps")

    chunked = MultiTargetTracker(model, cfg, tp, wp, device=dev)
    chunked.init(template, masks)
    hs_c = np.concatenate([chunked.track_chunk(np.stack(frames[i:i + 4]))[0]
                           for i in (0, 4)])
    diff = max(h_diff_px(a, b, mask_corners(masks[t]))
               for a_t, b_t in zip(hs, hs_c)
               for t, (a, b) in enumerate(zip(a_t, b_t)))
    log(f"window batch x{n}: two chunks of 4 frames vs per-frame: "
        f"{diff:.3g} px (tol {CHUNK_TOL_PX})")
    if not diff <= CHUNK_TOL_PX:
        raise AssertionError("the window chunk disagrees with per-frame")
    staged = _frames_on(frames[:4], dev)
    assert_no_host_sync(f"window batch x{n}, a chunk of 4 frames", lambda: (
        chunked._chunk_step(model, chunked.states, staged)))

    n_launch, busy = profile_launches(lambda: tracker.track(frames[-1]))
    mean = sum(frame_ms[1:]) / (T - 1)
    log(f"window batch x{n}: {n_launch} launches a frame; device busy "
        f"{busy:.2f} ms a frame, {100 * busy / mean:.1f} % of the steady "
        f"frame; peak device memory {peak:.2f} GiB")
    return dict(launches=launches, frame_ms=mean, per_frame_launches=n_launch,
                busy_ms=busy, peak_gib=peak, errs=errs)


# ---------------------------------------------------------------------------
# the rest of the flow-network family: B on bf16 levels, the new tracks,
# the bf16 window batch, the alternate correlation
# ---------------------------------------------------------------------------

# (config, h, w, tracker overrides, flow config overrides), each on the
# 720p walk: 8 frames, then 3 with redetection='never'
FAMILY_TRACKS = (
    ("WOFT_rep.py", 720, 1280, {}, {}),
    ("ablation_10.py", 720, 1280, {}, {}),
    ("WOFT_origraft.py", 720, 1280, {}, {}),
    ("WOFT_masked.py", 720, 1280, {}, {}),
    ("WOFT.py", 720, 1280, {}, {}),
    ("WOFT.py", 720, 1280, {}, {"precision": "default"}),
)
# B's launches a flow on each: 12 iterations and the weight head's lookup;
# 'orig' has no head (woft_tpu/models/raft.py:739-740): 24 under
# orig_raft.py's 24 iterations, 12 in the external backend's RAFT
FAMILY_B_A_FLOW = {"WOFT_rep.py": 13, "ablation_10.py": 12,
                   "WOFT_origraft.py": 24, "WOFT_masked.py": 13,
                   "WOFT.py": 13, "WOFT.py precision=default": 13}
# corner error against the walk (px; the 8 frames, then the 3 fallback
# frames): the CPU path's own largest errors on the same walk
# (tools/torch_downscale_walks.py --family, 8 threads) plus headroom for
# the card's other summation orders, as ABLATION_CORNER_BOUND_PX. The
# 'default' track is held to WOFT.py's bound and, tighter, to WOFT.py's
# float32 track on the same frames (DEFAULT_VS_FP32_PX: TF32 products keep
# 10 mantissa bits where bf16 keeps 8; the bf16 window step stays within
# 0.023-0.063 px of its float32 CPU path). WOFT_origraft runs on seeded
# weights (raft-sintel.pth is not in the repository) and WOFT_masked on a
# seeded mask head (no trained one exists): their corners carry no meaning
# and are printed only.
FAMILY_CORNER_BOUND_PX = {
    ("WOFT_rep.py", "1280x720"): (0.5, 1.2),              # 0.300, 0.793
    ("ablation_10.py", "1280x720"): (0.5, 1.2),           # 0.310, 0.794
    ("WOFT.py", "1280x720"): (0.5, 0.6),                  # 0.255, 0.403
    ("WOFT.py precision=default", "1280x720"): (0.5, 0.6),
}
DEFAULT_VS_FP32_PX = 0.2
# the masked forward on the card against the CPU path, 1280x720, 12
# iterations, v4 and the seeded mask head: cuDNN's and the CPU's float32
# sums; a sanity bound (float32 at 64x96 agrees to ~2e-6 px)
MASKED_CARD_CPU_TOL = 1e-2
ALT_LOOKUP_REL = 1e-5            # the same products, summed in another order
ALT_4K_CORNER_BOUND_PX = 2.0     # sanity bound: no CPU path at 4K


def check_lookup_bf16(kernels, corr, dev):
    """Kernel B's bf16-level form against its plain version on the same
    bf16 levels (exact): the 720p pyramid dense (Q = 14,400) and indexed
    (M = 4,500), and the 8-window batch's pyramid (Q = 8,192); each timed
    beside its bound (2-byte window reads, float32 output), the plain
    version and ``F.grid_sample`` x4 on the bf16 levels (a bf16 grid: the
    call wants one dtype). Returns {shape: row}."""
    radius, k = 4, 9
    out = {}
    pyramid, coords, cells, c_cells = lookup_case(corr, dev)
    pyramid = [p.to(torch.bfloat16) for p in pyramid]
    g = torch.Generator(device=dev).manual_seed(8)
    f1 = torch.randn(8, 32, 32, 256, device=dev, generator=g)
    f2 = torch.randn(8, 32, 32, 256, device=dev, generator=g)
    batch, _ = corr.corr_pyramid_fused(f1, f2, 4, out_dtype=torch.bfloat16)
    b_coords = (_cell_grid(dev, 32, 32).expand(8, -1, -1, -1) + (torch.rand(
        8, 32, 32, 2, device=dev, generator=g) - 0.5) * 40).contiguous()
    cases = (("B bf16 720p dense", pyramid, coords, None),
             ("B bf16 720p indexed", pyramid, c_cells, cells),
             ("B bf16 8-window batch", batch, b_coords, None))
    for name, pyr, c, rows in cases:
        flat = c.reshape(-1, 2)
        Q = flat.shape[0]
        sub = pyr if rows is None else [p[rows] for p in pyr]
        want = corr.corr_lookup_plain(sub, c, radius).reshape(Q, -1)
        got = kernels.corr_pyramid_lookup(pyr, c, radius, rows=rows)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ms = time_ms(lambda: kernels.corr_pyramid_lookup(pyr, c, radius,
                                                         rows=rows))
        plain_ms = time_ms(lambda: corr.corr_lookup_plain(sub, c, radius),
                           iters=3)
        library_ms = time_ms(lambda: _grid_sample_levels(pyr, flat, radius,
                                                         rows), iters=5)
        n_out = Q * 4 * k * k
        bnd, by = bound_ms(_window_bytes(pyr, flat, rows, radius) + Q * 8
                           + (0 if rows is None else Q * 8) + n_out * 4,
                           n_out * 18)
        sec = _window_bytes(pyr, flat, rows, radius, sector=32)
        log(f"kernel B [{name[2:]}, Q={Q}]: max_abs_err {err:.3g} (exact "
            f"expected); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"F.grid_sample x4 on the bf16 levels {library_ms:.4f} ms, bound "
            f"{bnd:.4f} ms ({by}); windows {sec / 1e6:.1f} MB in 32-byte "
            f"sectors")
        if err != 0.0:
            raise AssertionError(f"kernel B on bf16 levels ({name}) differs "
                                 f"from its plain version: {err}")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bnd, bound_by=by, library_ms=library_ms)
    return out


def check_masked_card_vs_cpu(dev):
    """``WOFT_masked.py``'s flow (v4, the seeded mask head) on the first
    frame pair of the 720p walk, 12 iterations, on the card and on the CPU
    path: flow_up, weights_up and mask_up within MASKED_CARD_CPU_TOL; the
    share of the target where the sigmoided mask exceeds 0.5."""
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow import RaftFlow
    from woft_tpu_torch.flow.wrapper import upload_bgr

    conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                    "WOFT_masked.py"))
    template, frames, _ = walk(H_IMG, W_IMG, dev, n=1)
    mask, _ = centred_mask(H_IMG, W_IMG, 0.5)
    outs = {}
    for d in (dev, torch.device("cpu")):
        flower = RaftFlow(conf.flow_config, device=d)
        outs[d.type] = [o.cpu() for o in flower.compute_flow_device(
            upload_bgr(template, d), upload_bgr(frames[0], d))]
    errs = [(a - b).abs().max().item()
            for a, b in zip(outs["cuda"], outs["cpu"])]
    vis = (torch.sigmoid(outs["cuda"][2][0, ..., 0]) > 0.5).numpy()
    log(f"WOFT_masked.py first pair, card vs CPU: flow_up {errs[0]:.3g} px, "
        f"weights_up {errs[1]:.3g}, mask_up {errs[2]:.3g} (tol "
        f"{MASKED_CARD_CPU_TOL}); vis > 0.5 on {vis[mask].mean():.1%} of "
        f"the target, {vis.mean():.1%} of the frame")
    if not max(errs) <= MASKED_CARD_CPU_TOL:
        raise AssertionError("the masked forward on the card disagrees with "
                             "the CPU path")
    return dict(errs=errs, vis_target=float(vis[mask].mean()))


def check_alternate(kernels, corr, dev):
    """The alternate correlation: at 720p its lookup against kernel B on
    the float32 pyramid of the same features (``ALT_LOOKUP_REL``) and one
    flow's time against the dense path's (v4, 12 iterations, the dense
    head); then ``WOFT.py`` with ``alternate_corr=True`` at 3840x2160, 2
    frames of the walk: peak device memory, frame time and corners, where
    the float32 pyramid would need the bytes printed."""
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow import RaftFlow
    from woft_tpu_torch.models.raft import weighted_raft_forward

    g = torch.Generator(device=dev).manual_seed(11)
    f1 = torch.randn(1, 90, 160, 256, device=dev, generator=g)
    f2 = torch.randn(1, 90, 160, 256, device=dev, generator=g)
    coords = (_cell_grid(dev) + (torch.rand(1, 90, 160, 2, device=dev,
                                            generator=g) - 0.5) * 40)
    coords = coords.contiguous()
    pyramid, _ = corr.corr_pyramid_fused(f1, f2, 4)
    dense = corr.corr_lookup(pyramid, coords, 4)
    alt = corr.corr_lookup_alternate(f1, f2, coords, 4, 4)
    rel = ((alt - dense).abs().max() / dense.abs().max()).item()
    alt_ms = time_ms(lambda: corr.corr_lookup_alternate(f1, f2, coords, 4, 4),
                     iters=3, warmup=1)
    b_ms = time_ms(lambda: corr.corr_lookup(pyramid, coords, 4))
    log(f"alternate lookup at 720p (Q=14400): against kernel B on the "
        f"float32 pyramid {rel:.3g} of the largest value (tol "
        f"{ALT_LOOKUP_REL}); {alt_ms:.3f} ms a lookup, kernel B {b_ms:.4f} "
        f"ms")
    if not rel <= ALT_LOOKUP_REL:
        raise AssertionError(f"alternate lookup disagrees: {rel}")
    del pyramid, dense, alt

    conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                    "WOFT.py"))
    flower = RaftFlow(conf.flow_config, device=dev)
    template, frames, _ = walk(H_IMG, W_IMG, dev, n=1)
    img1, img2 = (torch.from_numpy(np.ascontiguousarray(f[..., ::-1])).to(
        dev).to(torch.float32)[None] for f in (template, frames[0]))
    flows = {}
    for what, cfg in (("dense", flower.cfg),
                      ("alternate", replace(flower.cfg, alternate_corr=True))):
        flows[what] = time_ms(lambda: weighted_raft_forward(
            flower.model, cfg, img1, img2), iters=3, warmup=1)
    log(f"one 720p flow (v4, 12 iterations, dense head): dense pyramid "
        f"{flows['dense']:.1f} ms, alternate {flows['alternate']:.1f} ms")
    del flower
    torch.cuda.empty_cache()

    h, w = 2160, 3840
    q = (h // 8) * (w // 8)
    dense_bytes = sum(q * (h // 8 >> lvl) * (w // 8 >> lvl) * 4
                      for lvl in range(4))
    res = ablation_walk(dev, "WOFT.py", h, w, kernels=kernels,
                        flow={"alternate_corr": True}, n_frames=2,
                        n_fallback=0)
    report_ablation_walk(res)
    log(f"WOFT.py alternate_corr at {w}x{h}: peak device memory "
        f"{res['peak_gib']:.2f} GiB, where the float32 pyramid alone would "
        f"take {dense_bytes / 1e9:.1f} GB (level 0 "
        f"{q * q * 4 / 1e9:.1f} GB)")
    check_counts(f"WOFT.py alternate_corr at {w}x{h}", res["launches"],
                 {"warp_perspective_bilinear": res["n_frames"]},
                 ("warp_perspective_bilinear",), res["n_frames"],
                 res["n_flows"])
    if not (np.isfinite(res["errs"]).all()
            and max(res["errs"]) <= ALT_4K_CORNER_BOUND_PX):
        raise AssertionError(f"4K alternate track: corner error "
                             f"{max(res['errs']):.3f} px, bound "
                             f"{ALT_4K_CORNER_BOUND_PX}")
    return dict(lookup_rel=rel, lookup_ms=alt_ms, b_ms=b_ms, flows=flows,
                track=res)


def track_flow_family(kernels, corr, dev):
    """The rest of the flow-network family on the card: B on bf16 levels
    (``check_lookup_bf16``); each of ``FAMILY_TRACKS`` (``ablation_walk``,
    counted from 0: A once a frame, B ``FAMILY_B_A_FLOW`` times a flow,
    exactly, nothing else; corners held to ``FAMILY_CORNER_BOUND_PX``
    where the weights are trained; the 'default' track also to WOFT.py's
    float32 track, and traced for its device busy time); the masked
    forward against the CPU path (``check_masked_card_vs_cpu``); the
    per-window batch x8 in bf16 (``track_window_batch``); the alternate
    correlation (``check_alternate``). Returns its numbers."""
    t_phase = time.perf_counter()
    out = {"bf16": check_lookup_bf16(kernels, corr, dev), "tracks": {}}
    for config, h, w, overrides, flow in FAMILY_TRACKS:
        torch.cuda.empty_cache()
        res = ablation_walk(dev, config, h, w, overrides, kernels, flow,
                            profile=True)
        report_ablation_walk(res)
        key = (res["what"], res["frame"])
        per_flow = FAMILY_B_A_FLOW[res["what"]]
        check_counts(f"{res['what']} at {res['frame']}", res["launches"],
                     {"warp_perspective_bilinear": res["n_frames"],
                      "corr_pyramid_lookup": per_flow * res["n_flows"]},
                     ("warp_perspective_bilinear", "corr_pyramid_lookup"),
                     res["n_frames"], res["n_flows"])
        if not all(np.isfinite(H).all() for H in res["hs"]):
            raise AssertionError(f"{key}: non-finite homography")
        n = len(res["frame_ms"])
        for errs, bound, which in zip(
                (res["errs"][:n], res["errs"][n:]),
                FAMILY_CORNER_BOUND_PX.get(key, (None, None)),
                ("the walk", "the fallback frames")):
            if bound is not None and not max(errs) <= bound:
                raise AssertionError(f"{key}: corner error {max(errs):.3f} "
                                     f"px on {which}, bound {bound} px")
        out["tracks"][res["what"]] = res
    fp32 = out["tracks"]["WOFT.py"]
    dflt = out["tracks"]["WOFT.py precision=default"]
    diff = max(h_diff_px(a, b, fp32["corners"])
               for a, b in zip(fp32["hs"], dflt["hs"]))
    log(f"WOFT.py precision=default against float32 on the same frames: "
        f"largest corner distance {diff:.3g} px (tol {DEFAULT_VS_FP32_PX})")
    if not diff <= DEFAULT_VS_FP32_PX:
        raise AssertionError(f"'default' strays from float32: {diff} px")
    out["default_vs_fp32_px"] = diff
    torch.cuda.empty_cache()
    out["masked"] = check_masked_card_vs_cpu(dev)
    torch.cuda.empty_cache()
    out["batch_bf16"] = track_window_batch(kernels, dev, precision="bf16")
    torch.cuda.empty_cache()
    out["alternate"] = check_alternate(kernels, corr, dev)
    log(f"flow-family phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "woft_tpu_torch")):
        print("chip_smoke: woft_tpu_torch not found beside the script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from woft_tpu_torch.device import resolve_device
    from woft_tpu_torch.models import corr
    from woft_tpu_torch.ops import kernels, warp

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    dev = resolve_device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    reports = kernels.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if ("registers" in line or "spill" in line
                    or "error" in line.lower()
                    or "warning" in line.lower()):
                log(f"  {name}: {line.strip()}")

    frame = torch.tensor(textured_frame(H_IMG, W_IMG, seed=3),
                         dtype=torch.float32, device=dev)[None]
    a = check_warp(kernels, warp, frame, dev)
    b = check_lookup(kernels, corr, dev)
    c = check_local_corr(kernels, corr, dev)
    lookups = check_local_lookups(kernels, corr, dev)
    upd = check_update_kernels(kernels, dev)
    torch.cuda.empty_cache()
    canon, canon_ms = track_720p(kernels, dev, "WOFT.py")
    torch.cuda.empty_cache()
    fast, fast_ms = track_720p(kernels, dev, "WOFT_fast.py")
    torch.cuda.empty_cache()
    fused, fused_ms = track_720p(kernels, dev, "WOFT_fast.py", fused=True)
    log(f"steady 720p frame: WOFT.py {sum(canon_ms) / len(canon_ms):.1f} ms, "
        f"WOFT_fast.py {sum(fast_ms) / len(fast_ms):.1f} ms, WOFT_fast.py "
        f"with the fused loop {sum(fused_ms) / len(fused_ms):.1f} ms (host "
        f"clock, {len(fast_ms)} frames each)")
    # the ablation configs: downscaled inputs (RAFT padding, the dense
    # head), IRLS-Huber, and the dense head at full frame
    torch.cuda.empty_cache()
    ablation_shapes, ablations = track_ablations(kernels, corr, warp, dev)
    # the rest of the flow-network family: B on bf16 levels, the 'rep',
    # external, 'orig', 'weighted_masked' and 'default' tracks, the bf16
    # window batch, the alternate correlation at 720p and 4K
    torch.cuda.empty_cache()
    family = track_flow_family(kernels, corr, dev)
    windows = {}
    for what, h, w in WINDOW_TRACKS:
        torch.cuda.empty_cache()
        windows[(what, h)] = track_window(kernels, dev, what, h, w)
    check_guard_on_a_path(kernels, corr, dev)
    check_local_equals_dense_720p(dev)
    check_fused_equals_unfused_720p(dev)
    check_window_local_equals_dense(dev)
    check_window_card_vs_cpu(dev)
    check_window_step_card_vs_cpu(dev)
    check_small_references(dev)

    # multi-target tracking at 1920x1080: A-E at its shapes, then its paths
    torch.cuda.empty_cache()
    multi = check_multi_shapes(kernels, corr, warp, dev)
    torch.cuda.empty_cache()
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow import RaftFlow
    conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                    "WOFT_fast.py"))
    flower = RaftFlow(conf.flow_config, device=dev)
    paths = {}
    paths["shared x8 1920x1080"] = track_shared(
        kernels, dev, flower.model, flower.cfg, conf.tracker_params)
    torch.cuda.empty_cache()
    paths["shared x64 1920x1080"] = track_shared_x64(
        kernels, dev, flower.model, flower.cfg, conf.tracker_params,
        paths["shared x8 1920x1080"])
    del flower
    torch.cuda.empty_cache()
    paths["window batch x8 1920x1080"] = track_window_batch(kernels, dev)

    # launches: A and B on the WOFT.py path, C, D, E (the last two from
    # coordinates) on the WOFT_fast.py
    # path (which launches A too), G and I on the fused WOFT_fast.py path;
    # F and H have no caller on a tracker path, as in the JAX package, and
    # are launched in the kernel phase only
    local_lookup = "woft_tpu_torch/csrc/local_lookup.cu"
    update_tail = "woft_tpu_torch/csrc/update_tail.cu"
    rows = [
        dict(name="warp_perspective_bilinear", route="cuda",
             source="woft_tpu_torch/csrc/warp.cu",
             replaces="woft_tpu/ops/pallas/warp.py:216",
             launches=canon["warp_perspective_bilinear"], **a),
        dict(name="corr_pyramid_lookup", route="cuda",
             source="woft_tpu_torch/csrc/corr_lookup.cu",
             replaces="woft_tpu/ops/pallas/corr_lookup.py:142",
             launches=canon["corr_pyramid_lookup"], **b),
        dict(name="local_corr_build", route="cuda",
             source="woft_tpu_torch/csrc/local_corr.cu",
             replaces="woft_tpu/ops/pallas/local_corr.py:108",
             launches=fast["local_corr_build"], **c),
        dict(name="local_lookup_coords", route="cuda",
             source=local_lookup,
             replaces="woft_tpu/ops/pallas/local_lookup.py:338",
             launches=fast["local_lookup_coords"],
             note="kernel D from coordinates; its explicit-operand entry "
                  "local_lookup_fine_multi shares the body and is checked "
                  "in the kernel phase", **lookups["D"]),
        dict(name="local_lookup_exact_coords", route="cuda",
             source=local_lookup,
             replaces="woft_tpu/ops/pallas/local_lookup.py:393",
             launches=fast["local_lookup_exact_coords"],
             note="kernel E from coordinates; its explicit-start entry "
                  "local_lookup_exact is checked in the kernel phase",
             **lookups["E"]),
        dict(name="local_lookup_fine", route="cuda", source=local_lookup,
             replaces="woft_tpu/ops/pallas/local_lookup.py:143",
             launches=fast["local_lookup_fine"],
             note="no caller on a tracker path, as in the JAX package; "
                  "launched and checked in the kernel phase only",
             **lookups["F"]),
        dict(name="fused_gru_update", route="cuda",
             source="woft_tpu_torch/csrc/gru.cu",
             replaces="woft_tpu/ops/pallas/gru.py:133",
             launches=fused["fused_gru_update"],
             note="times are the mean of the two directions", **upd["G"]),
        dict(name="motion_encoder_tail", route="cuda", source=update_tail,
             replaces="woft_tpu/ops/pallas/update_tail.py:184",
             launches=fused["motion_encoder_tail"],
             note="no caller on a forward path, as in the JAX package; "
                  "launched and checked in the kernel phase only",
             **upd["H"]),
        dict(name="flow_head", route="cuda",
             source="woft_tpu_torch/csrc/flow_head.cu",
             replaces="woft_tpu/ops/pallas/update_tail.py:283",
             launches=fused["flow_head"], **upd["I"]),
    ]
    # the window paths' and the multi-target paths' own runs, each counted
    # from 0 (kernels A-E), and A-E timed at the multi-target shapes
    shapes = {"warp_perspective_bilinear": ("A",),
              "corr_pyramid_lookup": ("B", "B indexed"),
              "local_corr_build": ("C",), "local_lookup_coords": ("D",),
              "local_lookup_exact_coords": ("E",)}
    for row in rows:
        counts = {f"{res['what']} {res['frame']}": res["launches"][row["name"]]
                  for res in windows.values()}
        if any(counts.values()):
            row["window_launches"] = counts
        counts = {what: res["launches"][row["name"]]
                  for what, res in paths.items()}
        if any(counts.values()):
            row["multi_launches"] = counts
        if row["name"] in shapes:
            row["multi_shapes"] = {k: multi[k] for k in shapes[row["name"]]}
        # the ablation paths' runs: the downscale ones, then the others
        counts = {what: res["launches"][row["name"]]
                  for what, res in ablations.items()}
        if any(counts.values()):
            row["downscale_launches"] = {
                k: v for k, v in counts.items() if "downscale" in k}
            row["ablation_launches"] = {
                k: v for k, v in counts.items() if "downscale" not in k}
            row["downscale_shapes"] = {
                k: v for k, v in ablation_shapes.items()
                if k[0] == shapes[row["name"]][0]}
    # B's bf16-level form: launches on the 'default' track (720p, its dense
    # and indexed lookups) and on the bf16 window batch, each counted from 0
    b16 = family["bf16"]
    source_b = "woft_tpu_torch/csrc/corr_lookup.cu"
    rows += [
        dict(name="corr_pyramid_lookup (bf16 levels, 720p)", route="cuda",
             source=source_b,
             replaces="woft_tpu/ops/pallas/corr_lookup.py:142",
             launches=family["tracks"]["WOFT.py precision=default"]
             ["launches"]["corr_pyramid_lookup"],
             note="launches: WOFT.py with precision='default' (bf16 "
                  "pyramid), 12 dense and 1 indexed a flow; times: dense "
                  "Q=14400, the indexed M=4500 form in 'indexed'",
             indexed=b16["B bf16 720p indexed"], **b16["B bf16 720p dense"]),
        dict(name="corr_pyramid_lookup (bf16 levels, 8-window batch)",
             route="cuda", source=source_b,
             replaces="woft_tpu/ops/pallas/corr_lookup.py:142",
             launches=family["batch_bf16"]["launches"]["corr_pyramid_lookup"],
             note="launches: MultiTargetTracker x8 on WOFT_window.py in "
                  "bf16, 8 frames; times: Q=8192",
             **b16["B bf16 8-window batch"]),
    ]
    for row in rows[:2]:        # A and B on the family's tracks
        row["family_launches"] = {
            what: res["launches"][row["name"]]
            for what, res in family["tracks"].items()}
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
