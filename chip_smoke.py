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
   direction, G's float32 form (the canonical float32 route; its
   yardstick the unfused float32 direction), H motion-encoder tail, I flow
   head) against its plain
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
   L (the encoder's instance norm; every call of one feature encoding in
   each benchmark cell's precision and size, and the 13 calls timed),
   M (GMA's aggregation, at the 1080p grid after the shared paths, with
   ``F.scaled_dot_product_attention`` as its library yardstick) and G at
   GMA's 256 motion channels, then ``WOFT_gma_fast.py`` tracked x8 at
   1080p (M 12 launches a flow; every other track holds M at 0),
   B's reads also counted in the 32-byte sectors device memory moves, as
   are D's (the union of each 16-query row's patches), E's bound counting the flagged blocks only; one guarded block-local
   lookup traced with ``torch.profiler``: two kernel launches;
4. track 1280x720 frames through ``WOFTTracker`` with the canonical
   ``configs/WOFT.py``, with ``configs/WOFT_fast.py`` (block-local
   correlation, bf16: the loop's card route, kernels G, H and I), and
   with ``WOFT_fast.py`` plus the fused loop's flags (``gru_fused``,
   ``tail_fused``: the same route on the card); all full-width
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
   correlation (kernel K) against kernel B at 720p, one flow's time beside
   the dense path's, ``WOFT_alternate.py`` at 3840x2160 (2 frames, peak
   memory, K 13 times a flow), one 4K flow through the plain chain and
   through K in turns, and K at the 4K grid against its plain chain and
   its bounds;
   then the window
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
7. evaluation and the entry points (``track_eval_entry``), on textured
   1280x720 bases written to a temporary directory: kernel A in the
   render's one-source, N-homography form (30 frames in one launch)
   against its plain version (exact); ``eval_woft_torch.py``'s synthetic
   eval (``run_synthetic``, 30 frames, the frames rendered on the card) on
   ``WOFT.py`` under the default protocol and ``--stress`` and on
   ``WOFT_fast.py``, each counted from 0 (A once for the render and once
   a frame, B 13 times a flow, or C once and D, E 13 times), its median
   alignment error held to ``EVAL_MEDIAN_BOUND_PX`` (the CPU path's own
   median plus headroom); ``evaluate_pot_sequence`` on ``WOFT.py`` over 10
   jpg frames of a walk and their POT annotation file (9 scored frames);
   ``WOFT_demo_torch.py --headless --max-frames 8`` on that clip with and
   without ``--debug`` (the overlays, the four debug images a frame, 8
   finite H; B 39 times a debug frame, 13 without); ``track_video`` on
   ``WOFT_window.py`` (v5) at 1920x1080 over 16 jpg frames decoded on
   threads, equal to a per-frame loop of the same step (0), ``sync_every``
   1 and 8 equal, the uint8 upload within 1e-6 of float32, with frames/s,
   the decode's ms a frame and the device's idle share;
8. training (``track_training``): kernel B' (the backward of B) against
   its plain version (autograd through the plain lookup) at batch 4 of
   288x384 (Q = 6,912, four levels, radius 4; bf16 and float32 levels;
   windows at integer positions, partly and wholly outside), timed beside
   its byte bound, the plain version and ``F.grid_sample``'s backward;
   A-E and B' at the training shapes against their plain versions (A on
   the trainer's own crops and homographies, four of each in a launch;
   B and B' on the bf16 pyramid of the v4 features of its first pair; C,
   D, E at the 36 x 48 grid);
   ``train_wraft_torch.py``'s ``run`` on WeightedRAFT-large at 288x384,
   batch 4, 12 iterations, 'default', from the v4 export, on 6 textured
   pngs written to a temporary directory: 6 weight-head steps (lr 1e-3;
   finite losses, frozen tensors bit-identical, the head moved), then 6
   whole-net steps (``--train-flow``, lr 1e-5; every parameter moved),
   validation and rolling checkpoints every 3, counted from 0 each (A 1 a
   step and 1 for the validation batch, B 13 a step and 13 a validation,
   B' 13 a whole-net step and none for the head), steady s/step,
   samples/s, peak memory and one traced step's idle share and B, B'
   times; the result tracked under ``WOFT.py`` through
   ``WOFT_WRAFT_TORCH_CKPT`` (4 frames of the 720p walk); the block-local
   gradient at B = 1 (C, D, E forward, their plain VJPs backward) against
   the dense one on every parameter; one weight-head step at 64x96 on the
   card against the CPU path, the difference split into the forward, the
   fit's backward and the head's backward (and the head's ReLU sign
   flips counted);
9. RAFT-small (``check_small_tracking``): kernel B at radius 3 against
   its plain version, dense at Q = 14,400 and on the 24x43 window grid
   (exact), timed beside its bound, its plain version and
   ``F.grid_sample``; ``train_wraft_torch.py --small --train-flow`` from
   seeded weights, 100 steps at 288x384, batch 4, counted from 0; the
   checkpoint served by ``WOFT.py`` with ``class_params.small`` through
   the single step (``WOFTTracker``) and the shared step x2 at 1280x720
   and the window step and the window batch x2 at 1920x1080 (the 192x344
   window), 8 frames of the walk each, run twice: with kernels A, B and
   L, and with their plain versions on the card's tensors
   (``PlainKernels``); H held to ``CORNER_TOL_PX`` where both pass and
   on every frame before the first whose ok flags differ, the ok flags
   to one frame in eight, the TC points whose validity flipped
   counted, launches exact (A, B; L reported; every other kernel 0); the
   corner error against the walk printed and not held (no trained
   RAFT-small weights);
10. scale-out (``track_scale_out``, ``woft_tpu_torch/parallel``): kernels
   C, D and E on rank 1's band of the 720p grid (blocks 60-119, ``b0`` =
   60) against their plain versions and the whole-grid launch's rows, C's
   kept plan not reused at another ``b0``, kernel B on two key-column
   shards with x shifted, the parts' sum against the whole lookup, each
   timed at that shape; NCCL with one rank in this process (a file
   store): an all-reduce, ``sharded_track_batch`` over 2 streams of 8
   frames of the 720p walk under ``WOFT.py`` (each its own target)
   against each stream's ``build_track_step`` (0 px; A once and B 13
   times a stream-frame, exactly), the same over 2 streams of 4 frames on
   the RAFT-small checkpoint, one ``sharded_train_step`` at 288x384,
   batch 4, ``--train-flow`` against the plain step; then two ``gloo``
   ranks both on this card (``parallel.launch``; NCCL refuses two ranks on
   one GPU): 2 x 2 streams, one RAFT-small stream each (0 px),
   ``spatial_sharded_forward`` at sp = 2 in its
   pyramid form (``WOFT.py``) and its block-local form (``WOFT_fast.py``,
   rank 1 launching C, D, E at ``b0`` = 60), and the dp step on 2 x 2
   rows, each against its single-process twin here at a measured bound,
   with targets·frames/s, per-rank volume bytes and memory, all-reduced
   bytes, seconds;
11. a ``kernels`` JSON line (A-E with their launches on the multi-target
   paths and their times at its shapes; A and B also with their launches
   on the ablation paths, ``downscale_launches`` and
   ``ablation_launches``, their times at the downscale shapes, and their
   launches on the flow-family tracks, ``family_launches``; two rows for
   B's bf16-level form; A-E with their launches on the eval and entry
   paths, ``eval_launches``, and A's render form, ``render_shape``; A-E
   with their launches in training, ``train_launches``, and their error
   at its shapes, ``train_max_abs_err``, and the row of B'; A-E and B'
   with their launches in the scale-out runs, ``scale_out_launches``, and
   B-E at the band and shard shapes, ``scale_out_shape``; A and B with
   their launches on the RAFT-small steps, ``small_tracking_launches``, B
   at radius 3, ``radius3``), then the device JSON as the last line.
"""

import contextlib
import json
import logging
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
# J, the weight head's logits: a bf16 activation that rounds the other way
# than in the plain version moves a logit by up to ~1e-5; a quarter of one
# bf16 ulp of the largest logit (2.05e-5 of 0.070 read on the card)
HEAD_J_TOL = BF16_ULP / 4
HEAD_J_ROWS = (4500, 32400)      # WOFT_fast.py at 720p; the 1080p grid, 8 targets
HEAD_J_FLOPS_PER_ROW = 2 * 81 * 128 * (45 + 2 * 9 * 128 + 1)
L2_BYTES_PER_S = 5.5e12          # H100 L2 reads, an estimate (not published)
# G's float32 form sums the same float32 products as its plain version in
# another order and rounds alike: a few float32 ulps of the state
GRU_F32_TOL = 1e-5
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


EVAL_BASES = 3             # 1280x720 base frames of the synthetic evals


def write_eval_bases(directory, h=H_IMG, w=W_IMG):
    """The synthetic evals' base frames: ``EVAL_BASES`` textured frames
    (seeds 10, 11, ...) as lossless pngs in ``directory``, which
    ``eval_woft_torch.py --images`` takes. The card's eval phase and the
    CPU runs that set its bounds read the same files:
    ``python3 -c "import chip_smoke; chip_smoke.write_eval_bases('DIR')"``.
    Returns the paths."""
    from woft_tpu_torch.geometry.homography import _cv2

    os.makedirs(directory, exist_ok=True)
    paths = []
    for i in range(EVAL_BASES):
        paths.append(os.path.join(directory, f"base_{i}.png"))
        if not _cv2("write_eval_bases").imwrite(
                paths[-1], textured_frame(h, w, seed=10 + i)):
            raise OSError(f"cannot write {paths[-1]}")
    return paths


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


def _time_local_corr(kernels, corr, case, dtype, rate, grid, b0=0):
    """Times kernel C on ``case`` (all levels, one launch; its ``f1b`` the
    query blocks from ``b0`` on) beside its plain version, ``torch.bmm`` on
    pre-gathered windows and its bound; logs them and returns the row's
    numbers (``max_abs_err`` left to the caller)."""
    meta, f1b, lvs, geoms = case
    nbh, nbw = meta["nbh"], meta["nbw"]
    nb = f1b.shape[0]
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
            for by, bx in (divmod(b, nbw) for b in range(b0, b0 + nb))
        ]).reshape(nb, -1, f1b.shape[2]))

    f1t = f1b.transpose(1, 2)
    ms = time_ms(lambda: kernels.local_corr_build(f1b, lvs, geoms, nbh,
                                                  nbw, dtype, b0), iters=10)
    plain_ms = time_ms(lambda: [corr.block_local_corr_plain(
        f1b, lv, d, nbh, nbw, dtype, b0)
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


def _compare_coord_lookups(kernels, corr, dev, layouts):
    """Kernels D and E from coordinates against their plain versions at
    each (H1, W1, levels, margin) of ``layouts`` (seeded D = 256 features,
    B = 1), bf16 and float32, on a smooth, a violating and a saturated
    field (the 720p grid: ``_local_coords``): data and flags equal, E
    rewriting exactly the flagged blocks. Returns (the worst error of D
    and of E, the last volumes, the last coordinates)."""
    k = 9
    errs = {"D": 0.0, "E": 0.0}
    for (H1, W1, L, margin) in layouts:
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
    return errs, local, coords


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

    errs, local, coords = _compare_coord_lookups(
        kernels, corr, dev, ((H_IMG // 8, W_IMG // 8, 4, 16),
                             (*WINDOW_GRIDS[0], 4, 16), (*MULTI_GRID, 4, 16),
                             (37, 83, 3, 8)))

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
    b0 = local.b0
    ms = time_ms(lambda: kernels.local_lookup_coords(coords, vols, table, k,
                                                     od, b0))
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
    scratch, bad = kernels.local_lookup_coords(coords, vols, table, k, od,
                                               b0)
    none = torch.zeros_like(bad)
    sel = bad.bool().any(1)
    nf = int(sel.sum().item())
    vq_f = [v[sel].permute(0, 3, 1, 2).reshape(nf * bq, 1, *v.shape[1:3])
            .float() for v in vols]
    s_f, fr_f = starts[:, :, sel].contiguous(), frac[:, :, sel].contiguous()
    scratch_p = scratch.clone()
    ms = time_ms(lambda: kernels.local_lookup_exact_coords(
        coords, vols, table, k, bad=bad, out=scratch, b0=b0))
    ms_none = time_ms(lambda: kernels.local_lookup_exact_coords(
        coords, vols, table, k, bad=none, out=scratch, b0=b0))
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


def update_case(dev, H1=H_IMG // 8, W1=W_IMG // 8):
    """A loop grid (by default 720p's, 90 x 160 cells) of kernels G, H and
    I, with the update block's seeded weights: NCHW maps as the unfused
    path holds them
    (``net``, ``motion``, ``cor1``, ``flo1``, ``flow``), the block ``ub``,
    G's per-direction operands ``gru`` (``fused``: for the kernel, ending in
    the axis; ``unfused``: the unfused path's), channels-minor ``h`` and
    ``x``, and I's taps ``head``."""
    from woft_tpu_torch.models import layers, update
    from woft_tpu_torch.models import raft as traft

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
        case["fused"] = update.LoopRoute("bf16").context(ub.gru, inp)
        case["unfused"] = update.LoopRoute("unfused").context(ub.gru, inp)
    case["h"], case["x"] = update.nhwc(net), update.nhwc(case["motion"])
    case["head"] = update.flow_head_params(ub.flow_head)
    return case


def check_update_kernels(kernels, dev, H1=H_IMG // 8, W1=W_IMG // 8):
    """Kernels G (both directions), H and I against their plain versions at
    a loop grid (by default 720p's, 90 x 160 cells; the 1080p cells'
    135 x 240 are ragged against every tile), with the update block's
    seeded weights. The yardstick of each is the port's own unfused path
    for the same function: several cuDNN and elementwise calls, not one.
    Each is also printed beside its time before the redesign."""
    from woft_tpu_torch.models import layers, update

    log(f"--- kernels G, H, I at the {H1} x {W1} loop grid")
    case = update_case(dev, H1, W1)
    px = H1 * W1
    net, motion, ub = case["net"], case["motion"], case["ub"]
    cor1, flo1, flow = case["cor1"], case["flo1"], case["flow"]
    rows = {}

    def n_bytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def report(name, diff, allowed, kernel_fn, plain_fn, unfused_fn, bnd, by,
               label, max_share=UPDATE_DIFF_SHARE, parent_ms=None,
               precision="bf16"):
        torch.cuda.synchronize()
        share = (diff > 0).float().mean().item()
        worst = (diff / allowed).max().item()
        log(f"kernel {name}: max_abs_err {diff.max().item():.3g}, entries "
            f"that differ {100 * share:.3f} % (tol {100 * max_share:g} %), "
            f"largest difference {worst:.3g} of the tolerance")
        if not (worst <= 1.0 and share <= max_share):
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"version")
        with layers.precision_scope(precision), torch.no_grad():
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
            lambda: update.LoopRoute("unfused").sep_conv_gru(
                net, motion, unfused[d:d + 1]),
            bnd, by, "one unfused SepConvGRU direction (~20 calls)",
            parent_ms=PARENT_GRU_MS[axis]))
    # the main path launches each direction once an iteration: one row with
    # the mean of the two
    rows["G"] = dict(per_dir[0],
                     max_abs_err=max(r["max_abs_err"] for r in per_dir))
    for key in ("ms", "plain_ms", "unfused_ms", "bound_ms"):
        rows["G"][key] = sum(r[key] for r in per_dir) / len(per_dir)

    # G's float32 form (the canonical float32 route), each direction: its
    # yardstick is the unfused float32 direction it replaces (two cuDNN
    # convolutions and the elementwise chain)
    motion32 = case["motion"].float()
    x32 = update.nhwc(motion32)
    with layers.precision_scope("highest"), torch.no_grad():
        inp32 = torch.relu(torch.randn(net.shape, device=dev,
                                       generator=torch.Generator(
                                           device=dev).manual_seed(12)))
        f32 = update.LoopRoute("f32").context(ub.gru, inp32)
        unfused32 = update.LoopRoute("unfused").context(ub.gru, inp32)
    per_dir = []
    for d, args in enumerate(f32):
        axis = args[-1]
        with torch.no_grad():
            got = kernels.fused_gru_update_f32(h, x32, *args)
            want = update.gru_update_f32_plain(h, x32, *args)
        bnd, by = bound_ms(n_bytes(h, x32, *args[:-1]) + n_bytes(got),
                           g_flops, FP32_FLOPS)
        per_dir.append(report(
            f"G float32 [{axis}]", (got - want).abs(),
            torch.full_like(want, GRU_F32_TOL),
            lambda: kernels.fused_gru_update_f32(h, x32, *args),
            lambda: update.gru_update_f32_plain(h, x32, *args),
            lambda: update.LoopRoute("unfused").sep_conv_gru(
                net, motion32, unfused32[d:d + 1]),
            bnd, by, "one unfused float32 SepConvGRU direction (~14 "
            "calls)", max_share=1.0, precision="highest"))
        per_dir[-1]["axis"] = axis
    rows["G (float32)"] = dict(per_dir[0], per_direction=per_dir,
                               max_abs_err=max(r["max_abs_err"]
                                               for r in per_dir))
    for key in ("ms", "plain_ms", "unfused_ms", "bound_ms"):
        rows["G (float32)"][key] = sum(r[key] for r in per_dir) / len(per_dir)

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


def check_weight_head(kernels, dev):
    """Kernel J, the bf16 weight head, against its plain version and a
    float64 evaluation at the same rounding points, with the unfused cuDNN
    chain it replaces beside it, at the rows of ``WOFT_fast.py`` at 720p
    (4,500) and of the 1080p grid (32,400), on the seeded head. Bounds: the
    operations at the bf16 peak, and the taps' L2 bytes (590 KB a pair of
    rows) at ``L2_BYTES_PER_S``."""
    from woft_tpu_torch.models import layers
    from woft_tpu_torch.models import raft as traft
    from woft_tpu_torch.models import weight_head as whead

    head = traft.init_raft_params(traft.RaftConfig(precision="bf16"),
                                  seed=0, device=dev).weight_head
    taps, consts = whead.head_params(head)
    out = {}
    for M in HEAD_J_ROWS:
        g = torch.Generator(device=dev).manual_seed(M)
        corr = (2.0 * torch.randn(M, 324, device=dev, generator=g)).bfloat16()
        mean = torch.randn(M, device=dev, generator=g)
        cs, mr = corr.reshape(1, 1, M, 9, 9, 4), mean.reshape(1, 1, M)

        def kernel():
            return kernels.weight_head(corr, mean, taps, consts)

        def plain():
            return whead.weight_head_plain(corr, mean, taps, consts)

        def chain():
            with layers.precision_scope("bf16"):
                return traft.weight_head_chain(head, cs, mr)

        with torch.no_grad():
            n0 = kernels.weight_head.launches
            got = kernel()
            torch.cuda.synchronize()
            if kernels.weight_head.launches != n0 + 1:
                raise AssertionError("kernel J: not one launch a call")
            want = plain()
            f64 = whead.weight_head_plain(corr, mean, taps, consts,
                                          dtype=torch.float64)
            lib = chain().reshape(M)
            gap_j = (got.double() - f64).abs()
            gap_lib = (lib.double() - f64).abs()
            diff = (got - want).abs().max().item()
            scale = want.abs().max().item()
            log(f"kernel J, M={M}: max_abs_err {diff:.3g} against the plain "
                f"version (tol {HEAD_J_TOL * scale:.3g}); from float64: J "
                f"median {gap_j.median().item():.3g}, largest "
                f"{gap_j.max().item():.3g}; cuDNN chain median "
                f"{gap_lib.median().item():.3g}, largest "
                f"{gap_lib.max().item():.3g}")
            if not diff <= HEAD_J_TOL * scale:
                raise AssertionError("kernel J disagrees with its plain "
                                     "version")
            ms = time_ms(kernel)
            plain_ms = time_ms(plain, iters=3, warmup=1)
            library_ms = time_ms(chain, iters=5, warmup=1)
        flops = HEAD_J_FLOPS_PER_ROW * M
        ops_ms = flops / BF16_FLOPS * 1e3
        tap_bytes = (M + 1) // 2 * 37 * 128 * 64 * 2   # 37 boxes a pair
        l2_ms = tap_bytes / L2_BYTES_PER_S * 1e3
        log(f"kernel J timing, M={M}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"the unfused cuDNN chain {library_ms:.4f} ms, bound "
            f"{ops_ms:.4f} ms (operations; the taps' {tap_bytes / 1e9:.2f} "
            f"GB from L2 {l2_ms:.4f} ms)")
        out[M] = dict(max_abs_err=diff, ms=ms, plain_ms=plain_ms,
                      bound_ms=ops_ms, bound_by="operations",
                      l2_tap_bytes=tap_bytes, l2_ms=l2_ms,
                      library_ms=library_ms,
                      library_is="the unfused cuDNN chain (weight_head_chain)",
                      f64_median=gap_j.median().item(),
                      f64_max=gap_j.max().item(),
                      library_f64_median=gap_lib.median().item(),
                      library_f64_max=gap_lib.max().item())
    return dict(out[HEAD_J_ROWS[1]], rows_4500=out[HEAD_J_ROWS[0]])


# Kernel L sums each plane's statistics in another order than PyTorch's
# batch-norm kernels: in float32 a few ulps of the largest normalised value;
# in bf16 each rounding (the normalised value, the shortcut's, the sum: one
# ulp each of the largest of them, at a tie to even) may fall the other way
# on a small share of entries, and a value near 0, where x - mean cancels,
# may move by the float32 gap
NORM_F32_REL = 1e-5
NORM_BF16_ULPS = {"relu": 1, "residual": 2, "shortcut": 3}
NORM_BF16_SHARE = 1e-3
NORM_LAUNCHES = 27      # one RAFT-large feature encoding: the stem's 3, 2
#                         each for the other 12 calls
# the feature encoder's input in the three benchmark cells
NORM_CELLS = (("720p float32", 720, 1280, torch.float32),
              ("1080p bf16", 1080, 1920, torch.bfloat16),
              ("2160p float32", 2160, 3840, torch.float32))


def encoder_norm_calls(h, w):
    """Kernel L's calls in one RAFT-large feature encoding of an (h, w)
    image: (channels, rows, columns, mode) with mode 'relu', 'residual' or
    'shortcut', in order: the stem, then two calls a residual block."""
    calls = [(64, h // 2, w // 2, "relu")]
    for planes, div, stride in ((64, 2, 1), (96, 4, 2), (128, 8, 2)):
        for first in (True, False):
            end = "shortcut" if first and stride == 2 else "residual"
            calls += [(planes, h // div, w // div, "relu"),
                      (planes, h // div, w // div, end)]
    return calls


def _norm_inputs(shape, dtype, dev, seed):
    """Two convolution-like maps of ``shape`` (each plane its own offset
    and scale: a block's and its shortcut's), a block input (after a ReLU)
    and the two convolutions' biases."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n, c = shape[:2]
    scale = torch.rand(n, c, 1, 1, device=dev, generator=g) * 2.8 + 0.2
    offset = torch.rand(n, c, 1, 1, device=dev, generator=g) * 6 - 3
    x = torch.randn(shape, device=dev, generator=g) * scale + offset
    sc = torch.randn(shape, device=dev, generator=g) * scale - offset
    r = torch.randn(shape, device=dev, generator=g).relu()
    b, sb = torch.randn(2, c, device=dev, generator=g)
    return tuple(t.to(dtype) for t in (x, sc, r, b, sb))


def _norm_kwargs(mode, sc, r, b, sb):
    """Kernel L's keywords for a call of ``mode`` (biases None: none)."""
    kw = {"relu": {}, "residual": {"residual": r},
          "shortcut": {"shortcut": sc, "shortcut_bias": sb}}[mode]
    return dict(kw, bias=b)


def norm_gap(got, want, y, ulps):
    """(largest gap over the largest value, share of entries that differ,
    entries beyond ``ulps`` bf16 ulps of the largest of the two and of
    ``y``, the normalised x, plus the float32 tolerance)."""
    d = (got.float() - want.float()).abs()
    scale = want.float().abs().max().clamp(min=1e-30)
    top = torch.ldexp(torch.ones_like(d), torch.frexp(torch.maximum(
        torch.maximum(got.float().abs(), want.float().abs()),
        y.float().abs()))[1])
    allowed = ulps * BF16_ULP * top + NORM_F32_REL * scale
    return ((d.max() / scale).item(), (d > 0).float().mean().item(),
            int((d > allowed).sum().item()))


def check_norm_case(kernels, x, mode, kw, launches=2):
    """Kernel L against its plain version on one call of ``mode`` with the
    keywords ``kw``: float32 within ``NORM_F32_REL`` of the largest value,
    bf16 within ``NORM_BF16_ULPS`` (and that tolerance) and differing on at
    most ``NORM_BF16_SHARE`` of the entries. Returns ``norm_gap``'s
    numbers."""
    n0 = kernels.instance_norm_act.launches
    got = kernels.instance_norm_act(x, **kw)
    torch.cuda.synchronize()
    if kernels.instance_norm_act.launches != n0 + launches:
        raise AssertionError(f"kernel L: not {launches} launches a call")
    want = kernels.instance_norm_act_plain(x, **kw)
    y = kernels.instance_norm_act_plain(x, bias=kw["bias"])
    rel, share, beyond = norm_gap(got, want, y, NORM_BF16_ULPS[mode])
    ok = (rel <= NORM_F32_REL if x.dtype == torch.float32
          else beyond == 0 and share <= NORM_BF16_SHARE)
    if not ok:
        raise AssertionError(
            f"kernel L, {tuple(x.shape)} {x.dtype} {mode}: {rel:.3g} of the "
            f"largest value, {share:.3g} of the entries differ, {beyond} "
            f"beyond {NORM_BF16_ULPS[mode]} bf16 ulps")
    return rel, share


def check_instance_norm(kernels, dev):
    """Kernel L against its plain version at every call of one feature
    encoding in the three cells (720p float32, 1080p bf16, 3840x2160
    float32; each with its convolution's bias, as on the main path) and at
    an odd shape (the scalar loads; with and without biases), then one
    encoding's 13 calls timed: the kernel, its plain version (the module
    path's bias add, norm, ReLU, add and ReLU), the library chain
    (``F.instance_norm`` + ``F.relu`` for each call, no bias and no add: a
    yardstick the port never calls) and the bytes bound (each input map
    read once, the output written once). Inputs repeat across the timed
    calls, so what fits the 50 MB L2 may be read from it. Returns the
    numbers by cell."""
    out = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            x, sc, r, b, sb = _norm_inputs((2, 3, 37, 53), dtype, dev, seed=1)
            for mode in NORM_BF16_ULPS:
                for biases in ((None, None), (b, sb)):
                    rel, share = check_norm_case(
                        kernels, x, mode, _norm_kwargs(mode, sc, r, *biases))
                    log(f"kernel L, (2, 3, 37, 53) {dtype} {mode}, bias "
                        f"{biases[0] is not None}: {rel:.3g} of the largest "
                        f"value, {share:.3g} of entries differ")
        for cell, h, w, dtype in NORM_CELLS:
            calls = encoder_norm_calls(h, w)
            maps = {}
            for c, hh, ww, _ in calls:
                if (c, hh, ww) not in maps:
                    maps[c, hh, ww] = _norm_inputs((1, c, hh, ww), dtype, dev,
                                                   seed=c)
            args = [(maps[c, hh, ww][0],
                     _norm_kwargs(mode, *maps[c, hh, ww][1:]), mode)
                    for c, hh, ww, mode in calls]
            # the stem's input has the channels-last strides of the
            # convolution of an NHWC image: L's three-launch form
            stem = args[0][0].contiguous(memory_format=torch.channels_last)
            args[0] = (stem,) + args[0][1:]
            worst = [0.0, 0.0]
            for i, (x, kw, mode) in enumerate(args):
                rel, share = check_norm_case(kernels, x, mode, kw,
                                             3 if i == 0 else 2)
                worst = [max(worst[0], rel), max(worst[1], share)]

            def kernel():
                for x, kw, _ in args:
                    kernels.instance_norm_act(x, **kw)

            def plain():
                for x, kw, _ in args:
                    kernels.instance_norm_act_plain(x, **kw)

            def library():
                for x, _, _ in args:
                    F.relu(F.instance_norm(x))

            n_bytes = sum(x.numel() * x.element_size() * (2 + (m != "relu"))
                          for x, _, m in args)
            bound = n_bytes / HBM_BYTES_PER_S * 1e3
            ms = time_ms(kernel, iters=10)
            plain_ms = time_ms(plain, iters=10)
            library_ms = time_ms(library, iters=10)
            big, big_kw = args[0][:2]
            big_ms = time_ms(lambda: kernels.instance_norm_act(big, **big_kw),
                             iters=10)
            big_bound = 2 * big.numel() * big.element_size() / \
                HBM_BYTES_PER_S * 1e3
            log(f"kernel L, {cell}: {len(calls)} calls of one encoding, "
                f"largest gap {worst[0]:.3g} of the largest value, at most "
                f"{worst[1]:.3g} of entries differ; kernel {ms:.4f} ms, "
                f"bound {bound:.4f} ms ({n_bytes / 1e9:.3f} GB), plain "
                f"{plain_ms:.4f} ms, library chain {library_ms:.4f} ms; the "
                f"stem's norm {tuple(big.shape)}: {big_ms:.4f} ms against "
                f"{big_bound:.4f} (channels-last, its three launches)")
            out[cell] = dict(max_rel=worst[0], diff_share=worst[1], ms=ms,
                             bound_ms=bound, bound_by="bytes",
                             plain_ms=plain_ms, library_ms=library_ms,
                             stem_ms=big_ms, stem_bound_ms=big_bound)
            del maps, args
            torch.cuda.empty_cache()
    return out


SOBOL_LAUNCHES = 2      # kernel N: the tiles' counts, then the select pass
# kernel N's cells: the shared cells' eight targets at 1080p (the grid of
# shared_masks), one target at 720p and at 3840x2160 (the centred box)
SOBOL_CELLS = (("1080p x8", 1080, 1920, 8), ("720p x1", 720, 1280, 1),
               ("2160p x1", 2160, 3840, 1))


def sobol_gather_flat(valid, n=500):
    """``masked_sobol_gather_plain`` on an (N, P) batch with its running
    count taken over the batch as one row, which PyTorch scans with CUB's
    device-wide scan, less each row's offset: the plain alternative to
    kernel N, timed beside it. Equal to the plain version at every slot."""
    from woft_tpu_torch.ops import sampling

    N, P = valid.shape
    cs = torch.cumsum(valid.reshape(-1).to(torch.int64), 0).reshape(N, P)
    ends = cs[:, -1:]
    n_valid = torch.diff(ends, dim=0, prepend=torch.zeros_like(ends[:1]))
    cs = cs - (ends - n_valid)
    sobol = sampling._sobol_on(n, valid.device)
    sub = torch.round(n_valid.to(torch.float32) * sobol).to(torch.int64)
    sub, _ = torch.sort(sub, dim=-1)
    dup = torch.cat([torch.zeros_like(sub[:, :1], dtype=torch.bool),
                     sub[:, 1:] == sub[:, :-1]], dim=-1)
    first = torch.arange(n, device=valid.device)
    use_sub = n_valid > n
    targets = torch.where(use_sub, sub, first)
    sel = torch.where(use_sub, ~dup, first < n_valid) & (targets < n_valid)
    idx = torch.searchsorted(cs, targets + 1, side="left")
    return idx.clamp(0, P - 1), sel


def check_sobol_select(kernels, dev):
    """Kernel N against its plain version at the three cells' selections
    (each target's box, less a seeded tenth of its slots as the flow's
    validity would, every index and flag equal), then timed: the kernel,
    its plain version (the int64 cumsum, sort and searchsorted it
    replaces), the same with one scan over the batch as a row
    (``sobol_gather_flat``) and the bytes bound (the mask read once, the
    outputs written once). No single PyTorch call selects. The mask
    repeats across the timed calls, so it may be read from the 50 MB L2,
    as on the path, where the selection reads the mask the step has just
    written. Returns the numbers by cell."""
    from woft_tpu_torch.ops import sampling

    out = {}
    g = torch.Generator(device=dev).manual_seed(29)
    for cell, h, w, n_t in SOBOL_CELLS:
        boxes = (shared_masks(n_t, h, w) if n_t > 1
                 else centred_mask(h, w, 0.5)[0][None])
        valid = torch.from_numpy(boxes).to(dev).reshape(n_t, h * w)
        valid &= torch.rand(valid.shape, generator=g, device=dev) >= 0.1
        n0 = kernels.masked_sobol_select.launches
        idx, sel = sampling.masked_sobol_gather(valid, 500)
        torch.cuda.synchronize()
        if kernels.masked_sobol_select.launches != n0 + SOBOL_LAUNCHES:
            raise AssertionError(f"kernel N, {cell}: not two launches")
        want_idx, want_sel = sampling.masked_sobol_gather_plain(valid, 500)
        if not (torch.equal(idx, want_idx) and torch.equal(sel, want_sel)):
            raise AssertionError(f"kernel N, {cell}: differs from its plain "
                                 f"version")
        flat_idx, flat_sel = sobol_gather_flat(valid, 500)
        if not (torch.equal(flat_idx, want_idx)
                and torch.equal(flat_sel, want_sel)):
            raise AssertionError(f"{cell}: the one-row scan differs from "
                                 f"the plain version")
        ms = time_ms(lambda: sampling.masked_sobol_gather(valid, 500))
        plain_ms = time_ms(
            lambda: sampling.masked_sobol_gather_plain(valid, 500))
        flat_ms = time_ms(lambda: sobol_gather_flat(valid, 500))
        n_bytes = valid.numel() + 9 * idx.numel()
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        log(f"kernel N, {cell} ({n_t} x {h * w} slots, n = 500): exact; "
            f"kernel {ms:.4f} ms, bound {bound:.4f} ms ({n_bytes / 1e6:.2f} "
            f"MB), plain {plain_ms:.4f} ms, plain with one scan over the "
            f"batch {flat_ms:.4f} ms")
        out[cell] = dict(max_abs_err=0, ms=ms, bound_ms=bound,
                         bound_by="bytes", plain_ms=plain_ms,
                         flat_ms=flat_ms, library_ms=None)
    return out


COUNTED = ("warp_perspective_bilinear", "corr_pyramid_lookup",
           "corr_pyramid_lookup_backward", "local_corr_build",
           "local_lookup_coords", "local_lookup_exact_coords",
           "local_lookup_fine_multi",
           "local_lookup_exact", "local_lookup_fine", "fused_gru_update",
           "fused_gru_update_f32", "motion_encoder_tail", "flow_head",
           "weight_head", "alt_corr_lookup", "instance_norm_act",
           "gma_aggregate", "masked_sobol_select")
# G's float32 form runs in every float32 forward of RAFT-large on one frame
# pair, J in every bf16 weight head on the card, L (27 launches) in every
# RAFT-large feature encoding that records no gradient, N (2 launches) in
# every Sobol selection of TCs on the card; a track checks their counts
# where it names them (track_720p, the shared tracks), the others report
# them unchecked. G, H and I (every bf16 forward of one frame pair on the card)
# are checked on every track: 0 where it does not name them
UPDATE_KERNELS = ("fused_gru_update", "motion_encoder_tail", "flow_head")
UNCHECKED = ("fused_gru_update_f32", "weight_head", "instance_norm_act",
             "masked_sobol_select")
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


def update_launches(bf16, n_flows):
    """G's, H's and I's launches in ``n_flows`` forwards of one frame pair
    on the card, 12 iterations each: G twice, H and I once an iteration in
    bf16 mode; none in float32 (nor in a batch: pass ``bf16=False``)."""
    per_iter = (2, 1, 1) if bf16 else (0, 0, 0)
    return {k: 12 * n * n_flows for k, n in zip(UPDATE_KERNELS, per_iter)}


def check_counts(what, launches, want, exact=(), n_frames=0, n_flows=0):
    """``want``: launches expected of each counted wrapper (others 0); at
    least that many, or exactly for the names in ``exact``."""
    want = {**dict.fromkeys(COUNTED, 0), **dict.fromkeys(UNCHECKED), **want}
    for name, n in want.items():
        if n is None:
            continue
        if (launches[name] < n or (n == 0 and launches[name])
                or (name in exact and launches[name] != n)):
            least = "at least " if n and name not in exact else ""
            raise AssertionError(f"{what}: {name} launched {launches[name]} "
                                 f"times, expected {least}{n} ({n_frames} "
                                 f"frames, {n_flows} flows)")


def track_720p(kernels, dev, config, fused=False):
    """A main path: ``WOFTTracker`` at 1280x720 through ``configs/<config>``
    (``WOFT.py``: dense pyramid, float32; ``WOFT_fast.py``: block-local
    volume, bf16, the loop's card route, kernels G, H and I; ``fused``:
    with the fused loop's flags too, which change nothing on the card), on
    the trained full-frame weights the configs load. Returns the launch
    counts of the run and its steady frame times."""
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
    # from the coordinates; the explicit-operand forms stay idle; the bf16
    # loop launches G once a direction, H and I once, every iteration, with
    # or without the flags; the float32 loop none of them
    want = {"warp_perspective_bilinear": n_frames}
    if fast:
        want.update(local_corr_build=n_flows,
                    local_lookup_coords=13 * n_flows,
                    local_lookup_exact_coords=13 * n_flows)
    else:
        want.update(corr_pyramid_lookup=13 * n_flows)
    want.update(update_launches(conf.flow_config.precision == "bf16",
                                n_flows))
    # G's float32 form: once a direction every iteration of a float32 flow
    # (WOFT.py), never in bf16 mode; J: the bf16 weight head, at least once
    # a frame (the main step's), never in float32
    want.update(fused_gru_update_f32=0 if fast else 2 * 12 * n_flows,
                weight_head=len(frames) if fast else 0)
    # L: 27 launches an encoding, one encoding a flow at least (the
    # templates' besides)
    want["instance_norm_act"] = NORM_LAUNCHES * n_flows
    # N: one selection a flow's fit (the main step's and the fallback's),
    # two launches each
    want["masked_sobol_select"] = SOBOL_LAUNCHES * n_flows
    if launches["instance_norm_act"] % NORM_LAUNCHES:
        raise AssertionError(f"{config}: kernel L launched "
                             f"{launches['instance_norm_act']} times, not "
                             f"{NORM_LAUNCHES} an encoding")
    # C, D and E: exactly one launch a flow and a lookup
    exact = (("local_corr_build", "local_lookup_coords",
              "local_lookup_exact_coords") if fast else ())
    exact += ("fused_gru_update_f32", "masked_sobol_select", *UPDATE_KERNELS)
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
    # the window step is bf16: the loop's card route (G, H, I)
    want.update(update_launches(what == "window_step", n_flows))
    exact += UPDATE_KERNELS
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


@contextlib.contextmanager
def unfused_loop():
    """The bf16 loop's unfused route on the card: the route's card
    predicate answers no inside the block (the comparison's other side)."""
    from woft_tpu_torch.models import update

    on_card = update._on_card
    update._on_card = lambda *tensors: False
    try:
        yield
    finally:
        update._on_card = on_card


def check_fused_equals_unfused_720p(dev):
    """The fused refinement loop (the card's bf16 route: G, H, I) against
    the unfused one at 1280x720 in bf16, full width, on the card. Both
    round at bf16 but not at the very same places (the unfused path rounds
    a bias before its bf16 convolution, and cuDNN sums in its own order),
    so they agree to bf16 rounding noise over 12 iterations."""
    from woft_tpu_torch.models.raft import (RaftConfig, init_raft_params,
                                            weighted_raft_forward)

    img1 = torch.tensor(textured_frame(H_IMG, W_IMG, seed=9),
                        dtype=torch.float32, device=dev)[None]
    img2 = torch.roll(img1, shifts=(3, -5), dims=(1, 2))
    base = RaftConfig(corr_impl="local", precision="bf16")
    model = init_raft_params(base, seed=0, device=dev)
    with unfused_loop():
        unfused = weighted_raft_forward(model, base, img1, img2)
    fused = weighted_raft_forward(model, base, img1, img2)
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
    # J once a frame: 8 targets ask for more rows than the grid has, so the
    # head runs once over every cell; N once a frame for the 8 targets'
    # selections (one group of fits)
    check_counts(f"shared x{n}", launches, {
        "warp_perspective_bilinear": T, "local_corr_build": T,
        "local_lookup_coords": 13 * T, "local_lookup_exact_coords": 13 * T,
        "weight_head": T, "masked_sobol_select": SOBOL_LAUNCHES * T,
        **update_launches(True, T)},
        ("warp_perspective_bilinear", "local_corr_build",
         "local_lookup_coords", "local_lookup_exact_coords", "weight_head",
         "masked_sobol_select", *UPDATE_KERNELS), T, T)
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
        "local_lookup_coords": 52, "local_lookup_exact_coords": 52,
        "masked_sobol_select": SOBOL_LAUNCHES * 4,
        **update_launches(True, 4)},
        ("warp_perspective_bilinear", "local_corr_build",
         "local_lookup_coords", "local_lookup_exact_coords",
         "masked_sobol_select", *UPDATE_KERNELS), 4, 4)
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


GMA_SHARED_CORNER_BOUND_PX = MULTI_CORNER_BOUND_PX


def check_gma_kernels(kernels, dev, H1=MULTI_H // 8, W1=MULTI_W // 8):
    """GMA's kernels at the 1080p loop grid (135 x 240 cells, N = 32,400):
    kernel M against its plain version (the first 128 channels mf bit for
    bit, the aggregated ones within one bf16 ulp plus gamma times the
    largest |v| times (N / 16 + 1) 2^-23, the tensor cores' truncating
    sums, at most 2 % differing)
    and timed beside its plain version, the library's attention of the
    same shape (``F.scaled_dot_product_attention``, bf16, one head of 128:
    scores recomputed from q and k, which M reads stored) and its bound
    (the product's operations at the bf16 peak; the least bytes, v read,
    mf_g written, q and k read once, take less); kernel G at GMA's 256
    motion channels against its plain version, each direction. Returns
    {"M": row, "G (x = 256)": row}."""
    from woft_tpu_torch.models import gma, layers, update
    from woft_tpu_torch.models import raft as traft

    N = H1 * W1
    log(f"--- GMA's kernels at the {H1} x {W1} loop grid (N = {N})")
    g = torch.Generator(device=dev).manual_seed(41)
    att, agg = gma.Attention().to(dev), gma.Aggregate().to(dev)
    with torch.no_grad():
        agg.gamma.fill_(3.0)
        inp = torch.relu(torch.randn(1, 128, H1, W1, device=dev, generator=g))
        mf = torch.relu(torch.randn(N, 128, device=dev, generator=g)).bfloat16()
        with layers.precision_scope("bf16"):
            t0 = time.perf_counter()
            attn = gma.template_attention(att, inp)[0]
            torch.cuda.synchronize()
            build_ms = (time.perf_counter() - t0) * 1e3
            vt = gma.value_t(agg, mf)
        got = kernels.gma_aggregate(attn, vt, mf, agg.gamma)
        want = gma.gma_aggregate_plain(attn, vt, mf, agg.gamma)
        torch.cuda.synchronize()
        if not torch.equal(got[:, :128], mf):
            raise AssertionError("kernel M: the first 128 channels are not mf")
        diff = (got[:, 128:].float() - want[:, 128:].float()).abs()
        share = (diff > 0).float().mean().item()
        # one bf16 ulp (2^-7 of the result's magnitude at most), and the
        # tensor cores' truncating float32 sums (up to an ulp a k16 step),
        # which show where mf + gamma * out cancels
        allowed = (2 * BF16_ULP * want[:, 128:].float().abs()
                   + (N // 16 + 1) * 2.0 ** -23 * 3.0
                   * vt.float().abs().max())
        if not ((diff <= allowed).all() and share <= UPDATE_DIFF_SHARE):
            raise AssertionError("kernel M disagrees with its plain version")
        ms = time_ms(lambda: kernels.gma_aggregate(attn, vt, mf, agg.gamma))
        plain_ms = time_ms(lambda: gma.gma_aggregate_plain(
            attn, vt, mf, agg.gamma), iters=3, warmup=1)
        q, k, v = (torch.randn(1, 1, N, 128, device=dev, generator=g)
                   .bfloat16() for _ in range(3))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                             iters=10)
        bnd, by = bound_ms(4 * N * 128 * 2, 2 * N * N * 128, BF16_FLOPS)
        read_ms = attn.shape[0] * attn.stride(0) * 2 / HBM_BYTES_PER_S * 1e3
    log(f"kernel M: max_abs_err {diff.max().item():.3g}, entries that "
        f"differ {100 * share:.3f} %; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, F.scaled_dot_product_attention {library_ms:.4f} "
        f"ms, bound {bnd:.4f} ms ({by}), {100 * bnd / ms:.1f} % of it; "
        f"reading the stored bf16 attention takes {read_ms:.4f} ms at HBM "
        f"bandwidth; the template's attention built in {build_ms:.1f} ms")
    rows = {"M": dict(max_abs_err=diff.max().item(), ms=ms,
                      plain_ms=plain_ms, library_ms=library_ms,
                      library_is="F.scaled_dot_product_attention, bf16, 1 "
                                 "head of 128",
                      bound_ms=bnd, bound_by=by, attention_read_ms=read_ms,
                      template_attention_ms=build_ms)}
    del attn, want, got
    torch.cuda.empty_cache()

    cfg = traft.RaftConfig(precision="bf16", gma=True)
    ub = traft.init_raft_params(cfg, seed=0, device=dev).update_block
    h = torch.tanh(torch.randn(1, H1, W1, 128, device=dev, generator=g))
    x = torch.relu(torch.randn(1, H1, W1, 256, device=dev,
                               generator=g)).bfloat16()
    with layers.precision_scope("bf16"), torch.no_grad():
        ctx = update.LoopRoute("bf16").context(
            ub.gru, torch.relu(torch.randn(1, 128, H1, W1, device=dev,
                                           generator=g)))
        per_dir = {}
        for args in ctx:
            got = kernels.fused_gru_update(h, x, *args)
            want = update.gru_update_plain(h, x, *args)
            diff = (got - want).abs()
            share = (diff > 1e-6).float().mean().item()
            if not ((diff <= GRU_TOL_ULPS * BF16_ULP * h.abs().clamp(min=1.0))
                    .all() and share <= UPDATE_DIFF_SHARE):
                raise AssertionError("kernel G at 256 motion channels "
                                     "disagrees with its plain version")
            per_dir[args[-1]] = dict(
                max_abs_err=diff.max().item(),
                ms=time_ms(lambda: kernels.fused_gru_update(h, x, *args)))
    bnd, by = bound_ms(0, 2 * N * 5 * 384 * (256 + 128), BF16_FLOPS)
    log("kernel G at 256 motion channels: " + ", ".join(
        f"[{a}] {r['ms']:.4f} ms (max_abs_err {r['max_abs_err']:.3g})"
        for a, r in per_dir.items()) + f"; bound {bnd:.4f} ms ({by})")
    rows["G (x = 256)"] = dict(per_direction=per_dir, bound_ms=bnd,
                               bound_by=by)
    return rows


def track_shared_gma(kernels, dev):
    """Shared-flow multi-target tracking at 1920x1080 on
    ``WOFT_gma_fast.py`` (GMA: the trained v4 weights with its additions
    drawn from their seed): 8 frames of the walk, 8 targets, counted from
    0: M 12 times a flow (inside the loop's graph after the first), G 24,
    H and I 12, C once, J once; every target passes its check on every
    frame, its corners within ``GMA_SHARED_CORNER_BOUND_PX`` of the walk.
    Returns the path's numbers."""
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow import RaftFlow
    from woft_tpu_torch.pipeline import SharedMultiTracker

    conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                    "WOFT_gma_fast.py"))
    flower = RaftFlow(conf.flow_config, device=dev)
    template, frames, poses = walk(MULTI_H, MULTI_W, dev)
    masks = shared_masks(8)
    n = len(masks)
    log(f"--- shared flow x{n} at {MULTI_W}x{MULTI_H}: WOFT_gma_fast.py")
    torch.cuda.synchronize()
    zero_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    tracker = SharedMultiTracker(flower.model, flower.cfg,
                                 conf.tracker_params, device=dev)
    t0 = time.perf_counter()
    tracker.init(template, masks)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
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
    check_counts(f"shared GMA x{n}", launches, {
        "warp_perspective_bilinear": T, "local_corr_build": T,
        "local_lookup_coords": 13 * T, "local_lookup_exact_coords": 13 * T,
        "weight_head": T, "gma_aggregate": 12 * T,
        "masked_sobol_select": SOBOL_LAUNCHES * T,
        **update_launches(True, T)},
        ("warp_perspective_bilinear", "local_corr_build", "weight_head",
         "gma_aggregate", "masked_sobol_select", *UPDATE_KERNELS), T, T)
    errs = _report_multi(f"shared GMA x{n}", n, frame_ms, hs, poses, masks,
                         oks, GMA_SHARED_CORNER_BOUND_PX)
    log(f"shared GMA x{n}: init (the template's features and attention) "
        f"{init_ms:.1f} ms; peak device memory {peak:.2f} GiB")
    return dict(launches=launches, frame_ms=sum(frame_ms[1:]) / (T - 1),
                init_ms=init_ms, peak_gib=peak, errs=errs)


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
        "warp_perspective_bilinear": 2 * T + n, "corr_pyramid_lookup": 13 * T,
        **update_launches(False, T)},
        ("warp_perspective_bilinear", "corr_pyramid_lookup",
         *UPDATE_KERNELS), T, T)
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


@contextlib.contextmanager
def plain_alternate():
    """The alternate lookup's plain chain on the card: kernel K's launch
    is the plain chain inside the block (the comparison's other side)."""
    from woft_tpu_torch.models import corr

    launch = corr._alt_lookup_launch
    corr._alt_lookup_launch = corr._alt_lookup_plain
    try:
        yield
    finally:
        corr._alt_lookup_launch = launch


def check_alternate(kernels, corr, dev):
    """The alternate correlation: at 720p kernel K's lookup against kernel
    B on the float32 pyramid of the same features (``ALT_LOOKUP_REL``), K
    timed beside its plain chain, and one flow's time against the dense
    path's (v4, 12 iterations, the dense head); then ``WOFT_alternate.py``
    at 3840x2160, 2 frames of the walk: peak device memory, frame time,
    corners and K's launches (13 a flow, exactly), where the float32
    pyramid would need the bytes printed; one 4K flow through the plain
    chain and through K in turns (plain, K, K, plain), their times and the
    largest difference of their upsampled flows; last K at the 4K grid,
    dense and indexed (the sparse head's 4,500 rows), against its plain
    chain on the same inputs (``ALT_LOOKUP_REL``) and timed against its
    bounds."""
    from benchmark.harness import alternate_work as aw
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow import RaftFlow
    from woft_tpu_torch.models.raft import weighted_raft_forward

    m = {"fnet_dim": 256, "corr_levels": 4, "corr_radius": 4}
    g = torch.Generator(device=dev).manual_seed(11)
    f1 = torch.randn(1, 90, 160, 256, device=dev, generator=g)
    f2 = torch.randn(1, 90, 160, 256, device=dev, generator=g)
    coords = (_cell_grid(dev) + (torch.rand(1, 90, 160, 2, device=dev,
                                            generator=g) - 0.5) * 40)
    coords = coords.contiguous()
    pyramid, _ = corr.corr_pyramid_fused(f1, f2, 4)
    dense = corr.corr_lookup(pyramid, coords, 4)
    levels = corr.alternate_levels(f2)
    alt = corr.corr_lookup_alternate_levels(f1, levels, coords, 4)
    rel = ((alt - dense).abs().max() / dense.abs().max()).item()
    alt_ms = time_ms(lambda: corr.corr_lookup_alternate_levels(
        f1, levels, coords, 4))
    plain_ms = time_ms(lambda: corr.corr_lookup_alternate_plain(
        f1, levels, coords, 4), iters=3, warmup=1)
    b_ms = time_ms(lambda: corr.corr_lookup(pyramid, coords, 4))
    bound_720p = 1e3 * aw.bound_s(aw.alt_dense_bytes(m, 720, 1280),
                                  aw.alt_lookup_flops(m, 90 * 160))
    log(f"alternate lookup at 720p (Q=14400): kernel K against kernel B on "
        f"the float32 pyramid {rel:.3g} of the largest value (tol "
        f"{ALT_LOOKUP_REL}); K {alt_ms:.4f} ms a lookup (bound "
        f"{bound_720p:.4f}), the plain chain {plain_ms:.3f} ms, kernel B "
        f"{b_ms:.4f} ms")
    if not rel <= ALT_LOOKUP_REL:
        raise AssertionError(f"alternate lookup disagrees: {rel}")
    del pyramid, dense, alt, levels

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
    res = ablation_walk(dev, "WOFT_alternate.py", h, w, kernels=kernels,
                        n_frames=2, n_fallback=0)
    report_ablation_walk(res)
    log(f"WOFT_alternate.py at {w}x{h}: peak device memory "
        f"{res['peak_gib']:.2f} GiB, where the float32 pyramid alone would "
        f"take {dense_bytes / 1e9:.1f} GB (level 0 "
        f"{q * q * 4 / 1e9:.1f} GB)")
    check_counts(f"WOFT_alternate.py at {w}x{h}", res["launches"],
                 {"warp_perspective_bilinear": res["n_frames"],
                  "alt_corr_lookup": 13 * res["n_flows"]},
                 ("warp_perspective_bilinear", "alt_corr_lookup"),
                 res["n_frames"], res["n_flows"])
    if not (np.isfinite(res["errs"]).all()
            and max(res["errs"]) <= ALT_4K_CORNER_BOUND_PX):
        raise AssertionError(f"4K alternate track: corner error "
                             f"{max(res['errs']):.3f} px, bound "
                             f"{ALT_4K_CORNER_BOUND_PX}")
    torch.cuda.empty_cache()

    conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                    "WOFT_alternate.py"))
    flower = RaftFlow(conf.flow_config, device=dev)
    template, frames, _ = walk(h, w, dev, n=1)
    img1, img2 = (torch.from_numpy(np.ascontiguousarray(f[..., ::-1])).to(
        dev).to(torch.float32)[None] for f in (template, frames[0]))

    def flow_4k():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        up = weighted_raft_forward(flower.model, flower.cfg, img1,
                                   img2)["flow_up"]
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, up

    flow_ms = {"plain": [], "K": []}
    for name in ("warm", "plain", "K", "K", "plain"):
        if name in ("warm", "plain"):
            with plain_alternate():
                ms, up_plain = flow_4k()
        if name in ("warm", "K"):
            n0 = kernels.alt_corr_lookup.launches
            ms, up_k = flow_4k()
            if kernels.alt_corr_lookup.launches - n0 != 13:
                raise AssertionError("a 4K alternate flow launches K "
                                     f"{kernels.alt_corr_lookup.launches - n0}"
                                     " times, not 13")
        if name != "warm":
            flow_ms[name].append(ms)
    flow_diff = (up_plain - up_k).abs().max().item()
    log(f"one {w}x{h} flow (v4, 12 iterations, the dense head), in turns: "
        f"the plain chain {', '.join(f'{t:.1f}' for t in flow_ms['plain'])}"
        f" ms, K {', '.join(f'{t:.1f}' for t in flow_ms['K'])} ms; largest "
        f"difference of the upsampled flows {flow_diff:.3g} px")
    del flower, up_plain, up_k
    torch.cuda.empty_cache()

    h1, w1 = h // 8, w // 8
    f1 = torch.randn(1, h1, w1, 256, device=dev, generator=g)
    levels = corr.alternate_levels(torch.randn(1, h1, w1, 256, device=dev,
                                               generator=g))
    coords = (_cell_grid(dev, h1, w1) + 2.0 + (torch.rand(
        1, h1, w1, 2, device=dev, generator=g) - 0.5) * 0.5).contiguous()
    # the sparse head's rows: the 3x3 cells around 500 points of the
    # centred half of each side
    ys = h1 // 4 + torch.randint(0, h1 // 2, (500, 1), device=dev,
                                 generator=g)
    xs = w1 // 4 + torch.randint(0, w1 // 2, (500, 1), device=dev,
                                 generator=g)
    d = torch.arange(-1, 2, device=dev)
    cells = ((ys + d).repeat_interleave(3, 1) * w1
             + (xs + d).repeat(1, 3)).reshape(-1)
    k4 = {}
    for what, c in (("dense", None), ("indexed", cells)):
        got = corr.corr_lookup_alternate_levels(f1, levels, coords, 4,
                                                cells=c)
        with plain_alternate():
            want = corr.corr_lookup_alternate_levels(f1, levels, coords, 4,
                                                     cells=c)
        k_rel = ((got - want).abs().max() / want.abs().max()).item()
        del got, want
        ms = time_ms(lambda: kernels.alt_corr_lookup(f1, levels, coords, 4,
                                                     c), iters=10)
        n = h1 * w1 if c is None else c.shape[0]
        n_bytes = (aw.alt_dense_bytes(m, h, w) if c is None
                   else aw.alt_indexed_bytes(m, h, w, 0.5, n))
        bound, by = bound_ms(n_bytes, aw.alt_lookup_flops(m, n))
        k4[what] = dict(ms=ms, bound_ms=bound, bound_by=by, max_rel=k_rel)
    log(f"kernel K at {w}x{h} (Q={q}) against its plain chain on the same "
        f"inputs: dense {k4['dense']['max_rel']:.3g}, indexed "
        f"{k4['indexed']['max_rel']:.3g} of the largest value (tol "
        f"{ALT_LOOKUP_REL}); dense {k4['dense']['ms']:.4f} ms (bound "
        f"{k4['dense']['bound_ms']:.4f}, {k4['dense']['bound_by']}), "
        f"indexed M={cells.shape[0]} {k4['indexed']['ms']:.4f} ms (bound "
        f"{k4['indexed']['bound_ms']:.4f})")
    for what, row in k4.items():
        if not row["max_rel"] <= ALT_LOOKUP_REL:
            raise AssertionError(f"kernel K ({what}, 4K) disagrees with its "
                                 f"plain chain: {row['max_rel']}")
    return dict(lookup_rel=rel, lookup_ms=alt_ms, plain_ms=plain_ms,
                bound_ms=bound_720p, b_ms=b_ms, flows=flows, track=res,
                flow_4k_ms=flow_ms, flow_4k_diff_px=flow_diff, k4=k4)


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


# The eval and entry-point phase (track_eval_entry). The synthetic evals'
# bounds on the median alignment error (px, eval_woft_torch.py's summary,
# one sequence of 30 frames on the base the seed draws): the CPU path's own
# median on the same eval (python3 eval_woft_torch.py --device cpu --images
# DIR --frames 30 --seqs 1 [--stress] --config ..., DIR written by
# write_eval_bases; 8 frames gave the medians in the comments), plus the
# headroom the window walks take for the card's other summation orders,
# half the CPU's error.
EVAL_TRACKS = (("WOFT.py", False), ("WOFT.py", True), ("WOFT_fast.py", False))
EVAL_MEDIAN_BOUND_PX = {
    # (config, stress): (CPU median over 30 frames, bound)
    ("WOFT.py", False): (0.0957, 0.144),        # 8 frames: 0.1085
    ("WOFT.py", True): (0.1198, 0.180),         # 8 frames: 0.1371
    ("WOFT_fast.py", False): (0.0953, 0.143),   # 8 frames: 0.1098
}
EVAL_FRAMES = 30
POT_FRAMES = 10
DEMO_FRAMES = 8
VIDEO_FRAMES = 16
VIDEO_HW = (1080, 1920)
UINT8_UPLOAD_TOL = 1e-6     # the same integers, cast on the card or the host


class TimedTracker:
    """A reference-API tracker that times each ``track`` (host clock; the
    shell returns a host H, so the frame's device work is done) and counts
    the frames whose inlier check failed (a fallback flow ran)."""

    def __init__(self, tracker):
        self.tracker = tracker
        self.device = tracker.device
        self.frame_ms, self.fallbacks = [], 0

    def init(self, img, mask):
        self.tracker.init(img, mask)

    def track(self, img):
        t0 = time.perf_counter()
        H, meta = self.tracker.track(img)
        self.frame_ms.append((time.perf_counter() - t0) * 1e3)
        self.fallbacks += not bool(meta.global_H_success)
        return H, meta


def eval_synthetic(kernels, dev, tmp, config, stress):
    """One synthetic eval through ``eval_woft_torch.py``'s code path
    (``run_synthetic``): ``EVAL_FRAMES`` frames of one sequence on the
    bases of ``write_eval_bases``, rendered on the card (kernel A, one
    launch), tracked from 0 counts. Returns its numbers."""
    import eval_woft_torch
    from woft_tpu_torch.config import load_config

    what = f"eval {config}{' --stress' if stress else ''}"
    args = eval_woft_torch.parse_args(
        ["--images", os.path.join(tmp, "bases"), "--config",
         os.path.join(ROOT, "woft_tpu_torch", "configs", config),
         "--frames", str(EVAL_FRAMES), "--seqs", "1", "--device", str(dev)]
        + (["--stress"] if stress else []))
    conf = load_config(args.config)
    tracker = TimedTracker(conf.tracker_class(conf, device=dev))
    torch.cuda.synchronize()
    zero_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary, _ = eval_woft_torch.run_synthetic(args, conf, tracker)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = tracker.frame_ms[1:]
    n_frames = len(tracker.frame_ms)
    n_flows = n_frames + tracker.fallbacks
    log(f"{what}: median {summary['median_px']:.4f} px, mean "
        f"{summary['mean_px']:.4f}, p90 {summary['p90_px']:.4f}; "
        + ", ".join(f"{k} {summary[k]:.3f}" for k in summary
                    if k.startswith("p@"))
        + f"; fallbacks {tracker.fallbacks}/{n_frames}; steady frame "
        f"{sum(steady) / len(steady):.2f} ms (min {min(steady):.2f}, max "
        f"{max(steady):.2f}); peak device memory {peak:.2f} GiB; whole "
        f"eval {wall:.2f} s; launches {launches}")
    # A: one render launch (30 frames of 720p in one chunk) and one
    # pre-warp a tracked frame; B 13 a flow, or C once and D, E 13 times
    render = math.ceil(EVAL_FRAMES / max(
        1, (1 << 30) // (H_IMG * W_IMG * 3 * 4)))
    want = {"warp_perspective_bilinear": render + n_frames,
            **update_launches(config == "WOFT_fast.py", n_flows)}
    if config == "WOFT_fast.py":
        want.update(local_corr_build=n_flows,
                    local_lookup_coords=13 * n_flows,
                    local_lookup_exact_coords=13 * n_flows)
    else:
        want.update(corr_pyramid_lookup=13 * n_flows)
    check_counts(what, launches, want, tuple(want), n_frames, n_flows)
    cpu, bound = EVAL_MEDIAN_BOUND_PX[(config, stress)]
    if not (np.isfinite(list(summary.values())).all()
            and summary["median_px"] <= bound):
        raise AssertionError(f"{what}: median {summary['median_px']} px, "
                             f"bound {bound} px (CPU {cpu})")
    return dict(summary=summary, launches=launches, fallbacks=tracker.
                fallbacks, steady_ms=sum(steady) / len(steady),
                peak_gib=peak)


def check_render(kernels, warp, dev, tmp):
    """Kernel A in the render's one-source, N-homography form: the 30
    720p frames of the default eval's trajectory in one launch, against
    the plain warp on the card (exact: A is built without FMA
    contraction), timed beside its bound and ``F.grid_sample``."""
    from woft_tpu_torch.eval.synth_eval import synth_trajectory
    from woft_tpu_torch.geometry.homography import _cv2

    base = _cv2("check_render").imread(os.path.join(tmp, "bases",
                                                    "base_0.png"))
    h_gt = synth_trajectory(np.random.default_rng(0), EVAL_FRAMES, H_IMG,
                            W_IMG, max_step_px=3.0)
    src = torch.from_numpy(base).to(dev).to(torch.float32)[None]
    H = torch.from_numpy(np.linalg.inv(h_gt)).to(dev, torch.float32)
    hinv = warp.inverse_h(H)
    got = kernels.warp_perspective_bilinear(src, hinv, H_IMG, W_IMG)
    want = warp.warp_perspective(src, H, (H_IMG, W_IMG))
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    n = EVAL_FRAMES
    px = n * H_IMG * W_IMG
    bnd, by = bound_ms(4 * H_IMG * W_IMG * 3 + 4 * px * 3 + 36 * n,
                       px * (12 + 2 + 4 + 36))
    coords = warp.perspective_coords(H, (H_IMG, W_IMG))
    grid = torch.stack([2 * coords[..., 0] / (W_IMG - 1) - 1,
                        2 * coords[..., 1] / (H_IMG - 1) - 1], -1)
    src_nchw = src.permute(0, 3, 1, 2).expand(n, -1, -1, -1)
    ms = time_ms(lambda: kernels.warp_perspective_bilinear(
        src, hinv, H_IMG, W_IMG), iters=10)
    plain_ms = time_ms(lambda: warp.warp_perspective(src, H,
                                                     (H_IMG, W_IMG)), iters=3)
    library_ms = time_ms(lambda: F.grid_sample(
        src_nchw, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), iters=10)
    log(f"kernel A [render, {n} frames of {W_IMG}x{H_IMG} from one source in "
        f"one launch]: max_abs_err {err:.3g} (tol 0); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, F.grid_sample {library_ms:.4f} ms, bound "
        f"{bnd:.4f} ms ({by})")
    if err != 0:
        raise AssertionError(f"kernel A disagrees at the render: {err}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=library_ms, n_frames=n)


def write_pot_clip(dev, tmp):
    """``POT_FRAMES`` frames of a default-protocol walk of base 1 as jpgs,
    and their ground truth as a POT annotation file (the centred half box
    projected through the walk). Returns (clip dir, annotation path)."""
    from woft_tpu_torch.eval.pot import corners_from_homographies
    from woft_tpu_torch.eval.synth_eval import (render_sequence,
                                                synth_trajectory)
    from woft_tpu_torch.geometry.homography import _cv2

    cv2 = _cv2("write_pot_clip")
    base = cv2.imread(os.path.join(tmp, "bases", "base_1.png"))
    h_gt = synth_trajectory(np.random.default_rng(1), POT_FRAMES, H_IMG,
                            W_IMG, max_step_px=3.0)
    clip = os.path.join(tmp, "pot_clip")
    os.makedirs(clip)
    for i, f in enumerate(render_sequence(base, h_gt, device=dev)):
        cv2.imwrite(os.path.join(clip, f"{i:05d}.jpg"), f)
    quad = np.array([[W_IMG // 4, H_IMG // 4], [3 * W_IMG // 4, H_IMG // 4],
                     [3 * W_IMG // 4, 3 * H_IMG // 4],
                     [W_IMG // 4, 3 * H_IMG // 4]], np.float64)
    gt = corners_from_homographies(h_gt, quad)
    ann = os.path.join(tmp, "pot_clip.txt")
    with open(ann, "w") as f:
        for c in gt:
            f.write(" ".join(f"{v:.4f}" for v in c.ravel()) + "\n")
    return clip, ann


def eval_pot(dev, clip, ann):
    """``evaluate_pot_sequence`` on ``WOFT.py`` over the jpg clip: 9
    scored frames."""
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.eval.pot import (evaluate_pot_sequence,
                                         read_pot_annotations)

    conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                    "WOFT.py"))
    paths = sorted(os.path.join(clip, p) for p in os.listdir(clip))
    gt = read_pot_annotations(ann)
    metrics, est, hs = evaluate_pot_sequence(
        conf.tracker_class(conf, device=dev), paths, gt)
    log(f"POT path (WOFT.py, {len(paths)} jpg frames of a walk, its "
        f"annotation file): {json.dumps(metrics)}")
    if metrics.get("frames") != POT_FRAMES - 1 or not np.isfinite(hs).all():
        raise AssertionError(f"POT path: {metrics}")
    return metrics


class DemoLog(logging.Handler):
    """Collects the demo's per-frame log records ("frame %d: %.1fms
    lost=%s") and any error it logged."""

    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.frames, self.errors = [], []

    def emit(self, record):
        if record.levelno >= logging.ERROR:
            self.errors.append(record.getMessage())
        elif str(record.msg).startswith("frame %d"):
            self.frames.append(record.args)


def run_demo(kernels, dev, clip, out, debug):
    """``WOFT_demo_torch.py --headless [--debug] --max-frames 8`` on the
    jpg clip under ``WOFT.py``, in this process, counted from 0. Returns
    (launches, frame ms, lost frames)."""
    import WOFT_demo_torch

    argv = [clip, "--headless", "--out", out, "--max-frames",
            str(DEMO_FRAMES), "--device", str(dev), "--config",
            os.path.join(ROOT, "woft_tpu_torch", "configs", "WOFT.py")]
    args = WOFT_demo_torch.parse_arguments(argv + (["--debug"] if debug
                                                   else []))
    logger = logging.getLogger("WOFT_demo_torch")
    frame_log = DemoLog()
    logger.addHandler(frame_log)
    logger.setLevel(logging.DEBUG)
    try:
        zero_counts(kernels)
        rc = WOFT_demo_torch.run(args)
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(frame_log)
    launches = read_counts(kernels)
    if rc != 0 or frame_log.errors:
        raise AssertionError(f"demo: rc {rc}, errors {frame_log.errors}")
    frame_ms = [ms for _, ms, _ in frame_log.frames]
    lost = sum(bool(lost) for _, _, lost in frame_log.frames)
    return launches, frame_ms, lost


def check_demo(kernels, dev, clip, tmp):
    """The demo with and without ``--debug``: overlays, the four debug
    images a frame, 8 finite H in ``homographies.npz``; B 39 times a debug
    frame (the step's flow and the overlays' two dense-head flows), 13
    without, 13 more on a lost frame; A 3 times a debug frame (the
    pre-warp and the overlays' two warps), once without."""
    from woft_tpu_torch.geometry.homography import _cv2

    cv2 = _cv2("check_demo")
    res = {}
    for debug in (True, False):
        what = "demo --debug" if debug else "demo"
        out = os.path.join(tmp, "demo_debug" if debug else "demo")
        launches, frame_ms, lost = run_demo(kernels, dev, clip, out, debug)
        n = DEMO_FRAMES
        flows_a_frame = 3 if debug else 1
        check_counts(what, launches,
                     {"warp_perspective_bilinear": flows_a_frame * n,
                      "corr_pyramid_lookup": 13 * (flows_a_frame * n + lost)},
                     ("warp_perspective_bilinear", "corr_pyramid_lookup"),
                     n, flows_a_frame * n + lost)
        hs = np.load(os.path.join(out, "homographies.npz"))["H"]
        if hs.shape != (n, 3, 3) or not np.isfinite(hs).all():
            raise AssertionError(f"{what}: homographies {hs.shape}")
        names = [f"{i:05d}.jpg" for i in range(n)]
        if debug:
            names += [f"{i:05d}_debug_{k}.jpg" for i in range(1, n + 1)
                      for k in ("pw_flow", "local_flow", "composition",
                                "template_points")]
        for name in names:
            im = cv2.imread(os.path.join(out, name))
            if im is None or not im.std() > 0:
                raise AssertionError(f"{what}: {name} missing or blank")
        steady = frame_ms[1:]
        log(f"{what}: {n} frames, lost {lost}; frame (track, overlays and "
            f"their jpgs) {sum(steady) / len(steady):.1f} ms steady (first "
            f"{frame_ms[0]:.1f}); B {launches['corr_pyramid_lookup']} "
            f"launches ({launches['corr_pyramid_lookup'] / n:.1f} a frame), "
            f"A {launches['warp_perspective_bilinear']}; {len(names)} images "
            f"checked")
        res[what] = dict(launches=launches, steady_ms=sum(steady)
                         / len(steady), lost=lost)
    return res


def time_overlay_flow(dev, clip):
    """One of the debug overlays' two extra flows alone: ``RaftFlow.
    compute_flow(mode='flow', numpy_out=True)`` on two 720p frames of the
    clip under ``WOFT.py`` (both frames encoded, the dense weight head,
    the result downloaded), host clock, mean of 5 after 2."""
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow import RaftFlow
    from woft_tpu_torch.geometry.homography import _cv2

    conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                    "WOFT.py"))
    flower = RaftFlow(conf.flow_config, device=dev)
    a, b = (_cv2("time_overlay_flow").imread(
        os.path.join(clip, f"{i:05d}.jpg")) for i in (0, 1))
    for _ in range(2):
        flower.compute_flow(a, b, mode="flow", numpy_out=True)
    t0 = time.perf_counter()
    for _ in range(5):
        flower.compute_flow(a, b, mode="flow", numpy_out=True,
                            do_sigmoid=True)
    ms = (time.perf_counter() - t0) * 1e3 / 5
    log(f"demo --debug: one overlay flow (compute_flow, both frames "
        f"encoded, dense head, downloaded) {ms:.1f} ms")
    return ms


def device_events(fn):
    """The device kernels ``fn()`` ran, under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.name.startswith("Mem")]
    if not ev:
        raise AssertionError("the profiler recorded no kernel")
    return ev


def device_idle_share(fn, ev=None):
    """``fn()``'s device timeline under ``torch.profiler`` (or the events
    ``ev`` of one): (kernels, busy ms, span ms from the first kernel's
    start to the last's end, idle share of that span)."""
    ev = device_events(fn) if ev is None else ev
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    span = (max(e.time_range.end for e in ev)
            - min(e.time_range.start for e in ev)) / 1e3
    return len(ev), busy, span, 1 - busy / span


def check_track_video(kernels, dev, tmp):
    """``track_video`` on ``WOFT_window.py`` (v5) at 1920x1080: 16 frames
    of the walk as a jpg directory, decoded on threads ('threaded'), under
    ``no_local_h``: equal to a per-frame loop of the same window step over
    the same decoded frames (0), ``sync_every`` 1 and 8 equal (0), the
    uint8 upload within ``UINT8_UPLOAD_TOL`` of float32; frames/s for both
    cadences, the decode's ms a frame, the device's idle share."""
    from woft_tpu_torch import pipeline
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow import RaftFlow
    from woft_tpu_torch.geometry.homography import _cv2
    from woft_tpu_torch.tracker import (build_window_track_step,
                                        window_init_state,
                                        window_params_for_mask)

    cv2 = _cv2("check_track_video")
    h, w = VIDEO_HW
    template, frames, _ = walk(h, w, dev, n=VIDEO_FRAMES - 1)
    clip = os.path.join(tmp, "video_clip")
    os.makedirs(clip)
    for i, f in enumerate([template] + frames):
        cv2.imwrite(os.path.join(clip, f"{i:05d}.jpg"), f)
    mask, _ = centred_mask(h, w, 0.25)
    conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                    "WOFT_window.py"))
    flower = RaftFlow(conf.flow_config, device=dev)
    model, cfg = flower.model, flower.cfg
    tp = replace(conf.tracker_params, no_local_h=True)
    wp = window_params_for_mask(mask, size=conf.window_size,
                                margin=conf.window_margin,
                                min_px=conf.min_window_px)

    def run(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = pipeline.track_video(model, cfg, tp, wp, clip, mask, **kw)
        return hs, time.perf_counter() - t0

    run(sync_every=8)                  # warm-up: cuDNN plans, allocator
    zero_counts(kernels)
    hs8, t8 = run(sync_every=8)
    launches = read_counts(kernels)
    if pipeline.LAST_SOURCE != "threaded":
        raise AssertionError(f"track_video decoded by {pipeline.LAST_SOURCE}")
    # the two cadences in turns (8, 1, 1, 8): host clocks spread here
    hs1, t1 = run(sync_every=1)
    t1b = run(sync_every=1)[1]
    t8b = run(sync_every=8)[1]
    hsu, tu = run(sync_every=8, uint8_upload=True)
    n = VIDEO_FRAMES - 1
    check_counts("track_video", launches,
                 {"warp_perspective_bilinear": 1 + 2 * n,
                  "corr_pyramid_lookup": 13 * n},
                 ("warp_perspective_bilinear", "corr_pyramid_lookup"), n, n)

    t0 = time.perf_counter()
    decoded = list(pipeline._frame_source(clip))
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(decoded)
    step = build_window_track_step(cfg, tp, wp)
    up = [torch.from_numpy(f).to(dev)[None] for f in decoded]
    state = window_init_state(model, cfg, tp, wp, up[0], mask)
    loop = [np.eye(3)]
    for f in up[1:]:
        state, H, _ = step(model, state, f)
        loop.append(H.cpu().numpy())
    loop = np.stack(loop)
    n_ev, busy, span, idle = device_idle_share(
        lambda: pipeline.track_video(model, cfg, tp, wp, clip, mask))
    d_loop = np.abs(hs8 - loop).max()
    d_sync = np.abs(hs8 - hs1).max()
    d_u8 = np.abs(hs8 - hsu).max()
    log(f"track_video (WOFT_window.py, v5, {w}x{h}, {VIDEO_FRAMES} jpg "
        f"frames, decode '{pipeline.LAST_SOURCE}', window {wp.shape}): "
        f"sync_every=8 {VIDEO_FRAMES / t8:.1f} / {VIDEO_FRAMES / t8b:.1f} "
        f"frames/s, sync_every=1 {VIDEO_FRAMES / t1:.1f} / "
        f"{VIDEO_FRAMES / t1b:.1f} frames/s (in turns 8, 1, 1, 8), uint8 upload "
        f"{VIDEO_FRAMES / tu:.1f} frames/s (each the whole call, init and "
        f"decode included); threaded decode {decode_ms:.2f} ms a frame; "
        f"device {n_ev} kernels, busy {busy:.1f} ms of a {span:.1f} ms "
        f"span, idle share {idle:.3f}; launches {launches}")
    log(f"track_video: against the per-frame loop max |dH| {d_loop:.3g} "
        f"(tol 0), sync_every 1 vs 8 {d_sync:.3g} (tol 0), uint8 vs float32 "
        f"{d_u8:.3g} (tol {UINT8_UPLOAD_TOL})")
    if not (np.isfinite(hs8).all() and d_loop == 0 and d_sync == 0
            and d_u8 <= UINT8_UPLOAD_TOL):
        raise AssertionError("track_video disagrees")
    return dict(launches=launches,
                fps8=(VIDEO_FRAMES / t8, VIDEO_FRAMES / t8b),
                fps1=(VIDEO_FRAMES / t1, VIDEO_FRAMES / t1b),
                fps_u8=VIDEO_FRAMES / tu,
                decode_ms=decode_ms, busy_ms=busy, span_ms=span,
                idle_share=idle)


def track_eval_entry(kernels, warp, dev):
    """The eval and entry-point phase: the synthetic evals
    (``EVAL_TRACKS``), kernel A's render form, the POT path, the demo with
    and without its debug overlays, ``track_video``. Returns its
    numbers."""
    import tempfile

    t_phase = time.perf_counter()
    out = {"evals": {}}
    with tempfile.TemporaryDirectory() as tmp:
        write_eval_bases(os.path.join(tmp, "bases"), H_IMG, W_IMG)
        out["render"] = check_render(kernels, warp, dev, tmp)
        for config, stress in EVAL_TRACKS:
            torch.cuda.empty_cache()
            key = f"eval {config}{' --stress' if stress else ''}"
            out["evals"][key] = eval_synthetic(kernels, dev, tmp, config,
                                               stress)
        clip, ann = write_pot_clip(dev, tmp)
        out["pot"] = eval_pot(dev, clip, ann)
        out["demo"] = check_demo(kernels, dev, clip, tmp)
        out["overlay_flow_ms"] = time_overlay_flow(dev, clip)
        torch.cuda.empty_cache()
        out["video"] = check_track_video(kernels, dev, tmp)
    log(f"eval and entry-point phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# training on the card: kernel B' at the training shape, then
# train_wraft_torch.py's main path in both modes, C, D and E under grad,
# and one step on the card against the CPU path
# ---------------------------------------------------------------------------

TRAIN_HW = (288, 384)            # train_wraft.py's defaults
TRAIN_BATCH = 4
TRAIN_STEPS = 6                  # a run: weight head, then the whole net
TRAIN_VAL_EVERY = 3              # validation at steps 0 and 3
TRAIN_IMAGES = 6                 # textured 360x480 frames, written as png
BWD_REL = 1e-5                   # B' float32: summation order, relative to
#                                  the largest magnitude of the result
LOCAL_GRAD_TOL = 5e-4            # C, D, E vs B under grad: the JAX
#                                  package's own bound (atol = rtol)
TRAIN_CARD_CPU_REL = 5e-3        # one weight-head step, card vs CPU: the
#                                  loss and the head's gradients, relative
#                                  to the largest (1.98e-3 measured). The
#                                  fit ignores a common scale of the
#                                  weights, so the head's gradients are
#                                  sums of the weight map's gradient that
#                                  nearly cancel, and the map's gradient
#                                  differs by 1.3e-4 between the two
#                                  devices' float32 fits: the check splits
#                                  the difference so
TRAIN_FORWARD_REL = 1e-5         # the weight map's forward (5.1e-7)
TRAIN_PART_REL = 1e-3            # the fit's backward alone (1.3e-4) and the
#                                  head's backward alone (3.0e-4)


def _bwd_case(dev, dtype):
    """Kernel B' at the training shape: batch 4 of 288x384 (Q = 4 * 36 *
    48 = 6,912 queries, four levels, radius 4), centroids at integer
    positions, inside, partly and wholly outside their levels."""
    g = torch.Generator(device=dev).manual_seed(7)
    B, (H, W) = TRAIN_BATCH, TRAIN_HW
    H1, W1 = H // 8, W // 8
    Q = B * H1 * W1
    pyramid, h, w = [], H1, W1
    for _ in range(4):
        pyramid.append(torch.randn((Q, h, w), generator=g, device=dev)
                       .to(dtype).contiguous())
        h, w = h // 2, w // 2
    grid = _cell_grid(dev, H1, W1).expand(B, -1, -1, -1).reshape(Q, 2)
    off = torch.randn((Q, 2), generator=g, device=dev) * 8
    kind = (torch.arange(Q, device=dev) % 4)[:, None]
    coords = torch.where(kind == 0, grid, grid + off)        # integers
    coords = torch.where(kind == 3, grid + 20 * off, coords)  # far out
    gr = torch.randn((Q, 4 * 81), generator=g, device=dev)
    return pyramid, coords.contiguous(), gr


def _grid_sample_backward(pyramid, coords, gr, radius):
    """Library yardstick of B': ``F.grid_sample``'s backward over the four
    levels (the input's and the grid's gradients), its forward outside the
    timed call."""
    lv = [p.float()[:, None].requires_grad_() for p in pyramid]
    flat = coords.requires_grad_()
    outs = _grid_sample_levels([x[:, 0] for x in lv], flat, radius)
    k = 2 * radius + 1
    gs = [gr[:, lvl * k * k:(lvl + 1) * k * k].reshape(o.shape)
          for lvl, o in enumerate(outs)]

    def backward():
        return torch.autograd.grad(outs, [*lv, flat], gs, retain_graph=True)

    return backward


def _compare_lookup_backward(kernels, corr, pyramid, coords, gr, radius,
                             what):
    """Kernel B' against its plain version on (pyramid, coords (Q, 2), g):
    float32 gradients within ``BWD_REL`` of the largest magnitude, bf16
    levels' within that plus one bf16 ulp; windows wholly outside level 0
    must leave their rows zero, and the case must hold some. Returns the
    largest error."""
    dtype = pyramid[0].dtype
    d_lv, d_c = kernels.corr_pyramid_lookup_backward(pyramid, coords, gr,
                                                     radius)
    p_lv, p_c = corr.corr_lookup_backward_plain(pyramid, coords, gr, radius)
    torch.cuda.synchronize()
    err = 0.0
    for lvl, (a, b) in enumerate(zip(d_lv, p_lv)):
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        err = max(err, diff.max().item())
        tol = BWD_REL * b.abs().max().item()
        if dtype == torch.bfloat16:
            # one bf16 ulp of the plain value, on top of float32 order
            ulp = torch.exp2(torch.floor(torch.log2(
                b.abs().clamp(min=1e-30))) - 7)
            bad = (diff > ulp + tol).sum().item()
        else:
            bad = (diff > tol).sum().item()
        if bad:
            raise AssertionError(f"kernel B' ({what}, {dtype}) level {lvl}: "
                                 f"{bad} gradients beyond the bound")
        if lvl == 0:
            # windows wholly outside level 0 leave their rows zero
            hl, wl = pyramid[0].shape[1:]
            x, y = coords[:, 0], coords[:, 1]
            out = ((x <= -(radius + 2)) | (x >= wl + radius + 1)
                   | (y <= -(radius + 2)) | (y >= hl + radius + 1))
            if not out.any() or a[out].abs().max().item() != 0:
                raise AssertionError("kernel B': a window wholly outside "
                                     "its level has a gradient")
    c_err = (d_c - p_c).abs().max().item()
    c_tol = BWD_REL * p_c.abs().max().item()
    log(f"kernel B' [{what}, {dtype}, Q={coords.shape[0]}]: max_abs_err "
        f"levels {err:.3g}, coordinates {c_err:.3g} (tol {BWD_REL:g} x the "
        f"largest magnitude"
        f"{', plus one bf16 ulp' if dtype == torch.bfloat16 else ''})")
    if not c_err <= c_tol:
        raise AssertionError(f"kernel B' ({what}, {dtype}) coordinate "
                             f"gradient disagrees: {c_err} > {c_tol}")
    return max(err, c_err)


def check_lookup_backward(kernels, corr, dev):
    """Kernel B' against its plain version (autograd through the plain
    lookup on the levels widened to float32, rounded once to the level's
    dtype) at the training shape, bf16 levels (the 'default' precision the
    trainer runs) and float32, timed beside its bound, the plain version
    and ``F.grid_sample``'s backward over the four levels."""
    radius, k = 4, 9
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        pyramid, coords, gr = _bwd_case(dev, dtype)
        Q = coords.shape[0]
        err = _compare_lookup_backward(kernels, corr, pyramid, coords, gr,
                                       radius, "random levels")
        ms = time_ms(lambda: kernels.corr_pyramid_lookup_backward(
            pyramid, coords, gr, radius))
        plain_ms = time_ms(lambda: corr.corr_lookup_backward_plain(
            pyramid, coords, gr, radius), iters=5, warmup=1)
        library_ms = time_ms(_grid_sample_backward(pyramid, coords, gr,
                                                   radius), iters=5, warmup=1)
        esize = pyramid[0].element_size()
        cells = sum(p.shape[1] * p.shape[2] for p in pyramid)
        n_out = Q * 4 * k * k
        # each row written once, g and the coordinates read, the windows
        # read for the coordinate gradient, the coordinate gradient written
        n_bytes = (Q * cells * esize + n_out * 4 + Q * 16
                   + _window_bytes(pyramid, coords, None, radius))
        bnd, by = bound_ms(n_bytes, n_out * 30)
        log(f"kernel B' timing [{dtype}]: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, F.grid_sample backward x4 levels "
            f"{library_ms:.4f} ms, bound {bnd:.4f} ms ({by}: "
            f"{n_bytes / 1e6:.1f} MB)")
        rows[str(dtype).split(".")[1]] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bnd, bound_by=by, library_ms=library_ms)
        del pyramid
        torch.cuda.empty_cache()
    return rows


def write_train_images(directory):
    """``TRAIN_IMAGES`` textured 360x480 frames as pngs (crops of 288x384
    are taken from them)."""
    from woft_tpu_torch.geometry.homography import _cv2

    os.makedirs(directory, exist_ok=True)
    for i in range(TRAIN_IMAGES):
        path = os.path.join(directory, f"train_{i}.png")
        if not _cv2("write_train_images").imwrite(
                path, textured_frame(360, 480, seed=20 + i)):
            raise OSError(f"cannot write {path}")


def check_training_shapes(kernels, corr, warp, dev, images, init):
    """Kernels A-E and B' at the shapes the training runs give them, each
    against its plain version on the same inputs. A on the trainer's own
    crops and homographies (the validation batch's, then the first step's:
    four 288x384 sources warped by four homographies in one launch, the
    crops and draws taken as ``train_wraft_torch.run`` takes them at its
    default seed); B and B' on the bf16 pyramid (Q = 6,912, levels 36x48
    to 4x6) of the v4 features of the first step's pair, at centroids on
    integer positions, near their cell and far outside; C, D and E at the
    block-local gradient's 36 x 48 grid (B = 1), bf16 and float32. Bounds:
    A ``WARP_TOL``, B and D, E exact, B' ``BWD_REL`` of the largest plus
    one bf16 ulp, C ``CORR_ATOL`` + its rtol. Returns {kernel: the largest
    error}."""
    import glob

    import train_wraft_torch
    from woft_tpu_torch.models import layers
    from woft_tpu_torch.models.raft import RaftConfig, init_raft_params
    from woft_tpu_torch.training.synth import (homographies_from_draws,
                                               synth_draws)

    H, W = TRAIN_HW
    H1, W1 = H // 8, W // 8
    radius = 4
    args = train_wraft_torch.parse_args(["--images", images])
    stream = train_wraft_torch.image_stream(
        sorted(glob.glob(os.path.join(images, "*.png"))), TRAIN_HW,
        TRAIN_BATCH, np.random.default_rng(args.seed), args.scale_jitter)
    errs = {"A": 0.0}
    for what, seed in (("validation batch", 12345),
                       ("first step", args.seed + 1)):
        imgs = torch.from_numpy(next(stream)).to(dev)
        d = synth_draws(torch.Generator(device=dev).manual_seed(seed),
                        TRAIN_BATCH, H, W, jitter=False)
        hs = homographies_from_draws(
            d["shift"], d["translation"], H, W,
            max_corner_shift=args.max_shift,
            max_translation=args.max_translation)
        hinv = warp.inverse_h(hs)
        warped = kernels.warp_perspective_bilinear(imgs, hinv, H, W)
        want = warp.warp_perspective(imgs, hs)
        torch.cuda.synchronize()
        err = (warped - want).abs().max().item()
        errs["A"] = max(errs["A"], err)
        log(f"kernel A [training render, {what}: {TRAIN_BATCH} sources x "
            f"{TRAIN_BATCH} homographies, {H}x{W}, one launch]: "
            f"max_abs_err {err:.3g} (tol {WARP_TOL})")
        if not err <= WARP_TOL:
            raise AssertionError(f"kernel A disagrees on the training "
                                 f"render ({what}): {err}")
    ms = time_ms(lambda: kernels.warp_perspective_bilinear(imgs, hinv, H, W))
    plain_ms = time_ms(lambda: warp.warp_perspective(imgs, hs), iters=5)
    log(f"kernel A timing (training render): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")

    # the first step's pair through the v4 feature encoder, as the
    # trainer's 'default' precision runs it
    model = init_raft_params(RaftConfig(), seed=0)
    model.load_state_dict(torch.load(init, map_location="cpu",
                                     weights_only=True))
    model.to(dev)
    x = (2.0 * (torch.cat([imgs, warped]) / 255.0) - 1.0).permute(0, 3, 1, 2)
    with torch.no_grad(), layers.precision_scope("default"):
        f1, f2 = (f.permute(0, 2, 3, 1).contiguous()
                  for f in model.fnet(x).split(TRAIN_BATCH))
    del model
    pyramid, _ = corr.corr_pyramid_fused(f1, f2, 4, out_dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(9)
    grid = _cell_grid(dev, H1, W1).expand(TRAIN_BATCH, -1, -1, -1)
    off = torch.randn(grid.shape, generator=g, device=dev) * 8
    kind = (torch.arange(H1 * W1, device=dev) % 4).reshape(1, H1, W1, 1)
    coords = torch.where(kind == 0, grid, grid + off)         # integers
    coords = torch.where(kind == 3, grid + 20 * off, coords)  # far out
    coords = coords.contiguous()
    Q = coords.numel() // 2
    got = kernels.corr_pyramid_lookup(pyramid, coords, radius)
    want = corr.corr_lookup_plain(pyramid, coords, radius).reshape(Q, -1)
    torch.cuda.synchronize()
    errs["B"] = (got - want).abs().max().item()
    log(f"kernel B [training pyramid, bf16 levels "
        f"{'/'.join('%dx%d' % tuple(p.shape[1:]) for p in pyramid)}, "
        f"Q={Q}]: max_abs_err {errs['B']:.3g} (exact expected)")
    if errs["B"] != 0.0:
        raise AssertionError(f"kernel B differs from its plain version on "
                             f"the training pyramid: {errs['B']}")
    gr = torch.randn((Q, 4 * (2 * radius + 1) ** 2), generator=g, device=dev)
    errs["B'"] = _compare_lookup_backward(
        kernels, corr, pyramid, coords.reshape(Q, 2), gr, radius,
        "training pyramid")
    del pyramid, f1, f2

    errs["C"] = max(_compare_local_corr(
        kernels, corr, _local_corr_case(corr, dev, H1, W1, dtype), dtype,
        rtol, f"training grid {H1}x{W1}")
        for dtype, rtol in ((torch.bfloat16, CORR_RTOL_BF16),
                            (torch.float32, CORR_RTOL_FP32)))
    lookups, _, _ = _compare_coord_lookups(kernels, corr, dev,
                                           ((H1, W1, 4, 16),))
    errs.update(lookups)
    torch.cuda.empty_cache()
    return errs


def train_run(kernels, dev, argv):
    """``train_wraft_torch.py`` (its ``run``) on ``argv``, counted from 0:
    each step timed on the host clock between syncs, the fifth step traced
    for the device's idle share. Returns the result and the numbers."""
    import train_wraft_torch

    step_s, idle = [], {}

    def wrap_step(i, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 4:
            out = []
            ev = device_events(lambda: out.append(fn()))
            n, busy, span, share = device_idle_share(None, ev)
            idle.update(kernels=n, busy_ms=busy, span_ms=span, idle=share)
            # kernels B and B' (corr_lookup_kernel, _backward_kernel)
            for key, tag in (("b_ms", "corr_lookup_kernel"),
                             ("bb_ms", "corr_lookup_backward_kernel")):
                idle[key] = sum(e.time_range.elapsed_us() for e in ev
                                if tag in e.name) / 1e3
            loss = out[0]
        else:
            loss = fn()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return loss

    args = train_wraft_torch.parse_args(argv)
    zero_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    res = train_wraft_torch.run(args, wrap_step=wrap_step)
    torch.cuda.synchronize()
    res["launches"] = read_counts(kernels)
    res["step_s"] = step_s
    res["idle"] = idle
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    steady = [t for i, t in enumerate(step_s) if i not in (0, 4)]
    res["steady_s"] = sum(steady) / len(steady)
    losses = [f"{v:.4f}" for v in res["losses"]]
    if len(losses) > 8:             # the first and the last three
        losses = losses[:3] + ["..."] + losses[-3:]
    log(f"  losses {', '.join(losses)}; val EPE "
        f"{', '.join(f'{s}: {e:.3f}' for s, e in res['val'])} px")
    log(f"  first step {step_s[0]:.3f} s, steady {res['steady_s']:.4f} s a "
        f"step ({min(steady):.4f}-{max(steady):.4f}), "
        f"{TRAIN_BATCH / res['steady_s']:.1f} samples/s (the first and the "
        f"traced step left out); peak device memory "
        f"{res['peak_gib']:.2f} GiB; step 5 traced: {idle['kernels']} "
        f"kernels, busy {idle['busy_ms']:.1f} of {idle['span_ms']:.1f} ms, "
        f"idle {idle['idle']:.1%}, kernel B {idle['b_ms']:.3f} ms, B' "
        f"{idle['bb_ms']:.3f} ms; launches {res['launches']}")
    if res["rc"] != 0 or not all(np.isfinite(res["losses"])):
        raise AssertionError("training: a non-finite loss")
    return res


def served_conf(ckpt, config="WOFT.py"):
    """``configs/<config>`` loaded with the checkpoint ``ckpt`` named by
    ``WOFT_WRAFT_TORCH_CKPT``, as a user serves a trained file; the
    variable is restored after."""
    from woft_tpu_torch.config import load_config

    prev = os.environ.get("WOFT_WRAFT_TORCH_CKPT")
    os.environ["WOFT_WRAFT_TORCH_CKPT"] = str(ckpt)
    try:
        conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                        config))
    finally:
        if prev is None:
            del os.environ["WOFT_WRAFT_TORCH_CKPT"]
        else:
            os.environ["WOFT_WRAFT_TORCH_CKPT"] = prev
    if os.path.abspath(str(conf.flow_config.model)) != os.path.abspath(
            str(ckpt)):
        raise AssertionError(f"{config} loads {conf.flow_config.model}, not "
                             f"the checkpoint {ckpt}")
    return conf


def track_trained(kernels, dev, ckpt):
    """The trained checkpoint served to the tracker through
    ``WOFT_WRAFT_TORCH_CKPT`` (``RaftFlow`` via ``configs/WOFT.py``): 4
    frames of the 720p walk, counted from 0."""
    from woft_tpu_torch.tracker import WOFTTracker

    conf = served_conf(ckpt)
    template, frames, poses = walk(H_IMG, W_IMG, dev, n=4)
    mask, corners = centred_mask(H_IMG, W_IMG, 0.5)
    tracker = WOFTTracker(conf, device=dev)
    zero_counts(kernels)
    tracker.init(template, mask)
    hs = [tracker.track(f)[0] for f in frames]
    torch.cuda.synchronize()
    launches = read_counts(kernels)
    errs = corner_errors(hs, poses, corners)
    log(f"trained checkpoint under WOFT.py, 4 frames of the 720p walk: "
        f"corner error {', '.join(f'{e:.3f}' for e in errs)} px; launches "
        f"{launches}")
    if not all(np.isfinite(h).all() for h in hs):
        raise AssertionError("trained checkpoint: non-finite homography")
    check_counts("trained checkpoint", launches,
                 {"warp_perspective_bilinear": 4,
                  "corr_pyramid_lookup": 13 * 4},
                 ("warp_perspective_bilinear", "corr_pyramid_lookup"), 4, 4)
    return dict(launches=launches, corner_px=errs)


def check_local_grads(kernels, dev, init):
    """C, D and E under grad: one whole-net gradient at B = 1, 288x384,
    with the block-local path on the kernels (C forward, D and E forward;
    the plain versions' VJPs backward), held to the dense path's (B, B')
    on every parameter, float32, the trained weights."""
    from woft_tpu_torch.models.raft import (RaftConfig, init_raft_params,
                                            train_forward)

    H, W = TRAIN_HW
    model = init_raft_params(RaftConfig(), seed=0)
    model.load_state_dict(torch.load(init, map_location="cpu",
                                     weights_only=True))
    model.to(dev)
    img1 = torch.tensor(textured_frame(H, W, seed=30), dtype=torch.float32,
                        device=dev).flip(-1)[None].contiguous()
    shift = pose(0.01, 1.01, 3.0, -2.0, center=(W / 2, H / 2)).to(dev)
    from woft_tpu_torch.ops.warp import warp_perspective
    img2 = warp_perspective(img1, shift)
    gt = torch.randn((1, H, W, 2), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)

    def grads(cfg):
        model.zero_grad()
        zero_counts(kernels)
        out = train_forward(model, cfg, img1, img2)
        loss = ((out["flow_up"] - gt).abs().mean()
                + out["weights_up"].mean())
        loss.backward()
        torch.cuda.synchronize()
        return [p.grad.clone() for p in model.parameters()], \
            read_counts(kernels)

    dense, n_dense = grads(RaftConfig())
    local, n_local = grads(RaftConfig(corr_impl="local"))
    check_counts("local gradient", n_local,
                 {"local_corr_build": 1, "local_lookup_coords": 13,
                  "local_lookup_exact_coords": 13},
                 ("local_corr_build", "local_lookup_coords",
                  "local_lookup_exact_coords"))
    check_counts("dense gradient", n_dense,
                 {"corr_pyramid_lookup": 13,
                  "corr_pyramid_lookup_backward": 13},
                 ("corr_pyramid_lookup", "corr_pyramid_lookup_backward"))
    worst, worst_name = 0.0, ""
    for (name, _), a, b in zip(model.named_parameters(), local, dense):
        excess = ((a - b).abs() - LOCAL_GRAD_TOL * (1 + b.abs())).max()
        if excess.item() > worst or not worst_name:
            worst, worst_name = excess.item(), name
        if excess.item() > 0:
            raise AssertionError(f"C, D, E under grad: {name}'s gradient "
                                 f"differs from the dense path's by more "
                                 f"than atol = rtol = {LOCAL_GRAD_TOL}")
    err = max((a - b).abs().max().item() for a, b in zip(local, dense))
    log(f"C, D, E under grad (B = 1, 288x384, 12 iters, float32): every "
        f"parameter's gradient within atol = rtol = {LOCAL_GRAD_TOL} of "
        f"the dense path's; max abs difference {err:.3g}; launches "
        f"{n_local}")
    return dict(max_abs_err=err, launches=n_local)


def _recording_head(record):
    """``models/raft.py:weight_head_apply``, each ReLU's pre-activation
    appended to ``record`` (detached)."""
    from woft_tpu_torch.models import raft

    def apply(head, corr_sample, mean_response):
        B, H1, W1, Kp, _, L = corr_sample.shape
        n = B * H1 * W1
        x = corr_sample.reshape(n, Kp, Kp, L)
        mean = mean_response.reshape(n, 1, 1, 1).expand(n, Kp, Kp, 1)
        x = torch.cat([x, mean], dim=-1).permute(0, 3, 1, 2)
        for mod in head.net:
            if isinstance(mod, torch.nn.Conv2d):
                x = raft.conv(mod, x)
            else:
                record.append(x.detach())
                x = F.relu(x)
        return x.mean(dim=(2, 3)).reshape(B, H1, W1, 1)

    return apply


def check_train_card_vs_cpu(dev):
    """One weight-head-only step at 64x96, batch 2, 2 iterations,
    ``precision='highest'`` (grid subsampling: no data-dependent
    selection), on the card and on the CPU path with the same batch and
    weights: the loss and the weight head's gradients, relative to the
    largest, and where their difference arises. The head's ReLU
    pre-activations are recorded on both devices and their sign flips
    counted; the loss's gradient with respect to the upsampled weight map
    (``weights_up``, the head's output as the fit reads it) is compared;
    the card's head backward is run on the CPU's gradient of that map; and
    the fit and loss alone (``woft_loss`` on given flow and weights) run on
    the card from the CPU's flow and weights."""
    from woft_tpu_torch.models import raft
    from woft_tpu_torch.models.raft import RaftConfig, init_raft_params
    from woft_tpu_torch.training import train
    from woft_tpu_torch.training.synth import synth_homography_batch

    cfg = RaftConfig(iters=2)
    tcfg = train.TrainConfig(subsample="grid", max_tc=400)
    rng = np.random.default_rng(4)
    imgs = torch.tensor(rng.uniform(0, 255, (2, 64, 96, 3)),
                        dtype=torch.float32)
    batch = synth_homography_batch(torch.Generator().manual_seed(5), imgs,
                                   max_corner_shift=0.05)
    plain_head, plain_forward = raft.weight_head_apply, train.train_forward

    def patched(head=plain_head, forward=plain_forward):
        raft.weight_head_apply, train.train_forward = head, forward

    def step(d):
        model = init_raft_params(cfg, seed=0, device=d)
        tx = train.make_optimizer(model, tcfg)
        pre, out = [], {}

        def forward(*args, **kw):
            out.update(plain_forward(*args, **kw))
            return out

        patched(_recording_head(pre), forward)
        try:
            loss = train.woft_loss(model, cfg, tcfg,
                                   {k: v.to(d) for k, v in batch.items()})
        finally:
            patched()
        d_wu, *grads = torch.autograd.grad(
            loss, [out["weights_up"]] + tx.params, retain_graph=True)
        return dict(loss=loss.item(), grads=grads, d_wu=d_wu, pre=pre,
                    out=out, params=tx.params)

    cpu, card = step("cpu"), step(dev)

    def rel(got, want):
        return max((a.cpu() - b).abs().max().item() / b.abs().max().item()
                   for a, b in zip(got, want))

    flips = [int(((a > 0) != (b.cpu() > 0)).sum())
             for a, b in zip(cpu["pre"], card["pre"])]
    l_err = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    g_err = rel(card["grads"], cpu["grads"])
    wu_err = rel([card["out"]["weights_up"]], [cpu["out"]["weights_up"]])
    d_wu_err = rel([card["d_wu"]], [cpu["d_wu"]])
    # the card's head backward on the CPU's gradient of the weight map
    head_err = rel(torch.autograd.grad(
        card["out"]["weights_up"], card["params"], cpu["d_wu"].to(dev)),
        cpu["grads"])
    # the CPU's head backward on the card's gradient of the weight map
    map_err = rel(torch.autograd.grad(
        cpu["out"]["weights_up"], cpu["params"], card["d_wu"].cpu()),
        cpu["grads"])
    # the last layer's bias gradient is the map's gradient summed: how far
    # the sum cancels
    cancel = (cpu["d_wu"].sum().abs() / cpu["d_wu"].abs().sum()).item()
    # the fit and the loss alone on the card, from the CPU's flow and map
    given = {k: cpu["out"][k].detach().to(dev).requires_grad_(k != "flow_up")
             for k in ("flow_up", "weights_up")}
    patched(forward=lambda *args, **kw: given)
    try:
        fit_loss = train.woft_loss(None, cfg, tcfg,
                                   {k: v.to(dev) for k, v in batch.items()})
    finally:
        patched()
    fit_err = rel(torch.autograd.grad(fit_loss, given["weights_up"]),
                  [cpu["d_wu"]])
    log(f"one weight-head step 64x96 x2, card vs CPU: loss "
        f"{card['loss']:.6f} vs {cpu['loss']:.6f} (relative {l_err:.3g}), "
        f"head gradients {g_err:.3g} of their largest (tol "
        f"{TRAIN_CARD_CPU_REL}); the head's ReLU pre-activations change "
        f"sign at {flips} of {[a.numel() for a in cpu['pre']]}; weights_up "
        f"{wu_err:.3g} (tol {TRAIN_FORWARD_REL}), the loss's gradient of "
        f"weights_up {d_wu_err:.3g}, of which the fit and loss alone on the "
        f"CPU's flow and weights_up {fit_err:.3g} (tol {TRAIN_PART_REL}); "
        f"the head gradients the CPU's head backward gives from the card's "
        f"gradient of weights_up {map_err:.3g}, the card's head backward "
        f"from the CPU's {head_err:.3g} (tol {TRAIN_PART_REL}); that "
        f"gradient's sum (the last bias's) is {cancel:.3g} of its absolute "
        f"sum")
    if not (l_err <= TRAIN_CARD_CPU_REL and g_err <= TRAIN_CARD_CPU_REL):
        raise AssertionError("training step: the card disagrees with the CPU")
    if not (wu_err <= TRAIN_FORWARD_REL and fit_err <= TRAIN_PART_REL
            and head_err <= TRAIN_PART_REL):
        raise AssertionError("training step: the forward, the fit's "
                             "backward or the head's backward disagrees "
                             "with the CPU's")
    return dict(loss_rel=l_err, grad_rel=g_err, flips=flips,
                weights_up_rel=wu_err, d_weights_up_rel=d_wu_err,
                fit_alone_rel=fit_err, from_map_rel=map_err,
                head_backward_rel=head_err, cancel=cancel)


def track_training(kernels, corr, warp, dev):
    """The training phase. Returns its numbers."""
    import tempfile

    t_phase = time.perf_counter()
    out = {"bwd": check_lookup_backward(kernels, corr, dev)}
    init = os.path.join(ROOT, "weights", "wraft_tpu_v4_torch.pt")
    v4 = torch.load(init, map_location="cpu", weights_only=True)
    H, W = TRAIN_HW
    with tempfile.TemporaryDirectory() as tmp:
        images = os.path.join(tmp, "images")
        write_train_images(images)
        out["shapes"] = check_training_shapes(kernels, corr, warp, dev,
                                              images, init)
        common = ["--images", images, "--size", f"{H}x{W}", "--batch",
                  str(TRAIN_BATCH), "--steps", str(TRAIN_STEPS), "--iters",
                  "12", "--log-every", "1", "--val-every",
                  str(TRAIN_VAL_EVERY), "--ckpt-every", str(TRAIN_VAL_EVERY)]
        n_val = len(range(0, TRAIN_STEPS, TRAIN_VAL_EVERY))
        head = os.path.join(tmp, "head.pt")
        log(f"--- train_wraft_torch.py: WeightedRAFT-large, {H}x{W}, batch "
            f"{TRAIN_BATCH}, 12 iters, precision 'default', weight head "
            f"only, lr 1e-3, from the v4 export")
        runs = {"weight head": train_run(kernels, dev, common + [
            "--lr", "1e-3", "--init", init, "--out", head])}
        after = torch.load(head, map_location="cpu", weights_only=True)
        for k, v in v4.items():
            head_key = k.split(".")[0] in ("weight_head", "mask_head")
            if not head_key and not torch.equal(after[k], v):
                raise AssertionError(f"weight-head training moved frozen {k}")
        if not any(not torch.equal(after[k], v) for k, v in v4.items()
                   if k.startswith("weight_head.")):
            raise AssertionError("weight-head training left the head as is")
        full = os.path.join(tmp, "full.pt")
        log("--- train_wraft_torch.py --train-flow: the whole net, lr 1e-5, "
            "from the weight-head run's checkpoint")
        runs["whole net"] = train_run(kernels, dev, common + [
            "--lr", "1e-5", "--train-flow", "--init", head, "--out", full])
        trained = torch.load(full, map_location="cpu", weights_only=True)
        still = [k for k, v in after.items() if v.is_floating_point()
                 and not k.endswith(("running_mean", "running_var"))
                 and torch.equal(trained[k], v)]
        if still:
            raise AssertionError(f"--train-flow left {len(still)} parameters "
                                 f"as they were: {still[:4]}")
        # a step: one render (A) and 13 lookups (B); each validation: 13
        # lookups (its render was one more A, at set-up); B' 13 a step
        # with --train-flow, none for the weight head alone
        for what, res in runs.items():
            want = {"warp_perspective_bilinear": TRAIN_STEPS + 1,
                    "corr_pyramid_lookup": 13 * (TRAIN_STEPS + n_val),
                    "corr_pyramid_lookup_backward":
                        13 * TRAIN_STEPS if what == "whole net" else 0}
            check_counts(f"training ({what})", res["launches"], want,
                         tuple(want), TRAIN_STEPS, TRAIN_STEPS + n_val)
        out["runs"] = runs
        torch.cuda.empty_cache()
        out["tracked"] = track_trained(kernels, dev, full)
    torch.cuda.empty_cache()
    out["local"] = check_local_grads(kernels, dev, init)
    out["card_vs_cpu"] = check_train_card_vs_cpu(dev)
    log(f"training phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# RAFT-small through every tracker step (check_small_tracking)
# ---------------------------------------------------------------------------

SMALL_RADIUS = 3                 # RAFT-small's lookup radius (RaftConfig)
SMALL_TRAIN_STEPS = 100          # 12-19 s on an H100 (0.12-0.19 s a step)
SMALL_VAL_EVERY = 50             # validation EPE at steps 0 and 50
SMALL_FRAMES = 8                 # frames of the walk each step tracks
SMALL_SCALE_FRAMES = 4           # frames of the sharded RAFT-small case
SMALL_WINDOW_FRAME = (1080, 1920)        # the window steps' frames
SMALL_WINDOW = (192, 344)        # bench.py's window at 1920x1080
# The card and the plain path run the same step on the same frames, with
# kernels A and B in one and their plain versions in the other; A and B
# are exact, so the two should agree bit for bit. But the rest of the step
# is cuDNN's, which may pick another algorithm for a shape on the second
# run (its heuristics see the free memory), and an untrained network's
# inlier fraction can sit on the 20 % threshold, where a last-bit
# difference flips a check: one frame in eight may differ; more would be
# systematic.
SMALL_OK_FLIPS_PER_8 = 1


def _small_conf(ckpt, config="WOFT.py"):
    """``served_conf`` of the RAFT-small checkpoint ``ckpt`` with
    ``class_params.small`` set, as a user serves a ``train_wraft_torch.py
    --small`` checkpoint."""
    conf = served_conf(ckpt, config)
    conf.flow_config.class_params.small = True
    return conf


class PlainKernels:
    """Within the block, kernels A, B, L and N's wrappers are their plain
    versions on the card's tensors: the same step runs with nothing of the
    four kernels in it, and launches nothing that is counted."""

    def __init__(self, kernels, warp, corr):
        self.kernels, self.warp, self.corr = kernels, warp, corr

    def _warp(self, img, hinv, out_h, out_w):
        ys, xs = torch.meshgrid(
            torch.arange(out_h, dtype=torch.float32, device=img.device),
            torch.arange(out_w, dtype=torch.float32, device=img.device),
            indexing="ij")
        sx, sy = self.warp._back_project(hinv, xs, ys)
        return self.warp.grid_sample(img, torch.stack([sx, sy], -1))

    def _lookup(self, pyramid, coords, radius, rows=None):
        out = self.corr.corr_lookup_plain(pyramid, coords, radius, rows)
        return out.reshape(coords.numel() // 2, -1)     # the kernel's shape

    @staticmethod
    def _select(valid, table):
        from woft_tpu_torch.ops import sampling
        return sampling.masked_sobol_gather_plain(valid, table.numel())

    def __enter__(self):
        k = self.kernels
        self.saved = (k.warp_perspective_bilinear, k.corr_pyramid_lookup,
                      k.instance_norm_act, k.masked_sobol_select)
        (k.warp_perspective_bilinear, k.corr_pyramid_lookup,
         k.instance_norm_act, k.masked_sobol_select) = (
            self._warp, self._lookup, k.instance_norm_act_plain, self._select)
        return self

    def __exit__(self, *exc):
        k = self.kernels
        (k.warp_perspective_bilinear, k.corr_pyramid_lookup,
         k.instance_norm_act, k.masked_sobol_select) = self.saved


class TcValidity:
    """Records the TC validity mask of every selection the steps make
    (``_select_tcs``: the full-frame, shared and window steps and their
    fallbacks) as a host copy."""

    def __init__(self):
        from woft_tpu_torch.tracker import window_step as tws
        from woft_tpu_torch.tracker import woft as tw
        self.modules = (tw, tws)
        self.masks = []

    def __enter__(self):
        select = self.select = self.modules[0]._select_tcs

        def recording(flow, weights, valid, n):
            self.masks.append(valid.reshape(-1, valid.shape[-1]).cpu())
            return select(flow, weights, valid, n)

        for m in self.modules:
            m._select_tcs = recording
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m._select_tcs = self.select


def check_lookup_radius3(kernels, corr, dev):
    """Kernel B at radius 3, RAFT-small's, against its plain version:
    dense at Q = 14,400 (1280x720) and on the 24x43 window grid (Q =
    1,032), exact; timed at 720p beside its plain version, one
    ``F.grid_sample`` a level and its byte bound."""
    radius = SMALL_RADIUS
    err = 0.0
    for h1, w1 in ((H_IMG // 8, W_IMG // 8), WINDOW_GRIDS[0]):
        pyramid, coords, _, _ = lookup_case(corr, dev, h1, w1)
        want = corr.corr_lookup_plain(pyramid, coords, radius)
        got = kernels.corr_pyramid_lookup(pyramid, coords, radius)
        torch.cuda.synchronize()
        e = (got.reshape(want.shape) - want).abs().max().item()
        log(f"kernel B [radius {radius}, dense {h1}x{w1}, Q={h1 * w1}]: "
            f"max_abs_err {e:.3g} (exact)")
        if e != 0.0:
            raise AssertionError(f"kernel B at radius {radius} ({h1}x{w1}) "
                                 f"disagrees: {e}")
        err = max(err, e)
    pyramid, coords, _, _ = lookup_case(corr, dev, H_IMG // 8, W_IMG // 8)
    Q = coords.numel() // 2
    flat = coords.reshape(Q, 2)
    k = 2 * radius + 1
    n_out = Q * len(pyramid) * k * k
    ms = time_ms(lambda: kernels.corr_pyramid_lookup(pyramid, coords,
                                                     radius))
    plain_ms = time_ms(lambda: corr.corr_lookup_plain(pyramid, coords,
                                                       radius))
    library_ms = time_ms(lambda: _grid_sample_levels(pyramid, flat, radius))
    window = _window_bytes(pyramid, flat, None, radius)
    bnd, by = bound_ms(window + Q * 8 + n_out * 4, n_out * 18)
    log(f"kernel B timing [radius {radius}, dense Q={Q}]: kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, F.grid_sample x4 levels "
        f"{library_ms:.4f} ms, bound {bnd:.4f} ms ({by}: windows "
        f"{window / 1e6:.1f} MB)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=library_ms)


def _small_runs(what, run, kernels, warp, corr, poses, corners, want_of):
    """One step of the RAFT-small phase, twice on the same frames: on the
    card counted from 0, then through the plain path (``PlainKernels``).
    ``run() -> (hs (T, N, 3, 3), oks (T, N), flows)``; ``want_of(flows)``
    the launches expected. Holds H to ``CORNER_TOL_PX`` on the frames
    where both pass, and on every frame before the first whose ok flags
    differ (the two states are the same until then, whichever H the
    ladder took), and the ok flags to ``SMALL_OK_FLIPS_PER_8``; counts the
    TC points whose validity flipped; prints the corner error against the
    walk as a fact about an untrained network."""
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with TcValidity() as card_tc:
        hs, oks, flows = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts(kernels)
    zero_counts(kernels)
    with PlainKernels(kernels, warp, corr), TcValidity() as plain_tc:
        hs_p, oks_p, _ = run()
    torch.cuda.synchronize()
    plain_launches = read_counts(kernels)
    if any(plain_launches.values()):
        raise AssertionError(f"{what}: the plain path launched "
                             f"{plain_launches}")
    T, N = oks.shape
    flips = [[int((a != b).sum()) for a, b in zip(*pair)]
             for pair in zip(card_tc.masks, plain_tc.masks)]
    differ = (oks != oks_p).any(axis=1)
    same_state = np.cumsum(differ) == 0
    held = (oks & oks_p) | same_state[:, None]
    px = [h_diff_px(hs[t, n], hs_p[t, n], corners[n])
          for t in range(T) for n in range(N) if held[t, n]]
    ok_diff = int(differ.sum())
    errs = [corner_errors(list(hs[:, n]), poses, corners[n])
            for n in range(N)]
    log(f"RAFT-small, {what}: checks passed card {int(oks.sum())}, plain "
        f"{int(oks_p.sum())} of {T * N}; frames whose ok flags differ "
        f"{ok_diff} of {T} (allowed {SMALL_OK_FLIPS_PER_8 * T // 8}); H "
        f"card vs plain on {len(px)} of {T * N} (both passed, or before "
        f"the first difference) {max(px) if px else 0.0:.3g} px (tol "
        f"{CORNER_TOL_PX}); TC points "
        f"whose validity flipped, by selection {flips}; {secs:.2f} s on the "
        f"card; launches {({k: v for k, v in launches.items() if v})} in "
        f"{flows} flows (every other kernel 0); corner error against the "
        f"walk {max(max(e) for e in errs):.3f} px (not held: no trained "
        f"RAFT-small weights)")
    if not all(np.isfinite(h).all() for h in hs):
        raise AssertionError(f"RAFT-small {what}: non-finite homography")
    if px and not max(px) <= CORNER_TOL_PX:
        raise AssertionError(f"RAFT-small {what}: the card is {max(px)} px "
                             f"from the plain path")
    if ok_diff > SMALL_OK_FLIPS_PER_8 * T // 8:
        raise AssertionError(f"RAFT-small {what}: ok flags differ on "
                             f"{ok_diff} of {T} frames")
    want = want_of(flows)
    check_counts(f"RAFT-small {what}", launches, want, tuple(want), T, flows)
    return dict(launches=launches, seconds=secs, card_vs_plain_px=px,
                ok_flags_differ=ok_diff, validity_flips=flips,
                corner_px=errs)


def track_small_steps(kernels, warp, corr, dev, ckpt):
    """The four tracker steps on a RAFT-small checkpoint served through
    ``WOFT.py`` with ``class_params.small``: the single step
    (``WOFTTracker``) and the shared step x2 at 1280x720, the window step
    and the window batch x2 at 1920x1080 with the 192x344 window, each on
    8 frames of the walk (``_small_runs``)."""
    from woft_tpu_torch.flow import RaftFlow
    from woft_tpu_torch.pipeline import MultiTargetTracker, SharedMultiTracker
    from woft_tpu_torch.tracker import (WOFTTracker, build_window_track_step,
                                        window_init_state,
                                        window_params_for_mask)

    conf = _small_conf(ckpt)
    flower = RaftFlow(conf.flow_config, device=dev)
    model, cfg, tp = flower.model, flower.cfg, conf.tracker_params
    if not (cfg.small and cfg.radius == SMALL_RADIUS):
        raise AssertionError(f"WOFT.py with class_params.small gave {cfg}")
    T = SMALL_FRAMES
    out = {}

    template, frames, poses = walk(H_IMG, W_IMG, dev, n=T)
    mask, corners = centred_mask(H_IMG, W_IMG, 0.5)

    def single():
        tracker = WOFTTracker(conf, device=dev)
        tracker.init(template, mask)
        hs, oks = [], []
        for f in frames:
            H, meta = tracker.track(f)
            hs.append([H])
            oks.append([bool(meta.global_H_success)])
        oks = np.array(oks)
        return np.array(hs), oks, T + int((~oks).sum())

    # a frame: A once (the pre-warp); a flow: B 13 times (12 iterations and
    # the dense weight head's lookup), the failed checks' fallback flows too
    frame = f"{W_IMG}x{H_IMG}"
    out[f"single step {frame}"] = _small_runs(
        f"single step (WOFTTracker) at {frame}", single, kernels, warp,
        corr, poses, [corners], lambda flows: {
            "warp_perspective_bilinear": T,
            "corr_pyramid_lookup": 13 * flows})

    masks, corners_s = scale_masks(H_IMG, W_IMG)
    masks, corners_s = masks[:2], corners_s[:2]

    def shared():
        tracker = SharedMultiTracker(model, cfg, tp, device=dev)
        tracker.init(template, masks)
        hs, oks = zip(*[(h, m["global_H_success"])
                        for h, m in map(tracker.track, frames)])
        return np.array(hs, np.float64), np.array(oks), T

    out[f"shared x2 {frame}"] = _small_runs(
        f"shared step x2 at {frame}", shared, kernels, warp, corr, poses,
        corners_s, lambda flows: {"warp_perspective_bilinear": T,
                                  "corr_pyramid_lookup": 13 * T})
    del template, frames

    h, w = SMALL_WINDOW_FRAME
    template, frames, poses = walk(h, w, dev, n=T)
    mask, corners = centred_mask(h, w, 1 / 3)
    wp = window_params_for_mask(mask, size=256)
    if wp.shape != SMALL_WINDOW:
        raise AssertionError(f"window {wp.shape}, not {SMALL_WINDOW}")

    def rgb(bgr):
        return torch.from_numpy(np.ascontiguousarray(
            bgr[..., ::-1])).to(dev).to(torch.float32)[None]

    def window():
        step = build_window_track_step(cfg, tp, wp)
        state = window_init_state(model, cfg, tp, wp, rgb(template), mask)
        hs, oks = [], []
        for f in frames:
            state, H, meta = step(model, state, rgb(f))
            hs.append([H.cpu().numpy().astype(np.float64)])
            oks.append([bool(meta["global_H_success"])])
        oks = np.array(oks)
        return np.array(hs), oks, T + int((~oks).sum())

    # a frame: A twice (the crop and the pre-warp), once at the init (the
    # template crop); B 13 times a flow, the fallback's too
    frame = f"{w}x{h}"
    out[f"window step {frame}"] = _small_runs(
        f"window step at {frame}, window {wp.shape[0]}x{wp.shape[1]}",
        window, kernels, warp, corr, poses, [corners], lambda flows: {
            "warp_perspective_bilinear": 2 * T + 1,
            "corr_pyramid_lookup": 13 * flows})

    masks = window_masks(2, h, w)
    corners_b = [mask_corners(m) for m in masks]

    def batch():
        tracker = MultiTargetTracker(model, cfg, tp, wp, device=dev)
        tracker.init(template, masks)
        hs, oks = zip(*[(hb, m["global_H_success"])
                        for hb, m in map(tracker.track, frames)])
        return np.array(hs, np.float64), np.array(oks), T

    # one B = 2 forward a frame; A: the 2 crops in one launch, the 2
    # pre-warps in one, and the 2 template crops once each at the init
    out[f"window batch x2 {frame}"] = _small_runs(
        f"window batch x2 at {frame}, window {wp.shape[0]}x{wp.shape[1]}",
        batch, kernels, warp, corr, poses, corners_b, lambda flows: {
            "warp_perspective_bilinear": 2 * T + 2,
            "corr_pyramid_lookup": 13 * T})
    return out


def check_small_tracking(kernels, corr, warp, dev, ckpt):
    """The RAFT-small phase: kernel B at radius 3 against its plain version
    (``check_lookup_radius3``); ``train_wraft_torch.py --small
    --train-flow`` from seeded weights at 288x384, batch 4, on the textured
    pngs, counted from 0, its checkpoint written to ``ckpt`` (the
    scale-out phase tracks it too); that checkpoint through the four
    tracker steps (``track_small_steps``). Returns the numbers."""
    import tempfile

    t_phase = time.perf_counter()
    out = {"B": check_lookup_radius3(kernels, corr, dev)}
    H, W = TRAIN_HW
    n_val = len(range(0, SMALL_TRAIN_STEPS, SMALL_VAL_EVERY))
    with tempfile.TemporaryDirectory() as tmp:
        images = os.path.join(tmp, "images")
        write_train_images(images)
        log(f"--- train_wraft_torch.py --small --train-flow: RAFT-small, "
            f"{H}x{W}, batch {TRAIN_BATCH}, 12 iters, precision 'default', "
            f"lr 1e-3, --epe-weight 1, {SMALL_TRAIN_STEPS} steps from "
            f"seeded weights")
        res = train_run(kernels, dev, [
            "--images", images, "--size", f"{H}x{W}", "--batch",
            str(TRAIN_BATCH), "--steps", str(SMALL_TRAIN_STEPS), "--iters",
            "12", "--small", "--train-flow", "--epe-weight", "1",
            "--log-every", str(SMALL_VAL_EVERY), "--val-every",
            str(SMALL_VAL_EVERY), "--out", ckpt])
        want = {"warp_perspective_bilinear": SMALL_TRAIN_STEPS + 1,
                "corr_pyramid_lookup": 13 * (SMALL_TRAIN_STEPS + n_val),
                "corr_pyramid_lookup_backward": 13 * SMALL_TRAIN_STEPS}
        check_counts("RAFT-small training", res["launches"], want,
                     tuple(want), SMALL_TRAIN_STEPS, SMALL_TRAIN_STEPS + n_val)
        out["train"] = dict(
            first_loss=float(res["losses"][0]),
            last_loss=float(res["losses"][-1]),
            val=res["val"], steady_s=res["steady_s"],
            launches=res["launches"])
    t_steps = time.perf_counter()
    torch.cuda.empty_cache()
    out["steps"] = track_small_steps(kernels, warp, corr, dev, ckpt)
    log(f"RAFT-small phase: {time.perf_counter() - t_phase:.1f} s, the four "
        f"steps {time.perf_counter() - t_steps:.1f} s of it")
    return out


# ---------------------------------------------------------------------------
# scale-out (track_scale_out)
# ---------------------------------------------------------------------------

SCALE_FRAMES = 8                 # frames of the walk a stream tracks
SCALE_STREAMS = 2                # streams a rank (and in the NCCL run)
SCALE_BAND_B0 = 60               # rank 1's first block at 720p (120 / 2)
# each stream's own target: (y0, y1, x0, x1) fractions of the frame
SCALE_BOXES = ((0.25, 0.75, 0.25, 0.75), (0.15, 0.55, 0.1, 0.5),
               (0.45, 0.85, 0.5, 0.9), (0.2, 0.6, 0.55, 0.95))
SHARD_LOOKUP_TOL = 1e-5          # B on two column shards, summed, against
                                 # the whole level: the four taps' sum in
                                 # another association, and the shifted
                                 # x rounded once
# bounds of the sharded runs against their single-process twins on the
# card (NVIDIA H100 80GB HBM3, 700 W; this script's readings), each some
# five times the reading; two processes may pick other cuDNN algorithms
GLOO_TRACK_TOL_PX = 1e-3         # read 0
SP_PYRAMID_TOL = 1e-3            # flow_up px and weights_up; read 1.8e-4
                                 # and 1.4e-4 (the shard's products have
                                 # another shape; x shifted)
SP_LOCAL_TOL = 1e-3              # flow_up px and weights_up; read 0
# the training step (AdamW, lr 1e-5, 'default' precision): the loss
# relative, and each parameter relative to its tensor's largest magnitude
# where the single step's gradient is above 1e-5 (AdamW's eps regime
# otherwise: held to 2 lr, a flipped sign). NCCL's one rank runs the batch
# of 4 as the single step does (read 0 and 1.7e-7: the backward's sums
# vary between calls); each gloo rank runs 2 rows, and the forward's TF32
# convolutions at batch 2 against batch 4 (read 3.7e-5 and 2.1e-4)
DP_SAME_BATCH_REL = (1e-6, 1e-6)
DP_HALF_BATCH_REL = (2e-4, 1e-3)


def scale_masks(h=H_IMG, w=W_IMG):
    """The streams' targets: (4, h, w) bool boxes and their corners (4, 2,
    4), inclusive."""
    masks = np.zeros((len(SCALE_BOXES), h, w), bool)
    corners = []
    for m, (y0, y1, x0, x1) in zip(masks, SCALE_BOXES):
        y0, y1, x0, x1 = int(y0 * h), int(y1 * h), int(x0 * w), int(x1 * w)
        m[y0:y1, x0:x1] = True
        corners.append([[x0, x1 - 1, x1 - 1, x0], [y0, y0, y1 - 1, y1 - 1]])
    return masks, np.asarray(corners, np.float64)


def _scale_tracker(dev, config="WOFT.py", small_ckpt=None):
    """(model, RaftConfig, TrackerParams) of ``configs/<config>``; with
    ``small_ckpt`` RAFT-small on that checkpoint (``_small_conf``)."""
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow import RaftFlow
    conf = (_small_conf(small_ckpt, config) if small_ckpt else
            load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                     config)))
    flower = RaftFlow(conf.flow_config, device=dev)
    return flower.model, flower.cfg, conf.tracker_params


def scale_track(kernels, step, model, cfg, tp, template, frames, masks, dev):
    """``sharded_track_batch``'s ``step`` over ``len(masks)`` streams of
    the walk, each its own target, counted from 0. Returns (hs (frames,
    streams, 3, 3) float64, launches, seconds, flows)."""
    from woft_tpu_torch.flow.wrapper import upload_bgr
    from woft_tpu_torch.tracker.woft import tracker_init_state

    tmpl = upload_bgr(template, dev)
    states = [tracker_init_state(model, cfg, tp, tmpl,
                                 torch.from_numpy(m).to(dev)) for m in masks]
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs, flows = [], 0
    for f in frames:
        batch = upload_bgr(f, dev).expand(len(masks), -1, -1, -1)[:, None]
        states, h, metas = step(model, states, batch)
        flows += sum(1 + (not m["global_H_success"]) for m in metas)
        hs.append(h.double().cpu().numpy())
    torch.cuda.synchronize()
    return (np.stack(hs), read_counts(kernels), time.perf_counter() - t0,
            flows)


def single_streams(model, cfg, tp, template, frames, masks, dev):
    """The per-stream ``build_track_step`` twin: each stream alone over the
    frames. Returns hs (frames, streams, 3, 3) float64."""
    from woft_tpu_torch.flow.wrapper import upload_bgr
    from woft_tpu_torch.tracker.woft import build_track_step, \
        tracker_init_state

    step = build_track_step(cfg, tp)
    tmpl = upload_bgr(template, dev)
    out = []
    for m in masks:
        state = tracker_init_state(model, cfg, tp, tmpl,
                                   torch.from_numpy(m).to(dev))
        hs = []
        for f in frames:
            state, h, _ = step(model, state, upload_bgr(f, dev))
            hs.append(h.double().cpu().numpy())
        out.append(hs)
    return np.asarray(out).transpose(1, 0, 2, 3)


def stream_px(ha, hb, corners):
    """The largest distance (px) between the stream targets' corners
    mapped by two H sets (frames, streams, 3, 3)."""
    def proj(H, pts):
        p = H @ np.vstack([pts, np.ones(pts.shape[1])])
        return p[:2] / p[2:]

    return max(float(np.linalg.norm(proj(a, c) - proj(b, c), axis=0).max())
               for fa, fb in zip(ha, hb) for a, b, c in zip(fa, fb, corners))


def scale_train_batch(dev):
    """The training phase's global batch: 4 textured 288x384 crops, the
    synthetic pairs drawn on the card from seed 3 (numpy, CPU)."""
    from woft_tpu_torch.training.synth import synth_homography_batch

    h, w = TRAIN_HW
    imgs = np.stack([textured_frame(h, w, seed=30 + i)[..., ::-1]
                     for i in range(TRAIN_BATCH)]).astype(np.float32)
    batch = synth_homography_batch(torch.Generator(device=dev).manual_seed(3),
                                   torch.from_numpy(imgs).to(dev))
    return {k: v.cpu().numpy() for k, v in batch.items()}


def scale_train_model(dev):
    """WeightedRAFT-large from the v4 export, 'default' precision, 12
    iterations, its optimizer for the whole net (``--train-flow``, lr
    1e-5) with the gradients it is handed recorded."""
    import train_wraft_torch
    from woft_tpu_torch.models.raft import RaftConfig, init_raft_params
    from woft_tpu_torch.training.train import TrainConfig, init_train_state

    cfg = RaftConfig(variant="weighted", iters=12, precision="default")
    tcfg = TrainConfig(learning_rate=1e-5, train_flow=True)
    model = init_raft_params(cfg, seed=0)
    train_wraft_torch.load_init(model, os.path.join(
        ROOT, "weights", "wraft_tpu_v4_torch.pt"))
    model.to(dev)
    tx, state = init_train_state(model, tcfg)
    seen = {}
    update = tx.update

    def recording(grads, st, loss=None):
        seen.update({n: g.detach().clone() for n, g in zip(tx.names,
                                                            grads)})
        return update(grads, st, loss)

    tx.update = recording
    return model, cfg, tcfg, tx, state, seen


def _train_rows(batch, mesh, dev):
    from woft_tpu_torch.parallel import shard_batch
    rows = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    if mesh is not None:
        rows = shard_batch(mesh, rows)
    rows["generator"] = torch.Generator(device=dev).manual_seed(17)
    return rows


def _named_cpu(model):
    return {n: p.detach().cpu() for n, p in model.named_parameters()}


def single_train_step(dev, batch):
    """The plain single-process step on the whole batch: (loss, gradients,
    parameters after it)."""
    from woft_tpu_torch.training.train import make_train_step

    model, cfg, tcfg, tx, state, seen = scale_train_model(dev)
    loss = make_train_step(model, cfg, tcfg, tx)(state, _train_rows(
        batch, None, dev))
    return float(loss), {n: g.cpu() for n, g in seen.items()}, \
        _named_cpu(model)


def compare_train(what, got, want, bounds, lr=1e-5):
    """A sharded step's (loss, gradients, parameters) against the single
    step's: the loss to ``bounds[0]`` relative; each parameter to
    ``bounds[1]`` of its tensor's largest magnitude where the single
    step's gradient exceeds 1e-5, and to ``2 lr`` elsewhere (the AdamW
    step ``lr * g / (|g| + 1e-8)`` amplifies the rounding of small
    gradients, up to a flipped sign). Logs the gradients' largest gap
    against the largest gradient of their part of the network. Returns the
    numbers it logs."""
    loss, grads, params = got
    loss0, grads0, params0 = want
    rel = abs(loss - loss0) / abs(loss0)
    worst, loose, gmax = 0.0, 0, 0.0
    part = {}
    for n, g0 in grads0.items():
        key = n.split(".")[0]
        part[key] = max(part.get(key, 0.0), g0.abs().max().item())
    g_rel = max((grads[n] - g0).abs().max().item() / part[n.split(".")[0]]
                for n, g0 in grads0.items())
    for n, p0 in params0.items():
        err = (params[n] - p0).abs()
        tight = grads0[n].abs() > 1e-5
        scale = p0.abs().max().item()
        if err[tight].numel():
            worst = max(worst, err[tight].max().item() / scale)
        loose += int((~tight).sum())
        gmax = max(gmax, err.max().item())
    log(f"{what}: loss {loss:.6f} against {loss0:.6f} ({rel:.3g} relative); "
        f"gradients {g_rel:.3g} of their part's largest; parameters, where "
        f"|g| > 1e-5: {worst:.3g} of each tensor's largest; the {loose} "
        f"entries with |g| <= 1e-5: largest gap {gmax:.3g} (lr {lr})")
    if not (rel <= bounds[0] and worst <= bounds[1]
            and gmax <= 2 * lr * (1 + 1e-3)):
        raise AssertionError(f"{what}: the sharded step differs from the "
                             f"single step")
    return dict(loss_rel=rel, grad_rel=g_rel, param_rel=worst,
                eps_regime_entries=loose, largest_gap=gmax)


def scale_out_rank(rank, world, device, job):
    """One of the two ``gloo`` ranks, both on ``cuda:0``: (a) 2 streams of
    ``sharded_track_batch`` under ``WOFT.py`` (dp = 2), (a') stream
    ``rank`` of the RAFT-small checkpoint ``job["small_ckpt"]``, 4 frames,
    (b) the pyramid
    form of ``spatial_sharded_forward`` under ``WOFT.py`` and (c) its
    block-local form under ``WOFT_fast.py`` (sp = 2), (d) one
    ``sharded_train_step`` on 2 rows of the batch of 4 (dp = 2); each
    counted from 0."""
    sys.path.insert(0, ROOT)
    from woft_tpu_torch.device import resolve_device
    from woft_tpu_torch.flow.wrapper import upload_bgr
    from woft_tpu_torch.ops import kernels
    from woft_tpu_torch.parallel import (
        gather_streams, make_mesh, sharded_track_batch, sharded_train_step,
        spatial_sharded_forward)

    dev = resolve_device(str(device))
    kernels.build()          # built by the parent: loads its libraries
    out = {}
    dp_mesh = make_mesh(sp=1, device=dev)
    sp_mesh = make_mesh(sp=2, device=dev)

    model, cfg, tp = _scale_tracker(dev)
    mine = job["masks"][rank * SCALE_STREAMS:(rank + 1) * SCALE_STREAMS]
    step = sharded_track_batch(dp_mesh, cfg, tp)
    hs, launches, secs, flows = scale_track(
        kernels, step, model, cfg, tp, job["template"], job["frames"], mine,
        dev)
    all_hs = gather_streams(dp_mesh, torch.from_numpy(hs).permute(
        1, 0, 2, 3).float().to(dev).contiguous())
    out["track"] = dict(hs=hs, all_hs=all_hs.cpu().numpy(),
                        launches=launches, seconds=secs, flows=flows)
    # (a') RAFT-small: this rank's one stream of 4 frames
    s_model, s_cfg, s_tp = _scale_tracker(dev, small_ckpt=job["small_ckpt"])
    hs, launches, secs, flows = scale_track(
        kernels, sharded_track_batch(dp_mesh, s_cfg, s_tp), s_model, s_cfg,
        s_tp, job["template"], job["frames"][:SMALL_SCALE_FRAMES],
        job["masks"][rank:rank + 1], dev)
    out["small"] = dict(hs=hs, launches=launches, flows=flows)
    del s_model

    img1 = upload_bgr(job["template"], dev)
    img2 = upload_bgr(job["frames"][0], dev)
    for form, (m, c) in (("pyramid", (model, cfg)),
                         ("block-local", _scale_tracker(dev,
                                                        "WOFT_fast.py")[:2])):
        fwd = spatial_sharded_forward(sp_mesh, c)
        with torch.no_grad():
            fwd(m, img1, img2)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        fwd.shard.reduces = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            flow_up, weights_up = fwd(m, img1, img2)
        torch.cuda.synchronize()
        out[form] = dict(
            flow_up=flow_up.cpu().numpy(), weights_up=weights_up.cpu().numpy(),
            ms=(time.perf_counter() - t0) * 1e3,
            launches=read_counts(kernels),
            volume_bytes=fwd.shard.volume_bytes,
            reduce_bytes=fwd.shard.reduce_bytes, reduces=fwd.shard.reduces,
            blocks=fwd.shard.blocks,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del model
    torch.cuda.empty_cache()

    tmodel, tcfg_r, tcfg, tx, state, seen = scale_train_model(dev)
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = sharded_train_step(dp_mesh, tmodel, tcfg_r, tcfg, tx)(
        state, _train_rows(job["batch"], dp_mesh, dev))
    loss = float(loss)
    out["train"] = dict(
        step=(loss, {n: g.cpu() for n, g in seen.items()},
              _named_cpu(tmodel)),
        seconds=time.perf_counter() - t0, launches=read_counts(kernels))
    return out


def check_band_kernels(kernels, corr, dev):
    """Kernels C, D, E on rank 1's band of the 720p grid (blocks 60-119,
    ``b0`` = 60) against their plain versions (C within one bf16 ulp, D
    and E exact) and against the matching rows of the whole-grid launch
    (exact); C's plan keyed on ``b0`` (the same pointers at ``b0`` = 0
    after a band launch compute blocks 0-59); kernel B on two key-column
    shards with x shifted, summed, against the whole-level lookup. Each
    timed at the band or shard shape beside its bound, its plain version
    and a library call. Returns {kernel: row}."""
    H1, W1 = H_IMG // 8, W_IMG // 8
    dt = torch.bfloat16
    b0 = SCALE_BAND_B0
    rows = {}
    meta, f1b, lvs, geoms = _local_corr_case(corr, dev, H1, W1, dt)
    nbh, nbw = meta["nbh"], meta["nbw"]
    nb = nbh * nbw - b0
    whole = [v.clone() for v in kernels.local_corr_build(
        f1b, lvs, geoms, nbh, nbw, dt)]
    band_f1b = f1b[b0:].contiguous()
    n0 = kernels.local_corr_build.launches
    band = kernels.local_corr_build(band_f1b, lvs, geoms, nbh, nbw, dt, b0)
    torch.cuda.synchronize()
    if kernels.local_corr_build.launches != n0 + 1:
        raise AssertionError("kernel C's band took more than one launch")
    err_c = 0.0
    for d, lv, got, w in zip(meta["levels"], lvs, band, whole):
        if not torch.equal(got, w[b0:]):
            raise AssertionError("kernel C's band differs from the whole "
                                 "grid's rows")
        want = corr.block_local_corr_plain(band_f1b, lv, d, nbh, nbw, dt, b0)
        diff = (got.float() - want.float()).abs()
        if int((diff > CORR_ATOL + CORR_RTOL_BF16
                * want.float().abs()).sum()):
            raise AssertionError("kernel C's band disagrees with its plain "
                                 "version")
        err_c = max(err_c, diff.max().item())
    del band
    # the same pointers at b0 = 0: the kept plan must not serve it
    again = kernels.local_corr_build(band_f1b, lvs, geoms, nbh, nbw, dt)
    want0 = corr.block_local_corr_plain(band_f1b, lvs[0], meta["levels"][0],
                                        nbh, nbw, dt)
    torch.cuda.synchronize()
    stale = (again[0].float() - want0.float()).abs().max().item()
    log(f"kernel C [720p band, blocks {b0}-{nbh * nbw - 1}, bf16]: equal to "
        f"the whole grid's rows; against its plain version max_abs_err "
        f"{err_c:.3g}; the same pointers at b0 = 0 after it: max_abs_err "
        f"{stale:.3g} against blocks 0-{nb - 1}")
    if not stale <= 0.05:
        raise AssertionError("kernel C reused the band's plan at b0 = 0")
    rows["C"] = dict(max_abs_err=err_c, **_time_local_corr(
        kernels, corr, (meta, band_f1b, lvs, geoms), dt, BF16_FLOPS,
        f"720p band b0={b0}", b0))
    del whole, again

    g = torch.Generator(device=dev).manual_seed(12)
    f1 = torch.randn(1, H1, W1, 256, device=dev, generator=g)
    f2 = torch.randn(1, H1, W1, 256, device=dev, generator=g)
    local = corr.build_local_corr(f1, f2, 4, 4, 16, out_dtype=dt)
    band = corr.LocalCorrVolumes([v[b0:].contiguous() for v in local.volumes],
                                 local.meta, b0)
    table = local.consts["table"]
    errs = {"D": 0.0, "E": 0.0}
    for kind in ("smooth", "violating"):
        coords = _local_coords(dev, kind)
        d_all, bad_all = kernels.local_lookup_coords(coords, local.volumes,
                                                     table, 9, dt)
        got, bad = kernels.local_lookup_coords(coords, band.volumes, table, 9,
                                               dt, b0)
        want, bad_p = corr.block_local_lookup_coords_plain(band, coords, 9,
                                                           dt)
        e_all = d_all.clone()
        kernels.local_lookup_exact_coords(coords, local.volumes, table, 9,
                                          bad=bad_all, out=e_all)
        e_band, e_plain = got.clone(), got.clone()
        kernels.local_lookup_exact_coords(coords, band.volumes, table, 9,
                                          bad=bad, out=e_band, b0=b0)
        corr.block_local_lookup_exact_coords_plain(band, coords, 9, bad=bad,
                                                   out=e_plain)
        torch.cuda.synchronize()
        if not (torch.equal(got, d_all[b0:]) and torch.equal(bad, bad_p)
                and torch.equal(bad, bad_all[b0:])
                and torch.equal(e_band, e_all[b0:])):
            raise AssertionError(f"kernels D, E on the band ({kind}) differ "
                                 f"from the whole grid's rows or flags")
        errs["D"] = max(errs["D"], (got.float() - want.float()).abs().max()
                        .item())
        errs["E"] = max(errs["E"], (e_band.float() - e_plain.float()).abs()
                        .max().item())
        log(f"kernels D, E [720p band b0={b0}, {kind}]: equal to the whole "
            f"grid's rows and flags ({int(bad.bool().any(1).sum())} of {nb} "
            f"blocks flagged); against their plain versions D "
            f"{errs['D']:.3g}, E {errs['E']:.3g}")
    if max(errs.values()) > 0.0:
        raise AssertionError(f"kernels D, E on the band differ from their "
                             f"plain versions: {errs}")
    timed = _time_coord_lookups(kernels, corr, band, _local_coords(
        dev, "smooth"), f"720p band b0={b0}")
    for k in "DE":
        rows[k] = dict(max_abs_err=errs[k], **timed[k])
    del local, band

    rows["B"] = check_shard_lookup(kernels, corr, dev)
    return rows


def check_shard_lookup(kernels, corr, dev):
    """Kernel B on the two key-column halves of the 720p pyramid (Q =
    14,400, 80 / 40 / 20 / 10 columns a level), x shifted by each half's
    first level-0 column, the parts summed against the whole-level lookup
    (``SHARD_LOOKUP_TOL``), dense and indexed; the second half timed
    beside its bound, its plain version and ``F.grid_sample`` x4."""
    radius, k = 4, 9
    pyramid, coords, cells, c_cells = lookup_case(corr, dev)
    Q = coords.numel() // 2
    W0 = pyramid[0].shape[2]
    halves = [[p[:, :, r * p.shape[2] // 2:(r + 1) * p.shape[2] // 2]
               .contiguous() for p in pyramid] for r in (0, 1)]
    shift = torch.tensor([W0 / 2, 0.0], device=dev)
    shifted = (coords - shift).contiguous()
    whole = kernels.corr_pyramid_lookup(pyramid, coords, radius)
    parts = (kernels.corr_pyramid_lookup(halves[0], coords, radius)
             + kernels.corr_pyramid_lookup(halves[1], shifted, radius))
    whole_i = kernels.corr_pyramid_lookup(pyramid, c_cells, radius,
                                          rows=cells)
    parts_i = (kernels.corr_pyramid_lookup(halves[0], c_cells, radius,
                                           rows=cells)
               + kernels.corr_pyramid_lookup(
                   halves[1], (c_cells - shift).contiguous(), radius,
                   rows=cells))
    plain = corr.corr_lookup_plain(halves[1], shifted, radius).reshape(Q, -1)
    one = kernels.corr_pyramid_lookup(halves[1], shifted, radius)
    torch.cuda.synchronize()
    err = (parts - whole).abs().max().item()
    err_i = (parts_i - whole_i).abs().max().item()
    err_p = (one - plain).abs().max().item()
    log(f"kernel B on two key-column shards [720p, Q={Q}, x shifted by "
        f"{W0 // 2}]: the parts' sum against the whole lookup max_abs_err "
        f"{err:.3g} dense, {err_i:.3g} indexed (tol {SHARD_LOOKUP_TOL}); "
        f"one shard against its plain version {err_p:.3g}")
    if not (max(err, err_i) <= SHARD_LOOKUP_TOL and err_p <= LOOKUP_TOL):
        raise AssertionError("kernel B on key-column shards disagrees")
    n_out = Q * 4 * k * k
    flat = shifted.reshape(Q, 2)
    bnd, by = bound_ms(_window_bytes(halves[1], flat, None, radius) + Q * 8
                       + n_out * 4, n_out * 18)
    d = torch.arange(k, device=dev, dtype=torch.float32) - radius
    grids = []
    for lvl, p in enumerate(halves[1]):
        hl, wl = p.shape[1:]
        c = flat.reshape(Q, 1, 1, 2) / 2 ** lvl
        gx, gy = torch.broadcast_tensors(c[..., 0] + d[:, None],
                                         c[..., 1] + d[None, :])
        grids.append(torch.stack([2 * gx / (wl - 1) - 1,
                                  2 * gy / (hl - 1) - 1], -1))
    levels = [p[:, None] for p in halves[1]]
    ms = time_ms(lambda: kernels.corr_pyramid_lookup(halves[1], shifted,
                                                     radius))
    plain_ms = time_ms(lambda: corr.corr_lookup_plain(halves[1], shifted,
                                                      radius), iters=5,
                       warmup=1)
    library_ms = time_ms(lambda: [F.grid_sample(
        lv, gr, mode="bilinear", padding_mode="zeros", align_corners=True)
        for lv, gr in zip(levels, grids)])
    log(f"kernel B timing (one key-column shard, Q={Q}, half of each "
        f"level): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, F.grid_sample "
        f"x4 {library_ms:.4f} ms, bound {bnd:.4f} ms ({by})")
    return dict(max_abs_err=max(err, err_i), ms=ms, plain_ms=plain_ms,
                bound_ms=bnd, bound_by=by, library_ms=library_ms)


def track_scale_out(kernels, corr, dev, small_ckpt):
    """The scale-out phase: C, D, E at a band and B on column shards; then
    NCCL with one rank (world 1, a file store, in this process): an
    all-reduce, ``sharded_track_batch`` over 2 streams of 8 frames under
    ``WOFT.py`` against each stream's own ``build_track_step`` (0 px; A
    once and B 13 times a stream-frame), one ``sharded_train_step`` at
    288x384, batch 4, ``--train-flow``, against the plain step; then two
    ``gloo`` ranks on ``cuda:0`` (``parallel.launch``; NCCL refuses two
    ranks on one GPU): tracking 2 x 2 streams, the pyramid and block-local
    forms of ``spatial_sharded_forward`` (sp = 2) and the dp step on 2 x 2
    rows, each against its single-process twin here. The RAFT-small
    checkpoint ``small_ckpt`` under ``WOFT.py`` runs ``sharded_track_batch``
    over 2 streams of 4 frames with NCCL, and one stream a ``gloo`` rank,
    each stream against its own ``build_track_step`` (0 px). Returns the
    kernel rows at the band and shard shapes and each run's launches."""
    import tempfile
    from woft_tpu_torch.flow.wrapper import upload_bgr
    from woft_tpu_torch.models.raft import weighted_raft_forward
    from woft_tpu_torch.parallel import (
        all_reduce_sum, launch, make_mesh, process_group,
        sharded_track_batch, sharded_train_step)

    t_phase = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows = check_band_kernels(kernels, corr, dev)
    torch.cuda.empty_cache()

    template, frames, poses = walk(H_IMG, W_IMG, dev, n=SCALE_FRAMES)
    masks, corners = scale_masks()
    batch = scale_train_batch(dev)
    runs = {}
    model, cfg, tp = _scale_tracker(dev)
    # each stream alone, the twin of every sharded run
    single = single_streams(model, cfg, tp, template, frames, masks, dev)
    errs = corner_errors_streams(single, poses, corners)
    log(f"scale-out: 4 streams of {SCALE_FRAMES} frames alone under WOFT.py"
        f", corner error against the walk {min(errs):.3f}-{max(errs):.3f} px")
    train0 = single_train_step(dev, batch)
    small_model, small_cfg, small_tp = _scale_tracker(dev,
                                                      small_ckpt=small_ckpt)
    small_frames = frames[:SMALL_SCALE_FRAMES]
    small_single = single_streams(small_model, small_cfg, small_tp, template,
                                  small_frames, masks[:2], dev)

    with tempfile.TemporaryDirectory() as tmp, process_group(
            "nccl", os.path.join(tmp, "store"), 0, 1, timeout=300.0):
        mesh = make_mesh(sp=1, device=dev)
        t = all_reduce_sum(torch.full((4,), 3.0, device=dev), mesh)
        if not torch.equal(t, torch.full((4,), 3.0, device=dev)):
            raise AssertionError("NCCL all-reduce of one rank changed t")
        step = sharded_track_batch(mesh, cfg, tp)
        mine = masks[:SCALE_STREAMS]
        hs, launches, secs, flows = scale_track(
            kernels, step, model, cfg, tp, template, frames, mine, dev)
        px = stream_px(hs, single[:, :SCALE_STREAMS], corners)
        n = SCALE_STREAMS * SCALE_FRAMES
        log(f"NCCL, one rank [{card}]: all-reduce ok; sharded_track_batch "
            f"{SCALE_STREAMS} streams x {SCALE_FRAMES} frames in "
            f"{secs:.3f} s ({n / secs:.1f} targets.frames/s), against each "
            f"stream alone {px:.3g} px; launches {launches}")
        if px != 0.0:
            raise AssertionError("NCCL sharded_track_batch differs from "
                                 "the streams alone")
        check_counts("NCCL sharded_track_batch", launches,
                     {"warp_perspective_bilinear": n,
                      "corr_pyramid_lookup": 13 * flows},
                     ("warp_perspective_bilinear", "corr_pyramid_lookup"),
                     n, flows)
        runs["NCCL tracking, 2 streams x 8 frames"] = launches
        del step
        hs, launches, secs, flows = scale_track(
            kernels, sharded_track_batch(mesh, small_cfg, small_tp),
            small_model, small_cfg, small_tp, template, small_frames,
            masks[:2], dev)
        px = stream_px(hs, small_single, corners[:2])
        n = 2 * SMALL_SCALE_FRAMES
        log(f"NCCL, one rank [{card}]: sharded_track_batch RAFT-small 2 "
            f"streams x {SMALL_SCALE_FRAMES} frames in {secs:.3f} s, against "
            f"each stream alone {px:.3g} px; launches {launches}")
        if px != 0.0:
            raise AssertionError("NCCL sharded_track_batch (RAFT-small) "
                                 "differs from the streams alone")
        check_counts("NCCL sharded_track_batch RAFT-small", launches,
                     {"warp_perspective_bilinear": n,
                      "corr_pyramid_lookup": 13 * flows},
                     ("warp_perspective_bilinear", "corr_pyramid_lookup"),
                     n, flows)
        runs["NCCL tracking RAFT-small, 2 streams x 4 frames"] = launches
        tmodel, tcfg_r, tcfg, tx, state, seen = scale_train_model(dev)
        zero_counts(kernels)
        loss = float(sharded_train_step(mesh, tmodel, tcfg_r, tcfg, tx)(
            state, _train_rows(batch, mesh, dev)))
        runs["NCCL training step, batch 4"] = read_counts(kernels)
        nccl_train = compare_train(
            f"NCCL, one rank, sharded_train_step [{card}]",
            (loss, {n_: g.cpu() for n_, g in seen.items()},
             _named_cpu(tmodel)), train0, DP_SAME_BATCH_REL)
        del tmodel, tx, state, seen
    torch.cuda.empty_cache()

    # the single-process twins of the spatial forwards
    img1 = upload_bgr(template, dev)
    img2 = upload_bgr(frames[0], dev)
    with torch.no_grad():
        ref = weighted_raft_forward(model, cfg, img1, img2)
        fast_model, fast_cfg, _ = _scale_tracker(dev, "WOFT_fast.py")
        ref_fast = weighted_raft_forward(fast_model, fast_cfg, img1, img2)
    refs = {"pyramid": (ref["flow_up"].cpu().numpy(),
                        ref["weights_up"].cpu().numpy()),
            "block-local": (ref_fast["flow_up"].cpu().numpy(),
                            ref_fast["weights_up"].cpu().numpy())}
    whole_bytes = sum(v.numel() * 4 for v in corr.corr_pyramid_fused(
        ref["fmap1"], ref["fmap2"], 4)[0])
    del ref, ref_fast, model, fast_model, small_model
    torch.cuda.empty_cache()

    job = dict(template=template, frames=frames, masks=masks, batch=batch,
               small_ckpt=small_ckpt)
    t0 = time.perf_counter()
    res = launch(scale_out_rank, 2, "gloo", ["cuda:0", "cuda:0"],
                 args=(job,), timeout=300.0, join_timeout=600.0)
    log(f"two gloo ranks on cuda:0: {time.perf_counter() - t0:.1f} s from "
        f"spawn to join")

    # (a) tracking
    hs = np.concatenate([r["track"]["hs"] for r in res], axis=1)
    px = stream_px(hs, single, corners)
    secs = max(r["track"]["seconds"] for r in res)
    n = len(masks) * SCALE_FRAMES
    log(f"gloo (a) sharded_track_batch, 2 ranks x {SCALE_STREAMS} streams x "
        f"{SCALE_FRAMES} frames [{card}]: {secs:.3f} s on the slower rank, "
        f"{n / secs:.1f} targets.frames/s (two processes sharing one card); "
        f"against each stream alone {px:.3g} px (bound "
        f"{GLOO_TRACK_TOL_PX}); launches {[r['track']['launches'] for r in res]}")
    if not px <= GLOO_TRACK_TOL_PX:
        raise AssertionError("gloo sharded_track_batch differs from the "
                             "streams alone")
    for r in res:
        if not np.array_equal(r["track"]["all_hs"],
                              hs.transpose(1, 0, 2, 3).astype(np.float32)):
            raise AssertionError("gather_streams differs from the ranks' Hs")
    for i, r in enumerate(res):
        nr = SCALE_STREAMS * SCALE_FRAMES
        check_counts(f"gloo tracking rank {i}", r["track"]["launches"],
                     {"warp_perspective_bilinear": nr,
                      "corr_pyramid_lookup": 13 * r["track"]["flows"]},
                     ("warp_perspective_bilinear", "corr_pyramid_lookup"),
                     nr, r["track"]["flows"])
        runs[f"gloo tracking rank {i}, 2 streams x 8 frames"] = \
            r["track"]["launches"]

    # (a') RAFT-small, one stream a rank
    hs = np.concatenate([r["small"]["hs"] for r in res], axis=1)
    px = stream_px(hs, small_single, corners[:2])
    log(f"gloo (a') sharded_track_batch RAFT-small, 2 ranks x 1 stream x "
        f"{SMALL_SCALE_FRAMES} frames [{card}]: against each stream alone "
        f"{px:.3g} px; launches {[r['small']['launches'] for r in res]}")
    if px != 0.0:
        raise AssertionError("gloo sharded_track_batch (RAFT-small) differs "
                             "from the streams alone")
    for i, r in enumerate(res):
        check_counts(f"gloo RAFT-small tracking rank {i}",
                     r["small"]["launches"],
                     {"warp_perspective_bilinear": SMALL_SCALE_FRAMES,
                      "corr_pyramid_lookup": 13 * r["small"]["flows"]},
                     ("warp_perspective_bilinear", "corr_pyramid_lookup"),
                     SMALL_SCALE_FRAMES, r["small"]["flows"])
        runs[f"gloo tracking RAFT-small rank {i}, 1 stream x 4 frames"] = \
            r["small"]["launches"]

    # (b), (c) the spatial forwards
    spatial = {}
    for form, tol in (("pyramid", SP_PYRAMID_TOL),
                      ("block-local", SP_LOCAL_TOL)):
        f_ref, w_ref = refs[form]
        gaps = [(float(np.abs(r[form]["flow_up"] - f_ref).max()),
                 float(np.abs(r[form]["weights_up"] - w_ref).max()))
                for r in res]
        info = [dict(ms=r[form]["ms"], volume_bytes=r[form]["volume_bytes"],
                     reduce_bytes=r[form]["reduce_bytes"],
                     reduces=r[form]["reduces"], blocks=r[form]["blocks"],
                     peak_gib=r[form]["peak_gib"]) for r in res]
        log(f"gloo ({'b' if form == 'pyramid' else 'c'}) "
            f"spatial_sharded_forward, {form}, sp = 2 [{card}]: flow_up and "
            f"weights_up against the unsharded forward {gaps} (bound {tol}); "
            f"per rank {info}; the whole float32 pyramid "
            f"{whole_bytes / 1e9:.3f} GB")
        if not max(max(g) for g in gaps) <= tol:
            raise AssertionError(f"spatial_sharded_forward ({form}) differs "
                                 f"from the unsharded forward")
        for i, r in enumerate(res):
            want = ({"corr_pyramid_lookup": 13} if form == "pyramid" else
                    {"local_corr_build": 1, "local_lookup_coords": 13,
                     "local_lookup_exact_coords": 13,
                     **update_launches(True, 1)})
            check_counts(f"spatial {form} rank {i}", r[form]["launches"],
                         want, tuple(want), 0, 1)
            runs[f"gloo spatial {form} rank {i}, one flow"] = \
                r[form]["launches"]
        spatial[form] = dict(gaps=gaps, ranks=info)
    if res[1]["block-local"]["blocks"] != (SCALE_BAND_B0, 120):
        raise AssertionError(f"rank 1 held blocks "
                             f"{res[1]['block-local']['blocks']}")

    # (d) training
    dp_train = [compare_train(f"gloo (d) sharded_train_step rank {i}, 2 of "
                              f"4 rows [{card}]", r["train"]["step"], train0,
                              DP_HALF_BATCH_REL)
                for i, r in enumerate(res)]
    for i, r in enumerate(res):
        runs[f"gloo training rank {i}, 2 rows"] = r["train"]["launches"]
    log(f"scale-out phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(rows=rows, runs=runs, spatial=spatial, train=dict(
        nccl=nccl_train, gloo=dp_train))


def corner_errors_streams(hs, poses, corners):
    """Each stream's corner errors against the walk (template px)."""
    return [e for s in range(hs.shape[1])
            for e in corner_errors(list(hs[:, s]), poses, corners[s])]


def main():
    import tempfile

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
    upd_1080 = check_update_kernels(kernels, dev, MULTI_H // 8, MULTI_W // 8)
    torch.cuda.empty_cache()
    head_j = check_weight_head(kernels, dev)
    torch.cuda.empty_cache()
    norm_l = check_instance_norm(kernels, dev)
    sobol_n = check_sobol_select(kernels, dev)
    canon, canon_ms = track_720p(kernels, dev, "WOFT.py")
    torch.cuda.empty_cache()
    fast, fast_ms = track_720p(kernels, dev, "WOFT_fast.py")
    torch.cuda.empty_cache()
    fused, fused_ms = track_720p(kernels, dev, "WOFT_fast.py", fused=True)
    log(f"steady 720p frame: WOFT.py {sum(canon_ms) / len(canon_ms):.1f} ms, "
        f"WOFT_fast.py {sum(fast_ms) / len(fast_ms):.1f} ms, WOFT_fast.py "
        f"with the flags {sum(fused_ms) / len(fused_ms):.1f} ms (host "
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
    gma_rows = check_gma_kernels(kernels, dev)
    paths["shared GMA x8 1920x1080"] = track_shared_gma(kernels, dev)
    torch.cuda.empty_cache()
    paths["window batch x8 1920x1080"] = track_window_batch(kernels, dev)

    # evaluation and the entry points: the synthetic evals, A's render
    # form, the POT path, the demo with its debug overlays, track_video
    torch.cuda.empty_cache()
    entry = track_eval_entry(kernels, warp, dev)

    # training: B' at the training shape, train_wraft_torch.py in both
    # modes at full width, the trained checkpoint tracked, C, D and E
    # under grad, one step card vs CPU
    torch.cuda.empty_cache()
    train = track_training(kernels, corr, warp, dev)

    with tempfile.TemporaryDirectory() as small_dir:
        # RAFT-small: B at radius 3, a --small training run, its checkpoint
        # through the four tracker steps, card against the plain path
        small_ckpt = os.path.join(small_dir, "small.pt")
        torch.cuda.empty_cache()
        small = check_small_tracking(kernels, corr, warp, dev, small_ckpt)

        # scale-out: C, D, E at a band and B on key-column shards; NCCL
        # with one rank; two gloo ranks on this card (tracking, RAFT-small
        # tracking, both spatial forms, the dp step)
        torch.cuda.empty_cache()
        scale = track_scale_out(kernels, corr, dev, small_ckpt)

    # launches: A and B on the WOFT.py path, C, D, E (the last two from
    # coordinates) on the WOFT_fast.py
    # path (which launches A too), G, H and I on the WOFT_fast.py path (the
    # loop's card route); F has no caller on a tracker path, as in the JAX
    # package, and is launched in the kernel phase only
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
             launches=fast["fused_gru_update"],
             note="times are the mean of the two directions; grid_1080p: "
                  "at the 135 x 240 loop grid",
             grid_1080p=upd_1080["G"], **upd["G"]),
        dict(name="fused_gru_update_f32", route="cuda",
             source="woft_tpu_torch/csrc/gru_f32.cu",
             replaces="none: woft_tpu runs its float32 GRU through XLA",
             launches=canon["fused_gru_update_f32"],
             note="times are the mean of the two directions; "
                  "unfused_ms is the float32 direction it replaces",
             **upd["G (float32)"]),
        dict(name="motion_encoder_tail", route="cuda", source=update_tail,
             replaces="woft_tpu/ops/pallas/update_tail.py:184",
             launches=fast["motion_encoder_tail"],
             note="the loop's card route only: woft_tpu has no forward "
                  "caller of its twin; grid_1080p: at the 135 x 240 loop "
                  "grid", grid_1080p=upd_1080["H"], **upd["H"]),
        dict(name="flow_head", route="cuda",
             source="woft_tpu_torch/csrc/flow_head.cu",
             replaces="woft_tpu/ops/pallas/update_tail.py:283",
             launches=fast["flow_head"],
             note="grid_1080p: at the 135 x 240 loop grid",
             grid_1080p=upd_1080["I"], **upd["I"]),
        dict(name="weight_head", route="cuda",
             source="woft_tpu_torch/csrc/weight_head.cu",
             replaces="none: woft_tpu runs its weight head through XLA",
             launches=fast["weight_head"],
             note="times at M=32400 (the 1080p grid), rows_4500 at "
                  "WOFT_fast.py's 720p rows; launches: WOFT_fast.py at 720p",
             **head_j),
        dict(name="instance_norm_act", route="cuda",
             source="woft_tpu_torch/csrc/instance_norm.cu",
             replaces="none: woft_tpu runs its instance norm through XLA",
             launches=canon["instance_norm_act"],
             note="kernel L; launches: WOFT.py at 720p, 27 an encoding; "
                  "times: one encoding's 13 calls at 720p float32, the "
                  "other cells' in 'cells'",
             cells=norm_l, **norm_l["720p float32"]),
        dict(name="gma_aggregate", route="cuda",
             source="woft_tpu_torch/csrc/gma_aggregate.cu",
             replaces="none: woft_tpu has no GMA",
             launches=paths["shared GMA x8 1920x1080"]["launches"][
                 "gma_aggregate"],
             note="kernel M; launches: WOFT_gma_fast.py, shared x8 at "
                  "1080p, 12 a flow; times at N = 32,400; gru_x256: kernel "
                  "G at GMA's 256 motion channels, each direction",
             gru_x256=gma_rows["G (x = 256)"], **gma_rows["M"]),
        dict(name="masked_sobol_select", route="cuda",
             source="woft_tpu_torch/csrc/sobol_select.cu",
             replaces="none: woft_tpu selects through XLA "
                      "(woft_tpu/ops/sampling.py:masked_sobol_gather)",
             launches=canon["masked_sobol_select"],
             note="kernel N; launches: WOFT.py at 720p, 2 a flow's fit; "
                  "times: the 1080p shared cells' 8 targets, the other "
                  "cells' in 'cells'; library: no single call",
             cells=sobol_n, **sobol_n["1080p x8"]),
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
            if row["name"] in shapes:       # A's and B's shapes
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
    # A-E on the eval and entry-point paths, each counted from 0; A also
    # in the render's N-homography form
    entry_runs = {**entry["evals"], **entry["demo"],
                  "track_video sync_every=8": entry["video"]}
    for row in rows[:5]:
        row["eval_launches"] = {
            what: res["launches"][row["name"]]
            for what, res in entry_runs.items()
            if res["launches"][row["name"]]}
    rows[0]["render_shape"] = entry["render"]
    # training: A (the synthetic render, one a step, and the validation
    # batch's) and B (13 a step, 13 a validation) in both modes; C, D, E
    # on the block-local gradient at B = 1; B' (13 a step with
    # --train-flow), its times on bf16 levels, the trainer's precision;
    # each kernel's error against its plain version at the training shapes
    for row, kernel in zip(rows[:5], "ABCDE"):
        row["train_max_abs_err"] = train["shapes"][kernel]
        row["train_launches"] = {
            what: res["launches"][row["name"]]
            for what, res in {**train["runs"],
                              "block-local gradient, B = 1":
                                  train["local"]}.items()
            if res["launches"][row["name"]]}
    bwd = train["bwd"]
    rows.append(dict(
        name="corr_pyramid_lookup_backward", route="cuda",
        source="woft_tpu_torch/csrc/corr_lookup.cu",
        replaces="woft_tpu/models/corr.py:919",
        launches=train["runs"]["whole net"]["launches"][
            "corr_pyramid_lookup_backward"],
        train_launches={what: res["launches"]["corr_pyramid_lookup_backward"]
                        for what, res in train["runs"].items()},
        note="kernel B', the backward of B: woft_tpu's training "
             "differentiates its XLA one-hot lookup (corr_lookup at "
             "woft_tpu/models/corr.py:919; fused_corr_lookup has no VJP); "
             "launches: --train-flow, 6 steps; times: bf16 levels, Q=6912 "
             "(batch 4 of 288x384), the float32 form in 'float32'",
        train_max_abs_err=train["shapes"]["B'"],
        float32=bwd["float32"], **bwd["bfloat16"]))
    # scale-out: each kernel's launches in its runs (per rank), and B, C,
    # D, E at the band and shard shapes
    for row in rows:
        counts = {what: c[row["name"]] for what, c in scale["runs"].items()
                  if row["name"] in c and c[row["name"]]}
        if counts:
            row["scale_out_launches"] = counts
    for row, kernel in zip(rows[1:5], "BCDE"):
        row["scale_out_shape"] = scale["rows"][kernel]
    # RAFT-small: A and B on its four tracker steps, each counted from 0,
    # and in its training run (B' too); B at radius 3
    for row in rows[:2]:
        row["small_tracking_launches"] = {
            what: res["launches"][row["name"]]
            for what, res in small["steps"].items()}
    for row in rows[:2] + rows[-1:]:
        row["train_launches"]["RAFT-small, --train-flow"] = \
            small["train"]["launches"][row["name"]]
    rows[1]["radius3"] = small["B"]
    alt = family["alternate"]
    rows.append(dict(
        name="alt_corr_lookup", route="cuda",
        source="woft_tpu_torch/csrc/alt_corr.cu",
        replaces="none: woft_tpu gathers its alternate lookup through XLA",
        launches=alt["track"]["launches"]["alt_corr_lookup"],
        note="kernel K; launches: WOFT_alternate.py at 3840x2160, 13 a "
             "flow; max_rel: against its plain chain at the 4K grid (dense "
             "Q=129600 and indexed M=4500, the larger), max_rel_vs_b: "
             "against kernel B at the 720p grid; times: the 720p grid "
             "(Q=14400), the 4K grid in 'grid_2160p'; flow_2160p_ms: one "
             "4K flow, the plain chain and K in turns",
        max_rel=max(r["max_rel"] for r in alt["k4"].values()),
        max_rel_vs_b=alt["lookup_rel"], ms=alt["lookup_ms"],
        plain_ms=alt["plain_ms"], bound_ms=alt["bound_ms"],
        library_ms=None, grid_2160p=alt["k4"],
        flow_2160p_ms=alt["flow_4k_ms"]))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
