#!/usr/bin/env python
"""Evaluate a tracker config of the PyTorch port on synthetic ground-truth
sequences, or on POT-format annotations.

The twin of ``eval_woft.py``, with the same flags and defaults, the same
JSON keys, and ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch path). Configs come from ``woft_tpu_torch/configs/``. Base frames
(any images) are warped along smooth random homography trajectories on the
tracker's device; the tracker runs its whole pipeline (pre-warp, flow,
fit, fallback ladder) and is scored with POT-style alignment metrics.

Example:
    python eval_woft_torch.py --images frames/ \\
        --config woft_tpu_torch/configs/WOFT.py --frames 30 --seqs 5
"""

import argparse
import glob
import json
import logging
from pathlib import Path

import numpy as np
import torch

from woft_tpu_torch.config import load_config
from woft_tpu_torch.eval.pot import (corners_from_homographies,
                                     evaluate_pot_sequence,
                                     read_pot_annotations)
from woft_tpu_torch.eval.synth_eval import evaluate_tracker_synthetic
from woft_tpu_torch.geometry.homography import _cv2
from woft_tpu_torch.ops.resize import resize_down

ROOT = Path(__file__).resolve().parent
logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--images", type=Path, required=True,
                   help="directory of base frames")
    p.add_argument("--config", type=Path,
                   default=ROOT / "woft_tpu_torch/configs/WOFT.py")
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--seqs", type=int, default=3)
    p.add_argument("--step-px", type=float, default=3.0)
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--stress", action="store_true",
                   help="hard trajectories: 8px/frame steps, strong "
                        "rotation/perspective, sensor noise, and a large "
                        "motion jolt every 10 frames; exercises the "
                        "inlier-check redetection ladder end to end")
    p.add_argument("--downscale", type=int, default=0,
                   help="downscale base frames before evaluation")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=Path, help="write metrics JSON here")
    p.add_argument("--pot", type=Path,
                   help="POT ground-truth file (8 numbers/frame: 4 corner "
                        "x y pairs) or a directory containing frames + one "
                        "*.txt annotation; scores real footage instead of "
                        "synthetic trajectories")
    p.add_argument("--pot-ref", type=Path,
                   help="homographies.npz (+init corners from --pot or the "
                        "center quad) from a reference run; scores this "
                        "config against that run's corners on the same "
                        "frames (cross-mode regression on real footage)")
    p.add_argument("--device", default="cuda",
                   help="torch device the tracker runs on ('cpu': the "
                        "plain PyTorch path)")
    return p.parse_args(argv)


def frame_paths(images):
    return sorted(sum((glob.glob(str(images / f"*.{e}"))
                       for e in ("jpg", "jpeg", "png")), []))


def run_pot(args, config, tracker=None):
    """The real-data POT path (--pot / --pot-ref): -> metrics dict."""
    frames = frame_paths(args.images)
    if not frames:
        raise SystemExit(f"no frames under {args.images}")

    if args.pot_ref:
        ref = np.load(args.pot_ref)
        hs = ref["H"]
        first = _cv2("eval_woft_torch.py --pot-ref").imread(frames[0])
        H, W = first.shape[:2]
        if "corners" in ref:
            quad = ref["corners"]
        else:   # the demo's default centered half-frame box
            quad = np.array([[W // 4, H // 4], [3 * W // 4, H // 4],
                             [3 * W // 4, 3 * H // 4], [W // 4, 3 * H // 4]],
                            np.float64)
        gt = np.concatenate([quad[None],
                             corners_from_homographies(hs, quad)])
    else:
        pot_path = args.pot
        if pot_path.is_dir():
            anns = sorted(pot_path.glob("*.txt"))
            if not anns:
                raise SystemExit(f"no *.txt annotation under {pot_path}")
            pot_path = anns[0]
        gt = read_pot_annotations(pot_path)
        quad = gt[0]

    if tracker is None:
        tracker = config.tracker_class(config, device=args.device)
    metrics, _est, _hs = evaluate_pot_sequence(
        tracker, frames, gt, init_corners=quad,
        max_frames=args.frames if args.frames else 0)
    return metrics


def run_synthetic(args, config, tracker=None):
    """The synthetic path: -> (summary, per-sequence metrics). Base frame s
    is ``paths[rng.integers(len(paths))]`` of a generator seeded with
    ``--seed``, downscaled as ``cv2.resize`` does (``ops/resize.py``) with
    ``--downscale``, cropped to a multiple of 8, and tracked with the
    centred half-size box as the target."""
    paths = frame_paths(args.images)
    if not paths:
        raise SystemExit(f"no images under {args.images}")
    if tracker is None:
        tracker = config.tracker_class(config, device=args.device)

    imread = _cv2("eval_woft_torch.py").imread
    rng = np.random.default_rng(args.seed)
    all_metrics = []
    for s in range(args.seqs):
        base = imread(paths[rng.integers(len(paths))])
        if args.downscale:
            base = resize_down(torch.from_numpy(base),
                               args.downscale).numpy()
        H, W = base.shape[:2]
        base = np.ascontiguousarray(base[:H - H % 8, :W - W % 8])
        H, W = base.shape[:2]
        mask = np.zeros((H, W), np.uint8)
        mask[H // 4:3 * H // 4, W // 4:3 * W // 4] = 255

        traj_kwargs = dict(max_step_px=args.step_px)
        noise = args.noise
        if args.stress:
            traj_kwargs = dict(max_step_px=max(args.step_px, 8.0),
                               max_rot=0.02, max_scale=0.01, max_persp=1e-5,
                               jump_every=10, jump_px=30.0)
            noise = max(noise, 3.0)
        metrics, _h_pred, _h_gt = evaluate_tracker_synthetic(
            tracker, base, mask, n_frames=args.frames, seed=args.seed + s,
            noise=noise, device=args.device, **traj_kwargs)
        logger.info("seq %d: %s", s, metrics)
        all_metrics.append(metrics)

    summary = {k: float(np.mean([m[k] for m in all_metrics]))
               for k in all_metrics[0]}
    summary["seqs"] = args.seqs
    summary["frames"] = args.frames
    return summary, all_metrics


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] %(levelname)s:%(message)s")
    config = load_config(args.config)
    if args.pot or args.pot_ref:
        metrics = run_pot(args, config)
        print(json.dumps(metrics))
        if args.out:
            args.out.write_text(json.dumps(metrics, indent=2))
        return 0

    summary, all_metrics = run_synthetic(args, config)
    print(json.dumps(summary))
    if args.out:
        args.out.write_text(json.dumps(
            {"summary": summary, "per_seq": all_metrics}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
