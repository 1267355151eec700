#!/usr/bin/env python
"""Track a planar target through a video with the PyTorch port.

The twin of ``WOFT_demo.py`` (ref:WOFT_demo.py), with the same flags and
outputs plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch path): ``--headless`` with ``--out`` writes overlay frames (a
directory of jpgs, or an mp4), ``NNNNN_debug_<name>.jpg`` overlays with
``--debug``, and ``homographies.npz`` (``H``: per-frame cur -> init
homographies, ``corners``: the init box) instead of opening windows;
``--bbox x,y,w,h`` (or ``--full-frame``) replaces the interactive ROI
selection. ``eval_woft.py --pot-ref`` and ``eval_woft_torch.py --pot-ref``
both score a run from its ``homographies.npz``.
"""

import argparse
import logging
import sys
from pathlib import Path

import numpy as np

from woft_tpu_torch.config import load_config
from woft_tpu_torch.geometry.homography import _cv2
from woft_tpu_torch.tracker.window import warp_mask_nearest
from woft_tpu_torch.utils.io import GeneralVideoCapture, VideoWriter
from woft_tpu_torch.utils.timing import time_measurer
from woft_tpu_torch.utils.vis import blend_mask

logger = logging.getLogger(__name__)


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description="WOFT planar tracking demo (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("video", type=Path,
                        help="video file or directory of frames")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--config", type=Path,
                        default=Path(__file__).parent
                        / "woft_tpu_torch/configs/WOFT.py")
    parser.add_argument("--headless", action="store_true",
                        help="no GUI; requires --out")
    parser.add_argument("--out", type=Path,
                        help="output dir (overlay jpgs + H npz) or .mp4 path")
    parser.add_argument("--bbox", type=str,
                        help="init bbox 'x,y,w,h' (skips interactive ROI)")
    parser.add_argument("--full-frame", action="store_true",
                        help="init with a centered half-frame box")
    parser.add_argument("--max-frames", type=int, default=0)
    parser.add_argument("--debug", action="store_true",
                        help="render per-frame debug overlays (TC arrows, "
                             "alignment blends); shown in windows, or "
                             "written to --out when headless "
                             "(ref:YAOF_tracker_single_control.py:209-265)")
    parser.add_argument("--device", default="cuda",
                        help="torch device the tracker runs on ('cpu': the "
                             "plain PyTorch path)")
    args = parser.parse_args(argv)

    fmt = "[%(asctime)s] %(levelname)s:%(name)s:%(message)s"
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format=fmt)
    return args


def make_bbox_mask(frame, bbox):
    x, y, w, h = bbox
    mask = np.zeros(frame.shape[:2], dtype=np.uint8)
    mask[y:y + h + 1, x:x + w + 1] = 255
    return mask


def select_rect_mask(img):
    cv2 = _cv2("select_rect_mask")
    canvas = img.copy()
    cv2.putText(canvas, "Select target ROI and press ENTER", (20, 30),
                cv2.FONT_HERSHEY_COMPLEX_SMALL, 1.5, (0, 0, 0), 1)
    x, y, w, h = cv2.selectROI("cv: WOFT", canvas, fromCenter=False)
    return make_bbox_mask(img, (x, y, w, h))


def triv_tracker_vis(frame, init_mask, h_2init):
    """Warp the init mask into the frame and draw its contour
    (ref:WOFT_demo.py:99-111); the nearest-neighbour mask warp is the
    port's (``warp_mask_nearest``)."""
    current_mask = warp_mask_nearest(init_mask, np.linalg.inv(h_2init),
                                     frame.shape[:2])
    return blend_mask(frame, np.uint8(current_mask) * 255, color=(0, 255, 0),
                      fill=False, contour_thickness=2)


def run(args):
    cv2 = _cv2("WOFT_demo_torch.py")
    config = load_config(args.config)
    tracker = config.tracker_class(config, device=args.device)

    cap = GeneralVideoCapture(args.video)
    success, frame = cap.read()
    if not success:
        print(f"Reading frame from {args.video} failed.")
        return -1

    if args.bbox:
        bbox = tuple(int(v) for v in args.bbox.split(","))
        init_mask = make_bbox_mask(frame, bbox)
    elif args.full_frame or args.headless:
        H, W = frame.shape[:2]
        init_mask = make_bbox_mask(frame, (W // 4, H // 4, W // 2, H // 2))
    else:
        init_mask = select_rect_mask(frame)

    tracker.init(frame, init_mask)

    writer = None
    hs = []
    if args.out:
        writer = VideoWriter(args.out)
    if not args.headless:
        print("press q to quit")

    last_h = np.eye(3)
    frame_i = 0
    while True:
        ret, frame = cap.read()
        if frame is None:
            break
        frame_i += 1
        if args.max_frames and frame_i > args.max_frames:
            break

        timer = time_measurer("ms")
        try:
            h_2init, meta = tracker.track(frame, debug=args.debug)
            last_h = h_2init.copy()
        except Exception:  # noqa: BLE001 — the demo keeps going (ref:WOFT_demo.py:66-72)
            logger.exception("Tracker exception")
            h_2init = last_h.copy()
            meta = None

        for name, im in getattr(meta, "debug_vis", {}).items():
            if args.headless:
                out_dir = args.out if args.out.suffix == "" else args.out.parent
                Path(out_dir).mkdir(parents=True, exist_ok=True)
                cv2.imwrite(str(Path(out_dir)
                                / f"{frame_i:05d}_debug_{name}.jpg"), im)
            else:
                cv2.imshow(f"cv: {name}", im)
        logger.debug("frame %d: %.1fms lost=%s", frame_i, timer(),
                     getattr(meta, "lost", "?"))

        vis = triv_tracker_vis(frame.copy(), init_mask.copy(), h_2init.copy())
        hs.append(h_2init.copy())
        if writer is not None:
            writer.write(vis)
        if not args.headless:
            cv2.imshow("cv: WOFT", vis)
            if cv2.waitKey(1) == ord("q"):
                break

    cap.release()
    if writer is not None:
        writer.release()
        out_dir = args.out if args.out.suffix == "" else args.out.parent
        ys, xs = np.where(init_mask > 0)
        corners = np.array([[xs.min(), ys.min()], [xs.max(), ys.min()],
                            [xs.max(), ys.max()], [xs.min(), ys.max()]],
                           np.float64)
        np.savez(Path(out_dir) / "homographies.npz", H=np.stack(hs),
                 corners=corners)
        print(f"wrote {len(hs)} frames to {args.out}")
    if not args.headless:
        cv2.destroyAllWindows()
    return 0


def main(argv=None):
    args = parse_arguments(argv)
    if args.headless and not args.out:
        print("--headless requires --out")
        return -1
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
