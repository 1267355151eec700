#!/usr/bin/env python
"""Train the WeightedRAFT weight head on synthetic homography pairs, with
the PyTorch port, on the card (or the CPU with ``--device cpu``).

The twin of ``train_wraft.py``: images from a directory (any corpus: COCO,
video frames) are cropped on the host, warped by random homographies on
the device (kernel A renders the batch in one launch), and the weight head
trains end to end through the differentiable weighted-QR homography fit
with the clipped reprojection loss (``woft_tpu_torch/training``).
``--train-flow`` fine-tunes the whole network (the reference's lr is
1e-5); its lookups' backward is kernel B'.

Checkpoints (rolling with ``--ckpt-every``, and the final one) are torch
state dicts of ``WeightedRAFT`` at ``--out``: the tracker serves one
through ``WOFT_WRAFT_TORCH_CKPT`` (``flow/wrapper.py:load_model``), and
``models/convert.py:params_to_jax_numpy`` turns one into a JAX parameter
tree. ``--init`` takes such a state dict (``.pt``/``.pth``, a ``module.``
prefix allowed, merged non-strictly over the seeded initialisation).

``--dp N`` trains data-parallel on N ranks (``woft_tpu_torch/parallel``):
rank r runs on ``cuda:r`` under NCCL (``--device cpu``: the CPU under
``gloo``), and more ranks than visible GPUs raise. ``--batch`` stays the
global batch and must divide by N: every rank reads the same seeded image
stream and draws the synthetic pairs and the stand-in masks for the whole
batch, keeps its rows, and the gradients of the loss over the global
count of points are summed over the ranks, so a step equals the
single-process step on the whole batch. Rank 0 alone validates, logs and
writes the checkpoints.

Example:
    python train_wraft_torch.py --images /data/coco --size 288x384 \\
        --batch 4 --steps 2000 --init weights/wraft_tpu_v4_torch.pt \\
        --out weights/wraft_trained_torch.pt
"""

import argparse
import glob
import logging
import math
import time
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--images", required=True,
                   help="directory of training images (jpg/png); a comma "
                        "list pools several directories")
    p.add_argument("--size", default="288x384",
                   help="train crop HxW (/8); a comma-separated list "
                        "(e.g. 288x384,448x576) cycles sizes per step")
    p.add_argument("--batch", default="4",
                   help="batch size; a comma list pairs with --size sizes")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--steps-per-epoch", type=int, default=500,
                   help="lr halves every epoch (ref schedule)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--train-flow", action="store_true",
                   help="train the whole net (reference fine-tune: 1e-5)")
    p.add_argument("--epe-weight", type=float, default=0.0,
                   help="dense EPE supervision weight (from-scratch runs)")
    p.add_argument("--grad-clip", type=float, default=1.0,
                   help="global-norm gradient clip (0 = off)")
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--small", action="store_true",
                   help="tiny 'small' RAFT variant: smokes/tests only")
    p.add_argument("--init", type=Path,
                   help="torch state dict (.pt/.pth) to start from")
    p.add_argument("--out", type=Path,
                   default=Path("weights/wraft_trained_torch.pt"),
                   help="checkpoint path (a torch state dict)")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--max-shift", type=float, default=0.2,
                   help="synth corner-shift fraction (smaller = easier)")
    p.add_argument("--min-shift", type=float, default=0.0,
                   help="if >0, sample the per-step corner shift "
                        "log-uniformly in [min-shift, max-shift]")
    p.add_argument("--max-translation", type=float, default=0.1)
    p.add_argument("--scale-jitter", type=float, default=1.0,
                   help="if >1, sample source crops up to this factor "
                        "larger and resize down to --size")
    p.add_argument("--grid-subsample", action="store_true",
                   help="stride-grid TC subsampling instead of the "
                        "tracker-matched Sobol-500 over masked points")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="save a rolling checkpoint every N steps")
    p.add_argument("--val-every", type=int, default=0,
                   help="log held-out EPE every N steps")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch path)")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel ranks (0 = single process): rank r "
                        "on cuda:r under NCCL, or on the CPU under gloo "
                        "with --device cpu")
    return p.parse_args(argv)


def image_stream(paths, hw, batch, rng, scale_jitter=1.0):
    """Host-side decode and random-crop batcher: (batch, H, W, 3) float32
    RGB. ``scale_jitter > 1`` samples crops up to that factor larger than
    the target size and resizes them down (the window tracker's
    crop-resample blur)."""
    from woft_tpu_torch.geometry.homography import _cv2
    cv2 = _cv2("train_wraft_torch.image_stream")
    H, W = hw
    while True:
        imgs = []
        while len(imgs) < batch:
            path = paths[rng.integers(len(paths))]
            img = cv2.imread(str(path))
            if img is None or img.shape[0] < H or img.shape[1] < W:
                continue
            s = 1.0
            if scale_jitter > 1.0:
                s_max = min(scale_jitter, img.shape[0] / H, img.shape[1] / W)
                s = float(np.exp(rng.uniform(0.0, np.log(max(s_max, 1.0)))))
            ch, cw = int(round(H * s)), int(round(W * s))
            y = rng.integers(img.shape[0] - ch + 1)
            x = rng.integers(img.shape[1] - cw + 1)
            crop = img[y:y + ch, x:x + cw, ::-1]
            if s != 1.0:
                crop = cv2.resize(crop, (W, H), interpolation=cv2.INTER_AREA)
            imgs.append(crop.astype(np.float32))
        yield np.stack(imgs)


def load_init(model, path):
    """Merge the torch state dict at ``path`` over ``model`` (non-strict,
    as the JAX trainer's ``--init``): the keys both have; missing and extra
    keys are logged."""
    path = Path(path)
    if path.is_dir() or path.suffix not in (".pt", ".pth"):
        raise ValueError(
            f"--init {path}: a torch state dict (.pt/.pth) is needed; only "
            f"tools/export_torch_weights.py reads orbax checkpoints")
    state = torch.load(str(path), map_location="cpu", weights_only=True)
    state = {k[len("module."):] if k.startswith("module.") else k: v
             for k, v in state.items()}
    own = model.state_dict()
    shared = {k: v for k, v in state.items() if k in own}
    if not shared:
        raise ValueError(f"--init {path} shares no tensor with the model")
    if len(shared) != len(own) or len(shared) != len(state):
        logger.warning("--init %s: partial match, %d tensors missing, %d "
                       "dropped", path, len(own) - len(shared),
                       len(state) - len(shared))
    model.load_state_dict(shared, strict=False)


def save_checkpoint(model, out):
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               str(out))
    return out


def val_epe(model, cfg, batch):
    """Mean flow EPE on the validation batch against the exact H-induced
    field."""
    from woft_tpu_torch.models.raft import weighted_raft_forward
    out = weighted_raft_forward(model, cfg, batch["img1"], batch["img2"])
    flow = out["flow_up"]
    B, H, W, _ = flow.shape
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=flow.device),
        torch.arange(W, dtype=torch.float32, device=flow.device),
        indexing="ij")
    grid = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    proj = torch.einsum("bij,nj->bni", batch["h_gt"], grid)
    gt = (proj[..., :2] / proj[..., 2:3] - grid[None, :, :2]).reshape(
        B, H, W, 2)
    return torch.linalg.norm(flow - gt, dim=-1).mean()


def _dp_rank(rank, world, device, args):
    """One rank of ``--dp``: ``run`` on this rank's device, its model and
    optimizer state kept equal across the ranks by the summed gradients.
    Returns rank 0's result without the model."""
    from woft_tpu_torch.parallel import make_mesh
    if rank:
        logging.disable(logging.INFO)       # rank 0 alone logs
    res = run(args, mesh=make_mesh(sp=1, device=device), device=device)
    res.pop("model")
    return res


def run_dp(args):
    """``--dp N``: N spawned ranks, rank r on ``cuda:r`` under NCCL, or on
    the CPU under ``gloo`` with ``--device cpu``. Raises ``ValueError``
    when N exceeds the visible GPUs. Returns rank 0's result (no model)."""
    from woft_tpu_torch.parallel import launch
    n = args.dp
    if args.device is not None and torch.device(args.device).type == "cpu":
        backend, devices = "gloo", ["cpu"] * n
    else:
        visible = torch.cuda.device_count()
        if n > visible:
            raise ValueError(f"--dp {n} needs {n} GPUs, {visible} visible")
        backend, devices = "nccl", [f"cuda:{r}" for r in range(n)]
    # the group's set-up and each collective get 30 minutes (the first
    # steps build the kernels); the run as a whole has no time limit
    return launch(_dp_rank, n, backend, devices, args=(args,),
                  timeout=1800.0, join_timeout=math.inf)[0]


def run(args, wrap_step=None, mesh=None, device=None):
    """Train as ``args`` say. ``wrap_step(i, fn)``, when given, runs step
    i's ``fn()`` and returns its loss (a measurement hook). With ``mesh``
    (one rank of ``--dp``, on ``device``) the step is
    ``sharded_train_step`` on this rank's rows, and only rank 0 validates
    and writes checkpoints. Returns dict (model, cfg, losses [per-step
    float], val [(step, EPE)], out, rc): rc 1 when a non-finite loss came
    with non-finite parameters (halted), else 0."""
    from woft_tpu_torch.device import resolve_device
    from woft_tpu_torch.models.raft import RaftConfig, init_raft_params
    from woft_tpu_torch.training.synth import (synth_draws, synth_from_draws,
                                               synth_homography_batch)
    from woft_tpu_torch.training.train import (TrainConfig, init_train_state,
                                               make_train_step)

    sizes = [tuple(int(v) for v in s.split("x"))
             for s in args.size.split(",")]
    if not all(H % 8 == 0 and W % 8 == 0 for H, W in sizes):
        raise ValueError(f"--size {args.size}: every side a multiple of 8")
    batches = [int(b) for b in str(args.batch).split(",")]
    if len(batches) == 1:
        batches = batches * len(sizes)
    if len(batches) != len(sizes):
        raise ValueError("--batch list must pair with --size")
    dp, rank = 1, 0
    if mesh is not None:
        from woft_tpu_torch.parallel import sharded_train_step
        dp, rank = mesh.shape[0], mesh.get_local_rank("dp")
    if any(b % dp for b in batches):
        raise ValueError(f"--batch {args.batch}: every batch must divide by "
                         f"--dp {dp}")

    dev = resolve_device(device if device is not None else args.device)
    cfg = RaftConfig(variant="weighted", iters=args.iters,
                     precision="default", small=args.small,
                     **({"weight_head_structure": ((32, 3),)}
                        if args.small else {}))
    tcfg = TrainConfig(learning_rate=args.lr, train_flow=args.train_flow,
                       steps_per_epoch=args.steps_per_epoch,
                       epe_weight=args.epe_weight,
                       subsample="grid" if args.grid_subsample else "sobol",
                       grad_clip=args.grad_clip)

    model = init_raft_params(cfg, seed=args.seed)
    if args.init:
        load_init(model, args.init)
    model.to(dev)
    tx, opt_state = init_train_state(model, tcfg)
    step = (make_train_step(model, cfg, tcfg, tx) if mesh is None
            else sharded_train_step(mesh, model, cfg, tcfg, tx))

    paths = sorted(sum((glob.glob(str(Path(d) / f"*.{e}"))
                        for d in str(args.images).split(",")
                        for e in ("jpg", "jpeg", "png")), []))
    if not paths:
        raise SystemExit(f"no images under {args.images}")
    logger.info("%d training images on %s", len(paths), dev)

    rng = np.random.default_rng(args.seed)
    # one host-side batcher per crop size; sizes cycle round-robin per step
    streams = [image_stream(paths, hw, b, rng,
                            scale_jitter=args.scale_jitter)
               for hw, b in zip(sizes, batches)]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    def upload(imgs):
        return torch.from_numpy(imgs).to(dev)

    # held-out validation batch from a fixed seed
    val_batch = synth_homography_batch(
        torch.Generator(device=dev).manual_seed(12345),
        upload(next(streams[0])), max_corner_shift=args.max_shift,
        max_translation=args.max_translation)

    losses, val = [], []
    t0 = time.time()
    for i in range(args.steps):
        if args.min_shift > 0:
            shift = float(np.exp(rng.uniform(np.log(args.min_shift),
                                             np.log(args.max_shift))))
        else:
            shift = args.max_shift
        imgs = next(streams[i % len(streams)])
        if mesh is None:
            batch = synth_homography_batch(
                gen, upload(imgs), max_corner_shift=shift,
                max_translation=args.max_translation)
        else:
            # the draws of the whole batch, this rank's rows of them
            B, H, W, _ = imgs.shape
            rows = slice(rank * B // dp, (rank + 1) * B // dp)
            draws = synth_draws(gen, B, H, W)
            batch = synth_from_draws(
                upload(imgs[rows]), {k: v[rows] for k, v in draws.items()},
                max_corner_shift=shift, max_translation=args.max_translation)
        batch["generator"] = gen
        loss = (step(opt_state, batch) if wrap_step is None
                else wrap_step(i, lambda: step(opt_state, batch)))
        losses.append(loss)
        if i % args.log_every == 0:
            loss_f = float(loss)
            logger.info("step %d  loss %.4f  (%.2f s/step)", i, loss_f,
                        (time.time() - t0) / max(i, 1))
            if not np.isfinite(loss_f):
                # a degenerate batch whose update was skipped leaves the
                # parameters finite: go on; halt only if they are not,
                # keeping the last rolling checkpoint
                if all(bool(torch.isfinite(p).all())
                       for p in model.parameters()):
                    logger.warning("non-finite loss at step %d but params "
                                   "finite: update skipped; continuing", i)
                else:
                    logger.error("non-finite loss and non-finite params at "
                                 "step %d: halting; the last rolling "
                                 "checkpoint is the survivor", i)
                    return dict(model=model, cfg=cfg, losses=[
                        float(v) for v in losses], val=val, out=None, rc=1)
        if rank:
            continue
        if args.val_every and i % args.val_every == 0:
            epe = float(val_epe(model, cfg, val_batch))
            val.append((i, epe))
            logger.info("step %d  val EPE %.3f px", i, epe)
        if args.ckpt_every and i and i % args.ckpt_every == 0:
            save_checkpoint(model, args.out)
            logger.info("rolling checkpoint @ step %d", i)

    out = None
    if rank == 0:
        out = save_checkpoint(model, args.out)
        logger.info("saved checkpoint to %s", out)
    return dict(model=model, cfg=cfg, losses=[float(v) for v in losses],
                val=val, out=out, rc=0)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] %(levelname)s:%(message)s")
    return (run_dp(args) if args.dp > 1 else run(args))["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
