"""End-to-end weight-head training through the differentiable weighted-QR
homography fit.

PyTorch twin of ``woft_tpu/training/train.py``:

- forward WeightedRAFT on a synthetic pair with a known homography
  (``models/raft.py:train_forward``),
- tentative correspondences = pixel + flow, subsampled as the tracker does
  (Sobol-``sobol_n`` of masked, in-bounds points) or on a stride grid,
- fit H with the weighted QR solve on ``sigmoid(weights_up)``
  (``geometry/homography.py:find_homography_wls_qr``, the reduced QR that
  autograd differentiates),
- loss = mean(clip(reproj_errors(H_gt, H_est, pts), max_loss)), plus an
  optional clipped EPE against the exact H-induced flow,
- train the weight head (and mask head) only, or the whole net with
  ``train_flow``.

The optimizer is the JAX package's optax chain written out
(``AdamW``): ``apply_if_finite(multi_transform({trainable:
chain(clip_by_global_norm, adamw(staircase-halving schedule)), frozen:
set_to_zero}))``, with optax's defaults (b1 0.9, b2 0.999, eps 1e-8,
weight decay 1e-4). One difference: the frozen parameters are built with
``requires_grad=False``, so they get no gradient at all, and the finite
check reads the loss and the trainable gradients, where optax's reads every
leaf's gradient, the frozen ones included. A non-finite gradient can only
reach a trainable leaf through the loss, so the two skip the same steps
except where a frozen leaf alone has a non-finite gradient.

Random draws: the stand-in target masks come from the ``torch.Generator``
a batch carries under ``'generator'`` (JAX's PRNG is not reproduced).
The optimizer's state is tensors on the parameters' device: a step never
waits for the host.
"""

from dataclasses import dataclass

import torch

from ..geometry.homography import find_homography_wls_qr, reproj_errors
from ..models.raft import RaftConfig, train_forward
from ..ops.sampling import masked_sobol_gather


@dataclass(frozen=True)
class TrainConfig:
    max_tc: int = 2000           # grid mode's subsample
    max_loss: float = 100.0      # the reprojection error's clip
    learning_rate: float = 1e-3  # weight-head-only (whole net: 1e-5)
    train_flow: bool = False     # fine-tune the whole net
    steps_per_epoch: int = 1000
    lr_halving: bool = True      # the learning rate halves every epoch
    epe_weight: float = 0.0      # flow supervision against the exact
                                 # H-induced field (0 = the reprojection
                                 # loss alone)
    epe_clip: float = 50.0
    subsample: str = "sobol"     # 'sobol' (the tracker's Sobol-n of masked,
                                 # in-bounds points) or 'grid'
    sobol_n: int = 500           # the tracker's subsample (configs/WOFT.py)
    grad_clip: float = 1.0       # global-norm clip of the trainable
                                 # gradients (0 = off)


def _subsample_grid(H, W, n, device=None):
    """A ~uniform stride grid of at most ``n`` flat pixel indices."""
    hw = H * W
    stride = max(1, hw // n)
    idx = torch.arange(0, stride * min(n, hw), stride, device=device)[:n]
    return idx.clamp(0, hw - 1)


def rect_mask_from_draws(u, H, W):
    """Rectangular stand-in target masks from uniform draws.

    u: (B, 4) in [0, 1): each side covers 0.3-0.9 of the frame (``u[:, 0]``
    rows, ``u[:, 1]`` columns), placed at ``u[:, 2]``, ``u[:, 3]`` of the
    free range. Returns (B, H, W) bool."""
    fh = 0.3 + 0.6 * u[:, 0, None, None]
    fw = 0.3 + 0.6 * u[:, 1, None, None]
    y0 = u[:, 2, None, None] * (1.0 - fh) * H
    x0 = u[:, 3, None, None] * (1.0 - fw) * W
    ys = torch.arange(H, dtype=torch.float32, device=u.device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=u.device)[None, None, :]
    return (ys >= y0) & (ys < y0 + fh * H) & (xs >= x0) & (xs < x0 + fw * W)


def _random_rect_mask(generator, H, W, n=1, device=None):
    """``n`` random rectangular masks covering 30-90 % of each side, the
    stand-in for the tracker's template mask, so that training subsamples
    the masked-region distribution the tracker serves. Draws from
    ``generator`` on its device. Returns (n, H, W) bool on ``device``."""
    u = torch.rand((n, 4), generator=generator, device=generator.device)
    return rect_mask_from_draws(u.to(device or u.device), H, W)


def woft_loss(model, cfg: RaftConfig, tcfg: TrainConfig, batch):
    """The reprojection loss through the differentiable homography fit.

    batch: 'img1', 'img2' (B, H, W, 3) float RGB in [0, 255], 'h_gt' (B, 3,
    3) img1 -> img2, and optionally 'generator', a ``torch.Generator`` for
    the stand-in masks of the 'sobol' mode (without it every in-bounds
    point is a candidate). Returns the scalar loss, its graph recorded."""
    err, epe, count = loss_terms(model, cfg, tcfg, batch)
    count = torch.clamp(count, min=1.0)
    loss = err / count
    if epe is not None:
        loss = loss + tcfg.epe_weight * (epe / count)
    return loss


def loss_terms(model, cfg: RaftConfig, tcfg: TrainConfig, batch, rows=None):
    """The sums behind ``woft_loss``: (the clipped reprojection errors'
    sum, the clipped EPE's sum or None without ``epe_weight``, the count of
    selected points), the sums' graphs recorded. The loss divides both sums
    by the count (at least 1) over the WHOLE batch, so data-parallel ranks
    each add their rows' sums and divide by the global count
    (``parallel/sharding.py:sharded_train_step``). ``rows``: (first row,
    rows in the whole batch) when ``batch`` holds rows of a larger batch:
    the stand-in masks are drawn for the whole batch from the generator and
    these rows kept, as one process drawing them for the whole batch
    would."""
    out = train_forward(model, cfg, batch["img1"], batch["img2"])
    flow = out["flow_up"]                               # (B, H, W, 2)
    weights = torch.sigmoid(out["weights_up"])          # (B, H, W, 1)
    B, H, W, _ = flow.shape
    hw = H * W
    dev = flow.device

    if tcfg.subsample == "sobol":
        pix = torch.arange(hw, device=dev)
        src_all = torch.stack([(pix % W).float(), (pix // W).float()], -1)
        dst_all = src_all[None] + flow.reshape(B, hw, 2)
        inb = ((dst_all[..., 0] >= 0) & (dst_all[..., 0] <= W - 1)
               & (dst_all[..., 1] >= 0) & (dst_all[..., 1] <= H - 1))
        if "generator" in batch:
            row0, n = (0, B) if rows is None else rows
            masks = _random_rect_mask(batch["generator"], H, W, n,
                                      dev)[row0:row0 + B]
            valid = masks.reshape(B, hw) & inb
        else:
            valid = inb
        idx, sel = masked_sobol_gather(valid, tcfg.sobol_n)    # (B, n)
        sel = sel.float()
        src = src_all[idx]                                     # (B, n, 2)
        dst = torch.gather(dst_all, 1, idx[..., None].expand(-1, -1, 2))
        w = torch.gather(weights.reshape(B, hw), 1, idx) * sel
    else:
        idx = _subsample_grid(H, W, tcfg.max_tc, dev)          # (n,)
        grid = torch.stack([(idx % W).float(), (idx // W).float()], -1)
        src = grid[None].expand(B, -1, -1)                     # (B, n, 2)
        dst = src + flow.reshape(B, hw, 2)[:, idx]
        w = weights.reshape(B, hw)[:, idx]
        sel = torch.ones(src.shape[:2], device=dev)

    h_est = find_homography_wls_qr(src, dst, w)                # (B, 3, 3)
    pts = src.transpose(1, 2)                                  # (B, 2, n)
    errs = reproj_errors(batch["h_gt"], h_est, pts)            # (B, n)
    errs = torch.clamp(errs, 0.0, tcfg.max_loss) * sel
    epe_sum = None
    if tcfg.epe_weight:
        # dense supervision: the ground-truth H induces the exact flow
        ones = torch.ones_like(src[..., :1])
        proj = torch.einsum("bij,bnj->bni", batch["h_gt"],
                            torch.cat([src, ones], -1))
        gt_dst = proj[..., :2] / proj[..., 2:3]
        epe = torch.linalg.norm(dst - gt_dst, dim=-1) * sel    # (B, n)
        epe_sum = torch.clamp(epe, 0.0, tcfg.epe_clip).sum()
    return errs.sum(), epe_sum, sel.sum()


def _trainable(name, train_flow):
    head = name.split(".")[0] in ("weight_head", "mask_head")
    return train_flow or head


class AdamW:
    """The JAX package's optax chain for one ``WeightedRAFT``.

    Constructing it marks the model's parameters: trainable ones (the
    weight and mask heads, or every one under ``train_flow``) require
    grad, the frozen ones do not, so the forward records no graph for them.
    ``update(grads, state, loss)`` applies one step in place, on the
    device: clip the trainable gradients by their global norm, Adam
    (bias-corrected moments), weight decay, the learning rate of the
    staircase schedule (halved every ``steps_per_epoch`` applied steps),
    all skipped, counts included, when the loss or a gradient is not
    finite."""

    b1, b2, eps, weight_decay = 0.9, 0.999, 1e-8, 1e-4

    def __init__(self, model, tcfg: TrainConfig):
        self.tcfg = tcfg
        self.names, self.params = [], []
        for name, p in model.named_parameters():
            train = _trainable(name, tcfg.train_flow)
            p.requires_grad_(train)
            if train:
                self.names.append(name)
                self.params.append(p)

    def init(self):
        """Zero moments and counts (optax's ``init``)."""
        dev = self.params[0].device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return {"mu": [torch.zeros_like(p) for p in self.params],
                "nu": [torch.zeros_like(p) for p in self.params],
                "count": zero.clone(),          # applied steps
                "notfinite_count": zero.clone()}  # skipped in a row

    def learning_rate(self, count):
        """The schedule at ``count`` applied steps (float32 tensor)."""
        lr = torch.full((), self.tcfg.learning_rate, dtype=torch.float32,
                        device=count.device)
        if not self.tcfg.lr_halving:
            return lr
        p = torch.floor(count.float() / self.tcfg.steps_per_epoch)
        return lr * torch.pow(torch.tensor(0.5, device=count.device), p)

    @torch.no_grad()
    def update(self, grads, state, loss=None):
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, self.params)]
        finite = torch.stack([torch.isfinite(g).all() for g in grads]
                             + ([torch.isfinite(loss).all()]
                                if loss is not None else [])).all()
        clip = self.tcfg.grad_clip
        if clip:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            trigger = g_norm < clip
            grads = [torch.where(trigger, g, (g / g_norm) * clip)
                     for g in grads]
        count = state["count"] + 1
        c = count.float()
        bc1 = 1 - torch.pow(torch.tensor(self.b1, device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(self.b2, device=c.device), c)
        step = -self.learning_rate(state["count"])
        for i, (p, g) in enumerate(zip(self.params, grads)):
            mu = (1 - self.b1) * g + self.b1 * state["mu"][i]
            nu = (1 - self.b2) * (g * g) + self.b2 * state["nu"][i]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = step * (u + self.weight_decay * p)
            p.copy_(torch.where(finite, p + u, p))
            state["mu"][i] = torch.where(finite, mu, state["mu"][i])
            state["nu"][i] = torch.where(finite, nu, state["nu"][i])
        state["count"] = torch.where(finite, count, state["count"])
        state["notfinite_count"] = torch.where(
            finite, 0, state["notfinite_count"] + 1)
        return finite


def make_optimizer(model, tcfg: TrainConfig):
    """The optimizer for ``model`` (marks its trainable parameters)."""
    return AdamW(model, tcfg)


def init_train_state(model, tcfg: TrainConfig):
    """(optimizer, its state), as the JAX package's (tx, opt_state)."""
    tx = make_optimizer(model, tcfg)
    return tx, tx.init()


def make_train_step(model, cfg: RaftConfig, tcfg: TrainConfig, tx):
    """One step: ``step(opt_state, batch) -> loss`` (detached), the model's
    parameters and ``opt_state`` updated in place."""

    def step(opt_state, batch):
        loss = woft_loss(model, cfg, tcfg, batch)
        grads = torch.autograd.grad(loss, tx.params, allow_unused=True)
        tx.update(grads, opt_state, loss.detach())
        return loss.detach()

    return step
