"""Plain float32 WeightedRAFT-large: flow and per-pixel reliability weights.

RAFT (Teed & Deng, ECCV 2020: feature and context encoders of residual
blocks, an all-pairs correlation pyramid looked up in a (2r+1)^2 window at
every level, a SepConvGRU update block, convex x8 upsampling) with WOFT's
weight head (Serych & Matas, WACV 2023: a convolution stack over each
cell's looked-up correlation patch and the cell's mean response, averaged
over the patch, convex-upsampled, sigmoid). Written from those
descriptions over a state dict with the published module names; nothing of
the program is imported. Departures, each the trained network's own:

- the weight head reads the lookup's ``L * k * k`` channels as
  ``(k, k, L)``, though they are laid out level-major (the trained
  WeightedRAFT's reshape);
- the lookup's channel ``l*k*k + i*k + j`` samples ``(y + j - r, x + i -
  r)`` (RAFT's transposed window);
- the mean response is the mean of a cell's level-0 correlation row.

Everything runs in float32 with TF32 off. ``rounding`` (``precision.py``)
rounds both operands of every convolution and correlation product, for the
controls.
"""

import math

import torch
import torch.nn.functional as F

from .precision import rounder


class WeightedRaft:
    """The network over a state dict on ``device``.

    ``model``: the configuration's widths (``fnet_dim``, ``hidden_dim``,
    ``context_dim``, ``corr_levels``, ``corr_radius``, ``iters``,
    ``weight_head_structure``)."""

    def __init__(self, state, model, device, precision="fp32"):
        self.p = {k: v.to(device=device, dtype=torch.float32)
                  for k, v in state.items() if v.is_floating_point()}
        self.m = model
        self.round = rounder(precision)
        self.device = device

    # -- building blocks ---------------------------------------------------

    def conv(self, x, name, stride=1):
        w = self.p[f"{name}.weight"]
        kh, kw = w.shape[2:]
        return F.conv2d(self.round(x), self.round(w), self.p[f"{name}.bias"],
                        stride, (kh // 2, kw // 2))

    def norm(self, x, name, kind):
        if kind == "instance":
            return F.instance_norm(x, eps=1e-5)
        return F.batch_norm(x, self.p[f"{name}.running_mean"],
                            self.p[f"{name}.running_var"],
                            self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                            False, 0.0, 1e-5)

    def encoder(self, x, pre, kind):
        """(1, 3, H, W) in [-1, 1] -> (1, C, H/8, W/8)."""
        x = F.relu(self.norm(self.conv(x, f"{pre}.conv1", 2), f"{pre}.norm1",
                             kind))
        for layer, stride in ((1, 1), (2, 2), (3, 2)):
            for block in (0, 1):
                s = stride if block == 0 else 1
                b = f"{pre}.layer{layer}.{block}"
                y = F.relu(self.norm(self.conv(x, f"{b}.conv1", s),
                                     f"{b}.norm1", kind))
                y = F.relu(self.norm(self.conv(y, f"{b}.conv2"), f"{b}.norm2",
                                     kind))
                if s != 1:
                    x = self.norm(self.conv(x, f"{b}.downsample.0", s),
                                  f"{b}.downsample.1", kind)
                x = F.relu(x + y)
        return self.conv(x, f"{pre}.conv2")

    # -- correlation -------------------------------------------------------

    def pyramid(self, f1, f2):
        """All-pairs volume of (1, D, H1, W1) features, pooled 2x2 level by
        level: a list of (Q, Hl, Wl)."""
        D, H1, W1 = f1.shape[1:]
        a = self.round(f1.reshape(D, H1 * W1).T)
        b = self.round(f2.reshape(D, H1 * W1))
        corr = (a @ b / math.sqrt(D)).reshape(H1 * W1, 1, H1, W1)
        levels = [corr[:, 0]]
        for _ in range(1, self.m["corr_levels"]):
            corr = F.avg_pool2d(corr, 2, 2)
            levels.append(corr[:, 0])
        return levels

    def lookup(self, levels, coords, first=0):
        """Bilinear (2r+1)^2 windows at (Q, 2) coordinates (x, y) of the
        queries ``first`` .. ``first + Q - 1``, zero outside: (Q, L *
        (2r+1)^2)."""
        r = self.m["corr_radius"]
        k = 2 * r + 1
        Q = coords.shape[0]
        d = torch.arange(k, device=coords.device) - r
        rows = torch.arange(first, first + Q, device=coords.device)[:, None]
        outs = []
        for lvl, corr in enumerate(levels):
            hl, wl = corr.shape[1:]
            c = coords / 2 ** lvl
            x0, y0 = torch.floor(c[:, 0]), torch.floor(c[:, 1])
            fx, fy = (c[:, 0] - x0)[:, None], (c[:, 1] - y0)[:, None]
            xi = x0.long()[:, None, None] + d[None, :, None]       # i: x
            yj = y0.long()[:, None, None] + d[None, None, :]       # j: y
            flat = corr.reshape(corr.shape[0], hl * wl)
            out = 0
            for dy, wy in ((0, 1 - fy), (1, fy)):
                for dx, wx in ((0, 1 - fx), (1, fx)):
                    gx, gy = xi + dx, yj + dy
                    ok = (gx >= 0) & (gx < wl) & (gy >= 0) & (gy < hl)
                    idx = (gy.clamp(0, hl - 1) * wl + gx.clamp(0, wl - 1))
                    v = flat[rows, idx.reshape(Q, k * k)]
                    out = out + v * (wx * wy) * ok.reshape(Q, k * k)
            outs.append(out)
        return torch.cat(outs, dim=1)

    # -- update block ------------------------------------------------------

    def update(self, net, inp, corr, flow):
        u = "update_block"
        cor = F.relu(self.conv(corr, f"{u}.encoder.convc1"))
        cor = F.relu(self.conv(cor, f"{u}.encoder.convc2"))
        flo = F.relu(self.conv(flow, f"{u}.encoder.convf1"))
        flo = F.relu(self.conv(flo, f"{u}.encoder.convf2"))
        out = F.relu(self.conv(torch.cat([cor, flo], 1), f"{u}.encoder.conv"))
        x = torch.cat([inp, out, flow], 1)
        for d in "12":
            hx = torch.cat([net, x], 1)
            z = torch.sigmoid(self.conv(hx, f"{u}.gru.convz{d}"))
            r = torch.sigmoid(self.conv(hx, f"{u}.gru.convr{d}"))
            q = torch.tanh(self.conv(torch.cat([r * net, x], 1),
                                     f"{u}.gru.convq{d}"))
            net = (1 - z) * net + z * q
        delta = self.conv(F.relu(self.conv(net, f"{u}.flow_head.conv1")),
                          f"{u}.flow_head.conv2")
        return net, delta

    def upsample_mask(self, net):
        m = F.relu(self.conv(net, "update_block.mask.0"))
        return 0.25 * self.conv(m, "update_block.mask.2")

    @staticmethod
    def convex_upsample(x, mask, mul):
        """(1, C, H1, W1) -> (1, C, 8 H1, 8 W1): each fine pixel a softmax
        combination of its cell's 3x3 neighbourhood (zero outside)."""
        _, C, H1, W1 = x.shape
        m = torch.softmax(mask.view(1, 1, 9, 8, 8, H1, W1), dim=2)
        nb = F.unfold(mul * x, [3, 3], padding=1).view(1, C, 9, 1, 1, H1, W1)
        up = torch.sum(m * nb, dim=2)
        return up.permute(0, 1, 4, 2, 5, 3).reshape(1, C, 8 * H1, 8 * W1)

    # -- weight head -------------------------------------------------------

    def weight_logits(self, levels, coords, chunk=2048):
        """Per-cell reliability logits at the final coordinates: (Q,)."""
        r, L = self.m["corr_radius"], self.m["corr_levels"]
        k = 2 * r + 1
        mean = levels[0].mean(dim=(1, 2))
        n_layers = len(self.m["weight_head_structure"]) + 1
        out = []
        for s in range(0, coords.shape[0], chunk):
            c = self.lookup(levels, coords[s:s + chunk], s)
            n = c.shape[0]
            x = torch.cat([c.reshape(n, k, k, L),
                           mean[s:s + n, None, None, None].expand(n, k, k, 1)],
                          dim=-1).permute(0, 3, 1, 2)
            for i in range(n_layers):
                x = self.conv(x, f"weight_head.net.{2 * i}")
                if i + 1 < n_layers:
                    x = F.relu(x)
            out.append(x.mean(dim=(2, 3))[:, 0])
        return torch.cat(out)

    # -- forward -----------------------------------------------------------

    @staticmethod
    def _unit(img):
        """(1, H, W, 3) RGB in [0, 255] -> (1, 3, H, W) in [-1, 1]."""
        return (2.0 * (img / 255.0) - 1.0).permute(0, 3, 1, 2)

    def encode(self, img):
        """The first image's features: (fmap1, net0, inp)."""
        x = self._unit(img)
        fmap = self.encoder(x, "fnet", "instance")
        c = self.encoder(x, "cnet", "batch")
        hd, cd = self.m["hidden_dim"], self.m["context_dim"]
        return fmap, torch.tanh(c[:, :hd]), F.relu(c[:, hd:hd + cd])

    @torch.no_grad()
    def flow(self, first, img2):
        """Flow from the first image (its ``encode``) to (1, H, W, 3) RGB
        ``img2``: (flow (H, W, 2), weights (H, W) in (0, 1))."""
        fmap1, net, inp = first
        fmap2 = self.encoder(self._unit(img2), "fnet", "instance")
        levels = self.pyramid(fmap1, fmap2)
        H1, W1 = fmap1.shape[2:]
        ys, xs = torch.meshgrid(
            torch.arange(H1, dtype=torch.float32, device=self.device),
            torch.arange(W1, dtype=torch.float32, device=self.device),
            indexing="ij")
        coords0 = torch.stack([xs, ys])[None]                # (1, 2, H1, W1)
        coords1 = coords0
        k2 = (2 * self.m["corr_radius"] + 1) ** 2
        for _ in range(self.m["iters"]):
            flat = coords1[0].reshape(2, -1).T
            corr = self.lookup(levels, flat).T.reshape(
                1, self.m["corr_levels"] * k2, H1, W1)
            net, delta = self.update(net, inp, corr, coords1 - coords0)
            coords1 = coords1 + delta
        mask = self.upsample_mask(net)
        flow_up = self.convex_upsample(coords1 - coords0, mask, 8.0)
        logits = self.weight_logits(levels, coords1[0].reshape(2, -1).T)
        w_up = self.convex_upsample(logits.reshape(1, 1, H1, W1), mask, 1.0)
        return flow_up[0].permute(1, 2, 0), torch.sigmoid(w_up[0, 0])
