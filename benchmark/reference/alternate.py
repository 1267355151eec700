"""Plain float32 WeightedRAFT-large on RAFT's volume-free correlation.

RAFT's ``AlternateCorrBlock`` (princeton-vl/RAFT ``core/corr.py``, the
``alt_cuda_corr`` extension behind ``--alternate_corr``; Teed & Deng,
ECCV 2020): no all-pairs volume is stored. The second frame's features
are average-pooled 2x2 once a level; a lookup takes, for each query and
level, the correlation of the query's features with the level's features
at the (2r+2)^2 integer positions around its centroid (zero outside the
level, scaled by 1/sqrt(D)) and samples its (2r+1)^2 window bilinearly
from them. Pooling the features equals pooling the all-pairs volume
(correlation is linear in the second frame's features), so this is the
network of ``raft.py`` computed another way; the window order and the
weight head's reading of it are ``raft.py``'s. The mean response of a
cell is its features' product with the mean of the level-0 features,
over sqrt(D): the mean of its level-0 correlation row.

The lookup runs in chunks of queries so that the gathered windows fit
(``chunk`` x (2r+2)^2 x D float32). Everything runs in float32 with TF32
off, as ``raft.py`` (``rounding`` of ``precision.py`` rounds the product
operands for the controls). Nothing of the program is imported.
"""

import math

import torch
import torch.nn.functional as F

from .raft import WeightedRaft


class Features:
    """What the lookups read: the queries' features ``f1`` (Q, D) and the
    second frame's pooled levels ([(Hl, Wl, D)] a level), both as the
    products take them (``rounding`` applied)."""

    def __init__(self, f1, levels):
        self.f1, self.levels = f1, levels


class AlternateWeightedRaft(WeightedRaft):
    """``WeightedRaft`` with the alternate correlation."""

    chunk = 2048

    def pyramid(self, f1, f2):
        """(1, D, H1, W1) features -> ``Features``: no volume."""
        D, H1, W1 = f1.shape[1:]
        a = self.round(f1.reshape(D, H1 * W1).T).contiguous()
        lv = self.round(f2)
        levels = [lv[0].permute(1, 2, 0).contiguous()]
        for _ in range(1, self.m["corr_levels"]):
            lv = F.avg_pool2d(lv, 2, 2)
            levels.append(lv[0].permute(1, 2, 0).contiguous())
        return Features(a, levels)

    def lookup(self, feats, coords, first=0):
        """Bilinear (2r+1)^2 windows at (Q, 2) coordinates (x, y) of the
        queries ``first`` .. ``first + Q - 1``, zero outside: (Q, L *
        (2r+1)^2); channel ``l*k*k + i*k + j`` samples (y + j - r, x + i -
        r) at level l."""
        Q = coords.shape[0]
        if Q > self.chunk:
            return torch.cat([self.lookup(feats, coords[s:s + self.chunk],
                                          first + s)
                              for s in range(0, Q, self.chunk)])
        r = self.m["corr_radius"]
        k, n = 2 * r + 1, 2 * r + 2
        D = feats.f1.shape[1]
        f1 = feats.f1[first:first + Q]
        d = torch.arange(n, device=coords.device) - r
        outs = []
        for lvl, level in enumerate(feats.levels):
            hl, wl = level.shape[:2]
            c = coords / 2 ** lvl
            x0, y0 = torch.floor(c[:, 0]), torch.floor(c[:, 1])
            fx, fy = (c[:, 0] - x0)[:, None, None], (c[:, 1] - y0)[:, None,
                                                                   None]
            xs = x0.long()[:, None] + d                      # (Q, n): x
            ys = y0.long()[:, None] + d                      # (Q, n): y
            ok = (((xs >= 0) & (xs < wl))[:, :, None]
                  & ((ys >= 0) & (ys < hl))[:, None, :])     # (Q, x, y)
            idx = (ys.clamp(0, hl - 1)[:, None, :] * wl
                   + xs.clamp(0, wl - 1)[:, :, None])        # (Q, x, y)
            taps = level.reshape(hl * wl, D)[idx.reshape(-1)].reshape(
                Q, n * n, D)
            corr = (torch.einsum("qd,qpd->qp", f1, taps).reshape(Q, n, n)
                    * ok / math.sqrt(D))                     # [q, x, y]
            out = 0
            for dy, wy in ((0, 1 - fy), (1, fy)):
                for dx, wx in ((0, 1 - fx), (1, fx)):
                    out = out + corr[:, dx:dx + k, dy:dy + k] * (wx * wy)
            outs.append(out.reshape(Q, k * k))
        return torch.cat(outs, dim=1)

    def weight_logits(self, feats, coords, chunk=2048):
        """Per-cell reliability logits at the final coordinates: (Q,),
        ``raft.py``'s head over this lookup, the mean response from the
        features."""
        r, L = self.m["corr_radius"], self.m["corr_levels"]
        k = 2 * r + 1
        D = feats.f1.shape[1]
        mean_f2 = feats.levels[0].reshape(-1, D).mean(dim=0)
        mean = feats.f1 @ mean_f2 / math.sqrt(D)
        n_layers = len(self.m["weight_head_structure"]) + 1
        out = []
        for s in range(0, coords.shape[0], chunk):
            c = self.lookup(feats, coords[s:s + chunk], s)
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
