"""Plain float32 GMA over WeightedRAFT-large: flow and per-pixel reliability
weights.

GMA (Jiang, Campbell, Lu, Li, Hartley, ICCV 2021, arXiv:2104.02409;
github.com/zacjiang/GMA ``core/gma.py``, ``core/network.py``,
``core/update.py``) on top of ``raft.py``'s network: one content-only
attention of one head of 128 channels over every cell of the 1/8 grid,

- ``Attention``: ``q, k = chunk(to_qk(inp), 2)`` from the context features
  after their ReLU (a bias-free 1x1 convolution 128 -> 256), ``q`` scaled
  by 128^-0.5, ``attn = softmax_j(q_i . k_j)``;
- ``Aggregate``: in every iteration, after the motion encoder, ``v =
  to_v(mf)`` (bias-free 1x1, 128 -> 128), ``mf_g = mf + gamma * attn @ v``
  (one head of 128: no ``project``);
- ``GMAUpdateBlock``: the SepConvGRU reads ``cat(inp, mf, mf_g)``, 384
  channels (512 with the hidden state); the flow head, the mask head and
  WOFT's weight head are ``raft.py``'s.

Written from the paper and that code over a state dict with its module
names (``att.to_qk``, ``update_block.aggregator.to_v``,
``update_block.aggregator.gamma``); nothing of the program is imported.
Departures:

- ``RelPosEmb``, which GMA builds but its content-only attention does not
  read, is left out;
- the attention is computed ``chunk`` rows at a time and never stored
  (the same values: a row's softmax needs only its own scores), so that
  N = 32,400 cells need no N x N float32 matrix; it is recomputed from q
  and k in every iteration.

Everything runs in float32 with TF32 off. ``rounding`` (``precision.py``)
also rounds the operands of the attention's two products, q and k, and the
probabilities and v (a chunk of rows of probabilities is one tensor, with a
scale of its own), for the controls.
"""

import math

import torch
import torch.nn.functional as F

from .raft import WeightedRaft

GRU_CONVS = ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2")


def graft_state(state, seed, rows_scale, gamma, dim=128):
    """GMA's state dict from a RAFT-large state dict and the additions a
    configuration assumes, drawn as its ``assumed`` section describes them,
    in this order from ``torch.Generator().manual_seed(seed)``: each
    SepConvGRU convolution's ``dim`` new input rows (after its 384: h, inp,
    mf), uniform in +-``rows_scale`` / sqrt(fan_in) of the widened
    convolution; ``att.to_qk`` (2 dim x dim) and
    ``update_block.aggregator.to_v`` (dim x dim), uniform in +-1 /
    sqrt(dim); ``gamma``."""
    out = {k: v.float() for k, v in state.items() if v.is_floating_point()}
    gen = torch.Generator().manual_seed(int(seed))
    for name in GRU_CONVS:
        key = f"update_block.gru.{name}.weight"
        w = out[key]
        cout, cin, kh, kw = w.shape
        bound = rows_scale / math.sqrt((cin + dim) * kh * kw)
        new = (torch.rand((cout, dim, kh, kw), generator=gen) * 2 - 1) * bound
        out[key] = torch.cat([w, new], dim=1)
    for key, shape in (("att.to_qk.weight", (2 * dim, dim, 1, 1)),
                       ("update_block.aggregator.to_v.weight",
                        (dim, dim, 1, 1))):
        out[key] = ((torch.rand(shape, generator=gen) * 2 - 1)
                    * (1.0 / math.sqrt(dim)))
    out["update_block.aggregator.gamma"] = torch.tensor([float(gamma)])
    return out


class GmaWeightedRaft(WeightedRaft):
    """``raft.WeightedRaft`` with GMA's attention and update block; the
    state dict holds GMA's tensors. ``encode`` returns (fmap1, net0, inp,
    (q, k)) and ``flow`` takes it."""

    def __init__(self, state, model, device, precision="fp32", chunk=2048):
        super().__init__(state, model, device, precision)
        self.chunk = chunk
        self._att = None

    def conv1x1(self, x, name):
        """A bias-free 1x1 convolution."""
        return F.conv2d(self.round(x), self.round(self.p[f"{name}.weight"]))

    def encode(self, img):
        fmap, net, inp = super().encode(img)
        q, k = self.conv1x1(inp, "att.to_qk").chunk(2, dim=1)
        D = q.shape[1]
        q = (D ** -0.5 * q).reshape(D, -1).T                  # (N, D)
        return fmap, net, inp, (q, k.reshape(D, -1).T)

    def aggregate(self, mf):
        """``mf + gamma * attn @ to_v(mf)`` for (1, 128, H1, W1) motion
        features, the attention of ``self._att``."""
        q, k = self._att
        _, D, H1, W1 = mf.shape
        v = self.conv1x1(mf, "update_block.aggregator.to_v").reshape(D, -1).T
        v, kr = self.round(v), self.round(k)
        out = torch.empty_like(v)
        for s in range(0, q.shape[0], self.chunk):
            attn = torch.softmax(self.round(q[s:s + self.chunk]) @ kr.T,
                                 dim=-1)
            out[s:s + self.chunk] = self.round(attn) @ v
        gamma = self.p["update_block.aggregator.gamma"]
        return mf + gamma * out.T.reshape(1, D, H1, W1)

    def update(self, net, inp, corr, flow):
        u = "update_block"
        cor = F.relu(self.conv(corr, f"{u}.encoder.convc1"))
        cor = F.relu(self.conv(cor, f"{u}.encoder.convc2"))
        flo = F.relu(self.conv(flow, f"{u}.encoder.convf1"))
        flo = F.relu(self.conv(flo, f"{u}.encoder.convf2"))
        out = F.relu(self.conv(torch.cat([cor, flo], 1), f"{u}.encoder.conv"))
        mf = torch.cat([out, flow], 1)
        x = torch.cat([inp, mf, self.aggregate(mf)], 1)
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

    @torch.no_grad()
    def flow(self, first, img2):
        """``raft.WeightedRaft.flow`` with GMA: ``first`` is ``encode``'s."""
        fmap1, net, inp, self._att = first
        try:
            return super().flow((fmap1, net, inp), img2)
        finally:
            self._att = None
