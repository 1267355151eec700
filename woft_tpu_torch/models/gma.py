"""GMA: global motion aggregation over the whole 1/8 grid (Jiang, Campbell,
Lu, Li, Hartley, "Learning to Estimate Hidden Motions with Global Motion
Aggregation", ICCV 2021; github.com/zacjiang/GMA ``core/gma.py``,
``core/network.py``, ``core/update.py``).

GMA is RAFT-large at RAFT's widths plus one content-only attention, one
head of 128 channels, over every cell of the 1/8 grid:

- ``Attention`` (parameter ``att.to_qk``): from the context features ``inp``
  (after their ReLU), ``q, k = chunk(to_qk(inp), 2)``, a bias-free 1x1
  convolution 128 -> 256, and ``attn = softmax_j(128^-0.5 q_i . k_j)`` over
  all N cells, once a flow;
- ``Aggregate`` (``update_block.aggregator.to_v`` and ``.gamma``): in each
  iteration, after the motion encoder, ``mf_g = mf + gamma * attn @
  to_v(mf)``, a bias-free 1x1 convolution 128 -> 128 and a learned scalar
  (one head of 128: no ``project``);
- the SepConvGRU reads ``cat(inp, mf, mf_g)``: 384 input channels, so each
  of its convolutions takes 512 (``models/raft.py:BasicUpdateBlock``);
  the flow head and the mask head are RAFT's.

GMA's ``RelPosEmb`` is built there but unused by the content-only attention
(its default: ``--position_only`` and ``--position_and_content`` off), and
is left out here.

In WOFT the flow's first image is the template, so the attention is
template state: ``models/raft.py:encode_template`` builds it once a
sequence (``template_attention``, inside the span
``woft.template.attention``) beside the template's features, and a flow
from both images builds its own. It is stored as the (B, N, N) matrix of
probabilities in the forward's storage type (bf16 in bf16 mode, else
float32), rows computed a chunk at a time: the scores ``q . k`` in float32
from q and k at the compute precision (bf16 in bf16 mode, where products of
bf16 values are exact in float32), scaled, then the row's maximum and sum
of exponentials (the row statistics) in float32, then one rounding. At
1080p (N = 32,400) the bf16 matrix is 2.10 GB.

The aggregation (``aggregate``) runs on one of two routes
(``models/update.py:LoopRoute.gma``): on the card's bf16 route of one
frame pair with no gradient, ``v`` transposed by one product (``vt =
to_v . mf^T``) and kernel M (``ops/kernels.py:gma_aggregate``: the product
with the template's matrix, the residual and the concatenation the GRU
reads); every other route (float32, 'default', a batch, under grad, the
CPU) through ``aggregate_plain``, PyTorch's products. Each aggregation runs
inside the span ``woft.gma.aggregate`` where the loop is not graphed.
"""

import contextlib
import math

import torch
import torch.nn as nn

from ..ops import kernels
from ..utils.profiling import span
from . import layers
from .layers import conv

DIM = 128                   # the head's width: the context and motion width
ROW_CHUNK = 4096            # attention rows computed at a time
_NO_SPAN = contextlib.nullcontext()     # no span inside a graph's capture


class Attention(nn.Module):
    """GMA's ``Attention`` (content only, one head of ``dim``)."""

    def __init__(self, dim=DIM):
        super().__init__()
        self.scale = dim ** -0.5
        self.to_qk = nn.Conv2d(dim, 2 * dim, 1, bias=False)


class Aggregate(nn.Module):
    """GMA's ``Aggregate`` (one head of ``dim``: no ``project``)."""

    def __init__(self, dim=DIM):
        super().__init__()
        self.to_v = nn.Conv2d(dim, dim, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))


def template_attention(att, inp):
    """The attention of the context features ``inp`` (B, 128, H1, W1): (B,
    N, N) probabilities in the storage type of the forward (bf16 in bf16
    mode, else float32), N = H1 * W1, rows summing to 1. Each row's row
    stride is a multiple of 8 elements (kernel M's TMA reads 16-byte rows):
    where N is not, the rows are a view of wider ones."""
    sd = layers.get_compute_dtype()
    qk = conv(att.to_qk, inp, sd)
    B, C2, H1, W1 = qk.shape
    N = H1 * W1
    q, k = qk.reshape(B, C2, N).float().chunk(2, dim=1)     # (B, C, N)
    ld = -(-N // 8) * 8
    store = torch.empty((B, N, ld), dtype=sd or torch.float32,
                        device=inp.device)
    for b in range(B):
        qt, kb = q[b].T, k[b]
        for r in range(0, N, ROW_CHUNK):
            s = (qt[r:r + ROW_CHUNK] @ kb) * att.scale        # (rows, N)
            store[b, r:r + ROW_CHUNK, :N] = torch.softmax(s, dim=-1)
    return store[:, :, :N]


def gma_aggregate_plain(attn, vt, mf, gamma):
    """Plain version of kernel M (arguments as ``gma_aggregate``): the
    product in float32 from bf16 operands, ``mf + gamma * out`` in float32,
    one rounding to bf16."""
    out = attn.float() @ vt.float().T
    mf_g = (mf.float() + gamma.float() * out).to(torch.bfloat16)
    return torch.cat([mf, mf_g], dim=-1)


def gma_aggregate(attn, vt, mf, gamma):
    """``cat(mf, bf16(mf + gamma * attn @ v))`` for one frame pair: attn (N,
    N) bf16 (``template_attention``'s), vt (128, N) bf16 (``to_v(mf)``
    transposed), mf (N, 128) bf16, gamma (1,) float32. Returns (N, 256)
    bf16: kernel M on CUDA tensors, its plain version on the CPU."""
    kernels.require_no_grad("M (gma_aggregate)", attn, vt, mf, gamma)
    if attn.device.type == "cuda":
        return kernels.gma_aggregate(attn, vt, mf, gamma)
    return gma_aggregate_plain(attn, vt, mf, gamma)


def value_t(agg, mf):
    """``to_v(mf)`` transposed, (128, N) bf16, from the channels-minor
    motion features ``mf`` (N, 128) bf16: one product (the weight rounded
    once a pass); rows padded to a multiple of 8 elements where N is not
    (kernel M's TMA reads 16-byte rows)."""
    wv = layers.once_per_pass(
        (id(agg), "wv"),
        lambda: agg.to_v.weight.detach()[:, :, 0, 0].to(torch.bfloat16))
    vt = torch.mm(wv, mf.T)
    N = mf.shape[0]
    if N % 8:
        vt = nn.functional.pad(vt, (0, 8 - N % 8))[:, :N]
    return vt


def aggregate_plain(agg, attn, mf):
    """``cat(mf, mf + gamma * attn @ to_v(mf))``, NCHW, on any route: mf
    (B, 128, H1, W1) in the compute type (bf16 in bf16 mode), attn (B, N,
    N). ``to_v`` as the forward's convolutions run; the product and the
    residual in float32, rounded to mf's type once."""
    sd = layers.get_compute_dtype()
    B, C, H1, W1 = mf.shape
    v = conv(agg.to_v, mf, sd).reshape(B, C, H1 * W1)
    out = torch.matmul(attn.float(), v.float().transpose(1, 2))  # (B, N, C)
    out = out.transpose(1, 2).reshape(B, C, H1, W1)
    mf_g = (mf.float() + agg.gamma.float() * out).to(mf.dtype)
    return torch.cat([mf, mf_g], dim=1)


def aggregate(agg, attn, mf, fused):
    """GMA's aggregation in a refinement step: the GRU's recurrent input
    ``cat(mf, mf_g)`` (B, 256, H1, W1) from the motion features ``mf`` (B,
    128, H1, W1). ``fused``: kernel M (``gma_aggregate``; one frame pair,
    bf16 mode, the result channels-minor in memory under its NCHW shape,
    as kernel H hands ``mf``); else ``aggregate_plain``."""
    capturing = mf.is_cuda and torch.cuda.is_current_stream_capturing()
    with (_NO_SPAN if capturing else span("woft.gma.aggregate", mf.device)):
        if not fused:
            return aggregate_plain(agg, attn, mf)
        kernels.require_no_grad("M (gma_aggregate)", *agg.parameters())
        _, C, H1, W1 = mf.shape
        flat = mf.permute(0, 2, 3, 1).reshape(H1 * W1, C).contiguous()
        x = gma_aggregate(attn[0], value_t(agg, flat), flat, agg.gamma)
        return x.reshape(1, H1, W1, 2 * C).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# GMA over a trained WeightedRAFT: the loader's additions
# ---------------------------------------------------------------------------

@torch.no_grad()
def graft(model, state, seed, rows_scale, gamma):
    """Load a RAFT-large state dict ``state`` (no GMA) into the GMA
    ``WeightedRAFT`` ``model`` and draw GMA's additions from ``seed``.

    Every tensor the two share is copied; each SepConvGRU convolution takes
    the state's weight as its input rows [0, 384) (h, inp, mf) and draws its
    128 new rows [384, 512) (mf_g) from the seed, uniform in +-``rows_scale``
    times torch's default bound (1 / sqrt(fan_in), fan_in of the 512-input
    convolution); then ``to_qk`` and ``to_v`` get torch's default init from
    the seed, and ``gamma`` is set to ``gamma``."""
    own = model.state_dict()
    gru = model.update_block.gru
    grus = {f"update_block.gru.{n}.weight": getattr(gru, n)
            for n in ("convz1", "convr1", "convq1", "convz2", "convr2",
                      "convq2")}
    missing = [k for k in own if k not in state and k not in grus
               and not gma_key(k)]
    if missing:
        raise ValueError(f"the state dict lacks {len(missing)} tensors of "
                         f"RAFT-large, e.g. {missing[:3]}")
    shared = {k: v for k, v in state.items() if k in own and k not in grus}
    model.load_state_dict(shared, strict=False)
    gen = torch.Generator().manual_seed(int(seed))
    for key, mod in grus.items():
        w_old = state[key]
        cout, cin_old, kh, kw = w_old.shape
        cin = mod.weight.shape[1]
        bound = rows_scale / math.sqrt(cin * kh * kw)
        new = (torch.rand((cout, cin - cin_old, kh, kw), generator=gen)
               * 2 - 1) * bound
        mod.weight.copy_(torch.cat([w_old.float(), new], dim=1))
    for mod in (model.att.to_qk, model.update_block.aggregator.to_v):
        bound = 1.0 / math.sqrt(mod.weight.shape[1])
        mod.weight.copy_((torch.rand(mod.weight.shape, generator=gen) * 2 - 1)
                         * bound)
    model.update_block.aggregator.gamma.fill_(float(gamma))


def gma_key(key):
    """Whether a state dict key is one of GMA's own tensors."""
    return key.startswith("att.") or key.startswith("update_block.aggregator.")
