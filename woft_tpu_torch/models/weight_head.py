"""The weight head as one kernel in bf16 mode (kernel J): its route, its
plain version and the weight layout both read.

Which route ``models/raft.py:weight_head_apply`` takes, from what it can
observe (``fused_route``): kernel J when the precision scope is bf16, the
tensors are on the card, no gradient flows into the head (its parameters
and its inputs), and the head is WOFT's: ``((128, 3), (128, 3), (128,
3))`` over a 9 x 9 patch of 4 levels (``WeightedRAFT``'s default
``weight_head_structure``). Everything else keeps the unfused conv stack
(``raft.weight_head_chain``) bit for bit: 'highest' and 'default', training,
other structures (RAFT-small's one 32-channel layer), the CPU.

No TPU twin: the JAX package runs its weight head through XLA. The unfused
bf16 path rounds each convolution's input and weight to bf16 and sums in
float32 (``layers.conv2d``), and kernel J keeps those rounding points
(``weight_head_plain``, the kernel's arithmetic on the CPU): the lookup and
the mean response rounded to bf16, each 3x3 convolution's products of bf16
operands summed in float32, the float32 bias added, ReLU and one rounding to
bf16; the 1x1 convolution over the bf16 activations with the bf16-rounded
weight, its float32 bias, and the mean of the 81 positions in float32.
Products of bf16 values are exact in float32, so the two paths differ only
in the order of their float32 sums (and, where a sum lands near a rounding
boundary, in an activation's last bf16 bit).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import layers, update
from ..ops import kernels

KP, LEVELS = 9, 4
_BF16 = torch.bfloat16
_C = 128


def _has_kernel_structure(head):
    """Conv(5, 128, 3), ReLU, two Conv(128, 128, 3) with ReLUs, Conv(128, 1,
    1): the stack kernel J computes, zero-padded, stride 1, with biases."""
    mods = list(head.net)
    if [type(m) for m in mods] != [nn.Conv2d, nn.ReLU] * 3 + [nn.Conv2d]:
        return False
    convs = mods[::2]
    shapes = [(c.in_channels, c.out_channels, c.kernel_size, c.padding)
              for c in convs]
    plain = all(c.stride == (1, 1) and c.dilation == (1, 1) and c.groups == 1
                and c.bias is not None for c in convs)
    return plain and shapes == [(LEVELS + 1, _C, (3, 3), (1, 1)),
                                (_C, _C, (3, 3), (1, 1)),
                                (_C, _C, (3, 3), (1, 1)),
                                (_C, 1, (1, 1), (0, 0))]


def _on_card(*tensors):
    return all(t.is_cuda for t in tensors)


def fused_route(head, corr_sample, mean_response):
    """True when ``weight_head_apply(head, corr_sample, mean_response)``
    runs kernel J (see the module docstring)."""
    _, _, _, kp, kp2, L = corr_sample.shape
    return (layers.get_compute_dtype() == _BF16
            and _on_card(corr_sample, mean_response)
            and (kp, kp2, L) == (KP, KP, LEVELS) and corr_sample.numel() > 0
            and not (torch.is_grad_enabled() and any(
                t.requires_grad for t in (corr_sample, mean_response,
                                          *head.parameters())))
            and _has_kernel_structure(head))


def head_params(head):
    """Kernel J's weights of a ``WeightHead``: (taps (19 * 128, 128) bf16,
    consts (513,) float32).

    taps: blocks of 128 output rows, input channels minor: block 0 conv1 as
    the im2col product (column ``(ky * 3 + kx) * 5 + c``, columns 45-127
    zero), blocks 1-9 conv2's taps (ky * 3 + kx), 10-18 conv3's. consts: b1
    | b2 | b3 | w4 rounded to bf16 | b4."""
    c1, c2, c3, c4 = list(head.net)[::2]
    w1 = c1.weight.detach().permute(0, 2, 3, 1).reshape(_C, 9 * (LEVELS + 1))
    taps = torch.zeros(19 * _C, _C, dtype=_BF16, device=w1.device)
    taps[:_C, :w1.shape[1]] = w1.to(_BF16)
    taps[_C:10 * _C] = update.taps(c2.weight).reshape(9 * _C, _C)
    taps[10 * _C:] = update.taps(c3.weight).reshape(9 * _C, _C)
    consts = torch.cat([c1.bias, c2.bias, c3.bias,
                        c4.weight.reshape(_C).to(_BF16).float(), c4.bias])
    return taps, consts.detach().float().contiguous()


def _conv3(x, w):
    """Zero-padded 3x3 convolution of (M, 9, 9, C_in) maps as a sum of nine
    per-tap products, w (9, C_out, C_in); in x's dtype."""
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for t in range(9):
        ky, kx = divmod(t, 3)
        part = xp[:, ky:ky + KP, kx:kx + KP] @ w[t].T
        acc = part if acc is None else acc + part
    return acc


def weight_head_plain(corr, mean, taps, consts, dtype=torch.float32):
    """Plain version of kernel J (arguments as ``weight_head``): its
    arithmetic, conv1 as the im2col product, summed in ``dtype`` (float32;
    float64 gives the card tests their reference at the same rounding
    points)."""
    M = corr.shape[0]
    x = torch.cat([corr.to(dtype).reshape(M, KP, KP, LEVELS),
                   mean.to(dtype).reshape(M, 1, 1, 1).expand(M, KP, KP, 1)],
                  dim=-1).to(_BF16).to(dtype)
    w = taps.to(dtype)
    b = consts.to(dtype)

    def round_relu(v):          # relu(bf16(v)) == bf16(relu(v))
        return F.relu(v.to(_BF16)).to(dtype)

    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, ky:ky + KP, kx:kx + KP]
                      for ky in range(3) for kx in range(3)], dim=-1)
    h = round_relu(cols @ w[:_C, :cols.shape[-1]].T + b[:_C])
    for layer in range(2):
        blk = w[(1 + 9 * layer) * _C:(10 + 9 * layer) * _C]
        h = round_relu(_conv3(h, blk.reshape(9, _C, _C))
                       + b[(layer + 1) * _C:(layer + 2) * _C])
    s = h @ b[3 * _C:4 * _C] + b[4 * _C]
    return s.mean(dim=(1, 2))


def weight_head(corr, mean, taps, consts):
    """The weight head's (M,) float32 logits of M rows in bf16 mode: corr
    (M, 324) float32 or bf16, a row's lookup in the dense lookup's channel
    order; mean (M,) float32; taps, consts: ``head_params``. Kernel J on a
    CUDA tensor, ``weight_head_plain`` on a CPU tensor; raises under grad."""
    kernels.require_no_grad("J (weight_head)", corr, mean, taps, consts)
    if corr.device.type == "cuda":
        return kernels.weight_head(corr, mean, taps, consts)
    return weight_head_plain(corr, mean, taps, consts)
