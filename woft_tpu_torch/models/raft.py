"""RAFT (large and small) and WeightedRAFT in PyTorch.

PyTorch twin of ``woft_tpu/models/raft.py``. The networks are
``nn.Module``s whose parameter names follow the reference checkpoints
(``fnet``, ``cnet``, ``update_block``, and by ``RaftConfig.variant``
``weight_head`` and ``mask_head``); the forward pass is a plain function
over the module, as in the JAX package. Variants: 'weighted' (flow and
reliability weights), 'orig' (RAFT: flow only) and 'weighted_masked'
(weights and a visibility mask from ``mask_head`` over the template
features and the current features sampled at the flow's end points).

The forward reads encode -> correlation -> refine -> upsample -> heads, and
leaves two decisions to a module each, made once a forward:

- the correlation (``models/corr.py:make_correlation``, a ``Correlation``):
  the all-pairs pyramid built from pooled features and looked up 12x per
  flow by kernel B; no stored volume, each lookup computed from the
  features (plain PyTorch, as the reference's is XLA); or, for one frame
  pair, the block-local volume built by kernel C and looked up by kernels
  D and E in blocked form, which the motion encoder's 1x1 ``convc1``
  consumes directly (``corr.lookup_conv1x1``); the pyramid and the
  block-local volume also spread over ranks (``parallel/sharding.py``);
- the refinement loop's route (``models/update.py:loop_route``, a
  ``LoopRoute``): for a forward of RAFT-large on one frame pair with no
  gradient through the update block, no flag, the SepConvGRU as kernel G's
  float32 form in 'highest', and in bf16 mode on the card the motion
  encoder as kernel H, the SepConvGRU as the bf16 kernel G and the flow
  head as kernel I; otherwise the unfused update block (bf16 on the CPU:
  G and I under the flags below), or RAFT-small's own block. Its
  loop-invariant context (``inp``'s part of the SepConvGRU's convolutions)
  is computed once per frame (``LoopRoute.context``; exact by conv
  linearity).

Besides:

- in a forward that records no gradient the feature encoder's instance
  norms, each with the convolution's bias before it, the ReLU after it and
  at a block's end the residual add and its ReLU, run as kernel L on the
  card (``kernels.instance_norm_act``,
  13 calls and 27 launches an encoded image for RAFT-large, 19 and 39 for
  RAFT-small; one fewer where the image comes NCHW-contiguous, as the
  downscale paths' resize leaves it) and as its plain version, the
  modules' calls, on the CPU,
- the template's features are encoded once per sequence
  (``encode_template``); per frame only the current frame is encoded,
- the convex-upsample mask is computed after the loop from the final
  hidden state (``mask_from_net``),
- ``sparse_weight_head=True`` defers the weight head to a closure
  ``weight_head_at(cells)`` that evaluates the same logits at M cells only
  (``Correlation.rows_at``: the pyramid's rows read in place).
- the forward's stages run inside the program's spans
  (``utils/profiling.py``; off unless a profiler records or
  ``recording()`` is open): ``woft.flow.encode``, ``woft.flow.volume``,
  ``woft.flow.refine`` (the GRU context and the iterations),
  ``woft.flow.upsample`` (the mask head and the upsampling) and
  ``woft.weight_head`` (its lookup and ``weight_head_apply``).
- on the card, a block-local forward of one frame pair that records no
  gradient builds its volume and runs the GRU context and the iterations
  as one CUDA graph, captured at a shape's first forward and replayed
  after it (``models/loop_graph.py``): one launch where the loop has ~80
  an iteration, which the host issued slower than the card ran them. The
  same kernels, so the same results; kernel C then runs inside
  ``woft.flow.refine``.

Images are NHWC float RGB in [0, 255]; inside, everything runs NCHW.
``precision='highest'`` is float32 throughout (TF32 off, see
``device.resolve_device``). ``precision='bf16'`` rounds where the reference
does (``models/layers.py``): convolution inputs, weights and stored
activations are bf16 with float32 accumulation; the GRU state ``net``, the
coordinates, the flow deltas, ``mean_response``, the feature maps entering
the correlation, the upsampling mask and the weight logits stay float32.
``precision='default'`` keeps float32 activations and lets the card use
TF32 for the forward's products (the reference's lax ``DEFAULT``). In both
'bf16' and 'default' the correlation volumes are stored in bf16, as the
reference stores them: the dense pyramid's levels (each computed in
float32, then rounded; kernel B widens them as it reads) and the
block-local volume.

``train_forward`` is the same forward with autograd on (the trainer's,
``training/train.py``); ``weighted_raft_forward`` and ``encode_template``
run under ``torch.no_grad``. ``RaftConfig.small`` is RAFT-small, the
network of the training tests.
"""

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import kernels
from ..ops.warp import coords_grid, grid_sample, upflow8
from ..utils.profiling import span
from . import layers, loop_graph
from .corr import lookup_conv1x1, make_correlation
from .layers import conv, conv2d, init_conv_, norm_layer
from . import update
from . import weight_head as whead


@dataclass(frozen=True)
class RaftConfig:
    """WeightedRAFT-large configuration. The defaults are the canonical
    ``WOFT.py`` flow; ``WOFT_fast.py`` sets ``corr_impl='local'`` and
    ``precision='bf16'``.

    variant: 'weighted', 'orig' (no weight head: flow only) or
        'weighted_masked' (also ``mask_head``, of ``mask_head_structure``).
    alternate_corr: no stored volume; each lookup is computed from the
        features, ``alt_chunk`` queries at a time (frames whose pyramid
        does not fit the card). Takes precedence over ``corr_impl``.
    corr_impl: 'dense' (all-pairs pyramid, kernel B) or 'local'
        (block-local volume within +-``local_margin`` 1/8-resolution cells,
        kernels C, D, E; a batch of more than one pair takes 'dense').
    fine_check: under 'local', rewrite blocks whose lookups do not fit the
        fine sub-window with the exact lookup (kernel E).
    precision: 'highest' (float32), 'default' or 'bf16' (see the module
        docstring).
    gru_fused: each direction of the SepConvGRU as one launch of the bf16
        kernel G in the refinement loop; the counterpart of the JAX
        package's ``gru_pallas``, and the CPU's parity switch: on the card
        a bf16 forward of one frame pair with no gradient through the loop
        runs G, H and I whatever the flags (``update.loop_route``). In
        effect only in bf16 mode and for one frame pair; otherwise the
        precision's route runs (float32: kernel G's float32 form, without
        this flag; 'default' and the other cases: the unfused path).
    tail_fused: the flow head as one fused kernel (I) in the loop; the
        counterpart of ``tail_pallas``, with the same gating. As there, the
        motion encoder stays unfused under the flag (kernel H runs on the
        card's route only).
    small: RAFT-small (bottleneck encoders, the small motion encoder, a
        3x3 ConvGRU, hidden 96, context 64, features 128, radius 3, the
        bilinear ``upflow8`` output: no convex-upsampling mask); the
        training tests' network, as in the JAX package. No fused kernel.
    radius: the lookup radius; 0 (the default) is 3 under ``small``, else
        4.
    """
    iters: int = 12
    corr_levels: int = 4
    radius: int = 0
    weight_head_structure: Tuple = ((128, 3), (128, 3), (128, 3))
    variant: str = "weighted"
    mask_head_structure: Tuple = ()
    alternate_corr: bool = False
    alt_chunk: int = 4096
    corr_impl: str = "dense"
    local_margin: int = 16
    fine_check: bool = True
    precision: str = "highest"
    gru_fused: bool = False
    tail_fused: bool = False
    small: bool = False

    @property
    def hidden_dim(self):
        return 96 if self.small else 128

    @property
    def context_dim(self):
        return 64 if self.small else 128

    @property
    def fnet_dim(self):
        return 128 if self.small else 256

    def __post_init__(self):
        if not self.radius:
            object.__setattr__(self, "radius", 3 if self.small else 4)
        if self.corr_impl not in ("dense", "local"):
            raise ValueError(f"corr_impl must be 'dense' or 'local', got "
                             f"{self.corr_impl!r}")
        if self.precision not in layers.PRECISIONS:
            raise ValueError(f"precision must be one of {layers.PRECISIONS}, "
                             f"got {self.precision!r}")
        if self.variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got "
                             f"{self.variant!r}")

    @property
    def volume_dtype(self):
        """Storage dtype of the correlation volumes: bf16 in the 'bf16' and
        'default' modes (the reference's), else float32."""
        return (torch.bfloat16 if self.precision in ("default", "bf16")
                else torch.float32)


VARIANTS = ("weighted", "orig", "weighted_masked")


# ---------------------------------------------------------------------------
# encoders (ref:raft_core/extractor.py, BasicEncoder)
# ---------------------------------------------------------------------------

def _norm_route(module):
    """Whether an encoder module's norms take kernel L
    (``kernels.instance_norm_act``: each instance norm with the
    convolution's bias before it and the ReLU after it, and at a block's
    end the residual add and its ReLU): under
    ``norm_fn == 'instance'`` (the feature encoder) in a forward that
    records no gradient, whatever the device and precision; the wrapper
    takes its plain version, the modules' own calls, on the CPU. Training
    keeps the modules."""
    return (not torch.is_grad_enabled()
            and isinstance(module.norm1, nn.InstanceNorm2d))


def _norm_input(mod, x, sd):
    """A convolution that feeds one of kernel L's norms, as (output, bias):
    on the card without its bias, which L adds as PyTorch's own pass after
    cuDNN's product does, with the same rounding; on the CPU with it."""
    if not x.is_cuda:
        return conv(mod, x, sd), None
    return (conv2d(x, mod.weight, None, mod.stride, mod.padding, sd),
            layers.conv_bias(mod.bias, sd))


def _norm_act(mod, x, sd):
    """``relu(norm(mod(x)))`` on kernel L's route."""
    y, b = _norm_input(mod, x, sd)
    return kernels.instance_norm_act(y, bias=b)


def _block_end(block, mod, y, x, sd):
    """A block's last norm on kernel L's route: ``relu(x +
    relu(norm(mod(y))))``, ``x`` the block's input or, with a strided
    shortcut, its convolution's output normalised in the same call."""
    y, b = _norm_input(mod, y, sd)
    if block.downsample is None:
        return kernels.instance_norm_act(y, residual=x, bias=b)
    s, sb = _norm_input(block.downsample[0], x, sd)
    return kernels.instance_norm_act(y, shortcut=s, bias=b, shortcut_bias=sb)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn, stride):
        super().__init__()
        ng = planes // 8
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = norm_layer(norm_fn, planes, ng)
        self.norm2 = norm_layer(norm_fn, planes, ng)
        if stride == 1:
            self.downsample = None
        else:
            # the reference registers the shortcut norm twice, as norm3 and
            # as downsample.1; its checkpoints carry both keys
            self.norm3 = norm_layer(norm_fn, planes, ng)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        sd = layers.get_compute_dtype()    # bf16 mode stores activations bf16
        if _norm_route(self):
            return _block_end(self, self.conv2, _norm_act(self.conv1, x, sd),
                              x, sd)
        y = F.relu(self.norm1(conv(self.conv1, x, sd)))
        y = F.relu(self.norm2(conv(self.conv2, y, sd)))
        if self.downsample is not None:
            x = self.downsample[1](conv(self.downsample[0], x, sd))
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    """RAFT-small's block: 1x1, strided 3x3 and 1x1 convolutions at a
    quarter of the planes, and a strided 1x1 shortcut."""

    def __init__(self, in_planes, planes, norm_fn, stride):
        super().__init__()
        ng = planes // 8
        self.conv1 = nn.Conv2d(in_planes, planes // 4, 1)
        self.conv2 = nn.Conv2d(planes // 4, planes // 4, 3, stride=stride,
                               padding=1)
        self.conv3 = nn.Conv2d(planes // 4, planes, 1)
        self.norm1 = norm_layer(norm_fn, planes // 4, ng)
        self.norm2 = norm_layer(norm_fn, planes // 4, ng)
        self.norm3 = norm_layer(norm_fn, planes, ng)
        if stride == 1:
            self.downsample = None
        else:
            # registered twice, as norm4 and downsample.1, as the reference
            self.norm4 = norm_layer(norm_fn, planes, ng)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm4)

    def forward(self, x):
        sd = layers.get_compute_dtype()
        if _norm_route(self):
            y = _norm_act(self.conv2, _norm_act(self.conv1, x, sd), sd)
            return _block_end(self, self.conv3, y, x, sd)
        y = F.relu(self.norm1(conv(self.conv1, x, sd)))
        y = F.relu(self.norm2(conv(self.conv2, y, sd)))
        y = F.relu(self.norm3(conv(self.conv3, y, sd)))
        if self.downsample is not None:
            x = self.downsample[1](conv(self.downsample[0], x, sd))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """(N, 3, H, W) in [-1, 1] -> (N, output_dim, H/8, W/8); ``small``:
    RAFT-small's encoder (bottleneck blocks, 32-64-96 planes)."""

    def __init__(self, output_dim, norm_fn, small=False):
        super().__init__()
        block = BottleneckBlock if small else ResidualBlock
        first = 32 if small else 64
        self.conv1 = nn.Conv2d(3, first, 7, stride=2, padding=3)
        self.norm1 = norm_layer(norm_fn, first, 8)
        dims = (32, 64, 96) if small else (64, 96, 128)
        cin = first
        for name, planes, stride in zip(("layer1", "layer2", "layer3"), dims,
                                        (1, 2, 2)):
            setattr(self, name, nn.Sequential(
                block(cin, planes, norm_fn, stride),
                block(planes, planes, norm_fn, 1)))
            cin = planes
        self.conv2 = nn.Conv2d(cin, output_dim, 1)

    def forward(self, x):
        sd = layers.get_compute_dtype()
        if _norm_route(self):
            # conv1 keeps its input's channels-last strides (the images are
            # NHWC): L's stem form reads them and writes NCHW, where
            # torch's instance norm copies the map first
            x = _norm_act(self.conv1, x, sd)
        else:
            x = F.relu(self.norm1(conv(self.conv1, x, sd)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return conv(self.conv2, x)              # features stay float32


# ---------------------------------------------------------------------------
# update block (ref:raft_core/update.py)
# ---------------------------------------------------------------------------

class BasicMotionEncoder(nn.Module):
    def __init__(self, cor_planes):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr, fused=False):
        """``fused``: the 3x3 stack and the final ``cat`` as one kernel (H;
        bf16 mode, one frame pair; no backward: raises under grad when a
        parameter requires grad); ``convc1`` and the 7x7 two-channel
        ``convf1`` stay as they are."""
        if fused:
            kernels.require_no_grad("H (motion_encoder_tail)",
                                    *self.parameters())
        sd = layers.get_compute_dtype()
        cor = F.relu(lookup_conv1x1(corr, self.convc1.weight,
                                    self.convc1.bias))
        flo = F.relu(conv(self.convf1, flow, sd))
        if fused:
            update.require_bf16_mode("the fused motion encoder")
            params = layers.once_per_pass(
                (id(self), "taps"), lambda: update.motion_encoder_params(self))
            return _nchw(update.motion_encoder_tail(
                update.nhwc(cor.to(sd)), update.nhwc(flo), update.nhwc(flow),
                *params))
        cor = F.relu(conv(self.convc2, cor, sd))
        flo = F.relu(conv(self.convf2, flo, sd))
        out = F.relu(conv(self.conv, torch.cat([cor, flo], dim=1), sd))
        return torch.cat([out, flow.to(out.dtype)], dim=1)


class SmallMotionEncoder(nn.Module):
    """RAFT-small's motion encoder: 82 channels, ``cat(out80, flow)``."""

    def __init__(self, cor_planes):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, 96, 1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 32, 3, padding=1)
        self.conv = nn.Conv2d(128, 80, 3, padding=1)

    def forward(self, flow, corr):
        sd = layers.get_compute_dtype()
        cor = F.relu(lookup_conv1x1(corr, self.convc1.weight,
                                    self.convc1.bias))
        flo = F.relu(conv(self.convf1, flow, sd))
        flo = F.relu(conv(self.convf2, flo, sd))
        out = F.relu(conv(self.conv, torch.cat([cor, flo], dim=1), sd))
        return torch.cat([out, flow.to(out.dtype)], dim=1)


class SepConvGRU(nn.Module):
    """1x5 then 5x1 gated updates. Each conv reads [h, inp, motion]."""

    def __init__(self, hidden_dim=128, input_dim=256):
        super().__init__()
        c = hidden_dim + input_dim
        for names, ksize in ((update.GRU_DIRS[0][:3], (1, 5)),
                             (update.GRU_DIRS[1][:3], (5, 1))):
            pad = (ksize[0] // 2, ksize[1] // 2)
            for name in names:
                setattr(self, name, nn.Conv2d(c, hidden_dim, ksize,
                                              padding=pad))


class ConvGRU(nn.Module):
    """RAFT-small's 3x3 ConvGRU; each conv reads [h, inp, motion]."""

    def __init__(self, hidden_dim=96, input_dim=146):
        super().__init__()
        for name in ("convz", "convr", "convq"):
            setattr(self, name, nn.Conv2d(hidden_dim + input_dim, hidden_dim,
                                          3, padding=1))

    def forward(self, h, x):
        """One gated update of ``h`` by ``x`` = cat(inp, motion), z and r
        as one convolution; in bf16 mode the gates are bf16 and ``h``
        stays float32, as in ``update.LoopRoute.sep_conv_gru``."""
        sd = layers.get_compute_dtype()
        C = h.shape[1]
        zr = conv2d(torch.cat([h.to(x.dtype), x], dim=1),
                    torch.cat([self.convz.weight, self.convr.weight]),
                    torch.cat([self.convz.bias, self.convr.bias]),
                    padding=1, out_dtype=sd)
        z = torch.sigmoid(zr[:, :C])
        r = torch.sigmoid(zr[:, C:])
        q = torch.tanh(conv2d(torch.cat([(r * h).to(x.dtype), x], dim=1),
                              self.convq.weight, self.convq.bias, padding=1,
                              out_dtype=sd))
        return (1 - z) * h + z * q


class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x, fused=False):
        """``fused``: both convolutions as one kernel (I; bf16 mode, one
        frame pair)."""
        if fused:
            kernels.require_no_grad("I (flow_head)", *self.parameters())
            update.require_bf16_mode("the fused flow head")
            params = layers.once_per_pass(
                (id(self), "taps"), lambda: update.flow_head_params(self))
            return _nchw(update.flow_head(update.nhwc(x), *params))
        h = F.relu(conv(self.conv1, x, layers.get_compute_dtype()))
        return conv(self.conv2, h)                # the delta stays float32


class BasicUpdateBlock(nn.Module):
    def __init__(self, cor_planes, hidden_dim=128):
        super().__init__()
        self.encoder = BasicMotionEncoder(cor_planes)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(nn.Conv2d(128, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  nn.Conv2d(256, 64 * 9, 1))


class SmallUpdateBlock(nn.Module):
    def __init__(self, cor_planes, hidden_dim=96):
        super().__init__()
        self.encoder = SmallMotionEncoder(cor_planes)
        self.gru = ConvGRU(hidden_dim, 82 + 64)
        self.flow_head = FlowHead(hidden_dim, 128)


def mask_from_net(block, net):
    """Convex-upsample mask logits from a GRU state (0.25-scaled)."""
    return 0.25 * conv(block.mask[2], F.relu(conv(block.mask[0], net)))


def convex_upsample(flow, mask, mul=8.0):
    """Convex-combination x8 upsampling.

    flow: (B, C, H, W); mask: (B, 9*64, H, W), channel p*64 + fy*8 + fx.
    Returns (B, C, 8H, 8W); ``mul`` scales the values (8 for flow)."""
    B, C, H, W = flow.shape
    m = torch.softmax(mask.view(B, 1, 9, 8, 8, H, W), dim=2)
    patches = F.unfold(mul * flow, [3, 3], padding=1).view(B, C, 9, 1, 1, H, W)
    up = torch.sum(m * patches, dim=2)                      # (B,C,8,8,H,W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, C, 8 * H, 8 * W)


# ---------------------------------------------------------------------------
# weight head (ref:weighted_raft.py:318-384)
# ---------------------------------------------------------------------------

class WeightHead(nn.Module):
    """Conv stack [(ch, k), ...] + ReLU each, then a 1x1 conv to 1 channel;
    keys follow nn.Sequential numbering with interleaved ReLUs."""

    def __init__(self, structure, cin):
        super().__init__()
        mods = []
        for ch, k in structure:
            mods += [nn.Conv2d(cin, ch, k, padding=k // 2), nn.ReLU(inplace=True)]
            cin = ch
        mods.append(nn.Conv2d(cin, 1, 1))
        self.net = nn.Sequential(*mods)


def weight_head_apply(head, corr_sample, mean_response):
    """Flow-reliability logits from the lookup and the mean response.

    corr_sample: (B, H1, W1, Kp, Kp, L) — the lookup's L*Kp*Kp channels
      split as (H_patch, W_patch, levels), copying the reference's reshape
      although the channels are laid out level-major.
    mean_response: (B, H1, W1).
    Returns (B, H1, W1, 1) logits: the head convolves over each cell's
    Kp x Kp patch and averages. In bf16 mode on the card, WOFT's head with
    no gradient is one launch of kernel J (``weight_head.fused_route``);
    every other call runs ``weight_head_chain``."""
    if not whead.fused_route(head, corr_sample, mean_response):
        return weight_head_chain(head, corr_sample, mean_response)
    B, H1, W1, Kp, _, L = corr_sample.shape
    n = B * H1 * W1
    params = layers.once_per_pass((id(head), "taps"),
                                  lambda: whead.head_params(head))
    w = whead.weight_head(corr_sample.reshape(n, Kp * Kp * L).contiguous(),
                          mean_response.reshape(n).float().contiguous(),
                          *params)
    return w.reshape(B, H1, W1, 1)


def weight_head_chain(head, corr_sample, mean_response):
    """``weight_head_apply`` as the unfused conv stack: a convolution (cuDNN
    on the card) and a ReLU a layer, over the cells' (L + 1, Kp, Kp)
    patches, then the mean."""
    B, H1, W1, Kp, _, L = corr_sample.shape
    n = B * H1 * W1
    x = corr_sample.reshape(n, Kp, Kp, L)
    mean = mean_response.reshape(n, 1, 1, 1).expand(n, Kp, Kp, 1)
    x = torch.cat([x, mean], dim=-1).permute(0, 3, 1, 2)    # (n, L+1, Kp, Kp)
    for mod in head.net:
        x = conv(mod, x) if isinstance(mod, nn.Conv2d) else F.relu(x)
    w = x.mean(dim=(2, 3))                                  # (n, 1)
    return w.reshape(B, H1, W1, 1)


def mask_head_apply(head, template_features, current_features):
    """Visibility-mask logits (B, 1, H1, W1) from the template features and
    the current features sampled at the flow's end points, both (B, D,
    H1, W1): the conv stack over their concatenation."""
    x = torch.cat([template_features, current_features], dim=1)
    for mod in head.net:
        x = conv(mod, x) if isinstance(mod, nn.Conv2d) else F.relu(x)
    return x


class WeightedRAFT(nn.Module):
    """The parameter container of RAFT-large and its weighted variants:
    ``weight_head`` unless ``cfg.variant == 'orig'``, ``mask_head`` under
    'weighted_masked'."""

    def __init__(self, cfg: RaftConfig):
        super().__init__()
        hdim, cdim = cfg.hidden_dim, cfg.context_dim
        cor_planes = cfg.corr_levels * (2 * cfg.radius + 1) ** 2
        self.fnet = BasicEncoder(cfg.fnet_dim, "instance", cfg.small)
        self.cnet = BasicEncoder(hdim + cdim,
                                 "none" if cfg.small else "batch", cfg.small)
        self.update_block = (SmallUpdateBlock(cor_planes, hdim) if cfg.small
                             else BasicUpdateBlock(cor_planes, hdim))
        if cfg.variant != "orig":
            self.weight_head = WeightHead(cfg.weight_head_structure,
                                          cfg.corr_levels + 1)
        if cfg.variant == "weighted_masked":
            self.mask_head = WeightHead(cfg.mask_head_structure,
                                        2 * cfg.fnet_dim)


def init_raft_params(cfg: RaftConfig, seed=0, device="cpu"):
    """A ``WeightedRAFT`` of ``cfg.variant`` with seeded random weights (the
    JAX package's
    distributions; the first conv of each encoder kaiming-normal fan_out,
    the rest torch's default conv init; norms at identity), drawn on the
    CPU from ``torch.Generator().manual_seed(seed)``."""
    gen = torch.Generator().manual_seed(seed)
    model = WeightedRAFT(cfg)
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d):
            init_conv_(mod, gen,
                       kaiming_out=name in ("fnet.conv1", "cnet.conv1"))
    return model.to(device).eval()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _context(cfg, cnet):
    """(net0, inp) from the context encoder's output."""
    hdim, cdim = cfg.hidden_dim, cfg.context_dim
    return torch.tanh(cnet[:, :hdim]), F.relu(cnet[:, hdim:hdim + cdim])


@torch.no_grad()
def encode_template(model, cfg: RaftConfig, image1):
    """Frame-1 features for the forward pass: (fmap1, net0, inp), each
    NHWC. image1: (B, H, W, 3) float RGB in [0, 255]."""
    x1 = _nchw(2.0 * (image1 / 255.0) - 1.0)
    with layers.precision_scope(cfg.precision):
        fmap1 = model.fnet(x1)
        net, inp = _context(cfg, model.cnet(x1))
    return _nhwc(fmap1), _nhwc(net), _nhwc(inp)


@torch.no_grad()
def weighted_raft_forward(model, cfg: RaftConfig, image1, image2,
                          flow_init=None, iters=None, template_feats=None,
                          sparse_weight_head=False, corr_shard=None):
    """Flow and, by ``cfg.variant``, reliability weights and a visibility
    mask between two frames.

    Args:
        model: a ``WeightedRAFT`` of ``cfg.variant``.
        cfg: its ``RaftConfig``.
        image1, image2: (B, H, W, 3) float RGB in [0, 255], H, W % 8 == 0;
            ``image1`` may be None when ``template_feats`` is given.
        flow_init: optional (B, H/8, W/8, 2) initial flow.
        iters: GRU iterations (defaults to cfg.iters).
        template_feats: optional (fmap1, net0, inp) from ``encode_template``.
        sparse_weight_head: ('weighted' only; the other variants ignore it,
            as the reference does) return ``weight_head_at(rows)`` — (M,)
            int64 rows ``b*H1*W1 + cell`` of flat 1/8-grid cells of batch
            element b -> (M,) logits equal to the dense head's — and
            'up_mask' instead of the dense weights. A batch of B frames
            gives each element's logits as B separate calls would (the
            block-local volume takes B = 1).
        corr_shard: optional spatial sharding of the correlation over the
            ``sp`` ranks of a mesh (``parallel/sharding.py:CorrShard``, the
            JAX package's hook of this name): ``corr.make_correlation``
            takes its kinds in place of the pyramid (each rank holds a
            range of key columns, one ``all_reduce`` a lookup) and of the
            block-local volume (each rank holds a range of blocks).
    Returns:
        dict with 'flow' (B,H/8,W/8,2), 'flow_up' (B,H,W,2), 'fmap1' and
        'fmap2' (B,H/8,W/8,D) and 'mean_response' (B,H/8,W/8); under
        'weighted' and 'weighted_masked' either 'weights' (B,H/8,W/8,1) and
        'weights_up' (B,H,W,1), or 'up_mask' (B,H/8,W/8,576) and
        'weight_head_at'; under 'weighted_masked' also the visibility
        logits 'mask_up' (B,H,W,1).
    """
    with layers.precision_scope(cfg.precision):
        return _raft_forward(model, cfg, image1, image2, flow_init, iters,
                             template_feats, sparse_weight_head, corr_shard)


def train_forward(model, cfg: RaftConfig, image1, image2, flow_init=None,
                  iters=None):
    """``weighted_raft_forward`` with autograd on: the training forward.

    The same computation, recorded for a backward pass: the coordinates are
    detached at the top of every refinement iteration (the reference's
    ``coords1.detach()``), so gradients reach the network through each
    iteration's update and through the final lookup and heads only. The
    dense head always runs. The kernels of the path launch inside
    ``torch.autograd.Function``s whose backwards are kernel B' (the dense
    lookup) or the VJPs of the plain versions (C, D, E, as the JAX
    package's ``custom_vjp``s); the fused kernels G, H, I and the pre-warp
    A have no backward and raise when a parameter they read requires grad.

    Precision: the forward runs in ``cfg.precision``; the backward runs
    after its scope has closed, so with the caller's TF32 flags (off after
    ``device.resolve_device``: full float32 products in 'default' mode,
    where the forward's are TF32); 'bf16' keeps its casts in the graph, so
    the backward of a bf16 convolution is bf16 too."""
    with layers.precision_scope(cfg.precision):
        return _raft_forward(model, cfg, image1, image2, flow_init, iters,
                             None, False)


def _raft_forward(model, cfg, image1, image2, flow_init, iters,
                  template_feats, sparse_weight_head, corr_shard=None):
    if cfg.small and sparse_weight_head and cfg.variant == "weighted":
        raise ValueError("the sparse weight head needs the convex-upsampling "
                         "mask, which RAFT-small has not")
    iters = cfg.iters if iters is None else iters
    dev = image2.device
    with span("woft.flow.encode", dev):
        x2 = _nchw(2.0 * (image2 / 255.0) - 1.0)
        B = x2.shape[0]

        if template_feats is not None:
            fmap1, net, inp = (_nchw(t) for t in template_feats)
            fmap2 = model.fnet(x2)
        else:
            x1 = _nchw(2.0 * (image1 / 255.0) - 1.0)
            fmap1, fmap2 = model.fnet(torch.cat([x1, x2])).split(B)
            net, inp = _context(cfg, model.cnet(x1))
        H1, W1 = fmap2.shape[2:]

        f1, f2 = _nhwc(fmap1).contiguous(), _nhwc(fmap2).contiguous()
    corr = make_correlation(cfg, B, corr_shard)
    ub = model.update_block
    route = update.loop_route(cfg, B, ub, net, inp, f1, f2)
    # the volume and the loop as one CUDA graph (loop_graph.py)
    graphed = (corr.graphable and not cfg.small and x2.is_cuda
               and not torch.is_grad_enabled()
               and not torch.cuda.is_current_stream_capturing())
    with span("woft.flow.volume", dev):
        if graphed:             # the volume is built in the loop's graph
            mean_response = corr.mean_response(f1, f2)
        else:
            _, mean_response = corr.build(f1, f2)

    with span("woft.flow.refine", dev):
        coords0 = _nchw(coords_grid(B, H1, W1, x2.device))  # (B, 2, H1, W1)
        coords1 = (coords0 if flow_init is None
                   else coords0 + _nchw(flow_init))

        def refine(net, inp, coords0, coords1):
            ctx = route.context(ub.gru, inp)
            for _ in range(iters):         # no host sync inside this loop
                # the coordinate chain is cut at every iteration (the
                # reference's coords1.detach(); a no-op under no_grad)
                coords1 = coords1.detach()
                net, delta = route.step(
                    ub, net, corr.lookup(_nhwc(coords1).contiguous()),
                    coords1 - coords0, ctx)
                coords1 = coords1 + delta
            # NCHW for the mask head: cuDNN's float32 convolutions run
            # slower on the bf16 route's channels-minor state (a no-op on
            # the other routes)
            return net.contiguous(), coords1

        if graphed:
            def volume_and_refine(f1, f2, net, inp, coords0, coords1):
                return (corr.build_volume(f1, f2),
                        *refine(net, inp, coords0, coords1))

            # everything the graph reads besides its inputs: the
            # configuration, the update block's weights, the route and
            # the precision flags it was captured under
            key = (cfg, iters, route, layers.get_compute_dtype(),
                   torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32,
                   tuple(p.data_ptr() for p in ub.parameters()))
            corr.volume, net, coords1 = loop_graph.run(
                model, key, volume_and_refine, f1, f2, net, inp, coords0,
                coords1)
        else:
            net, coords1 = refine(net, inp, coords0, coords1)

    with span("woft.flow.upsample", dev):
        if cfg.small:           # no mask head: bilinear x8 outputs
            up_mask = None

            def upsample(x):
                return upflow8(_nhwc(x))
        else:
            up_mask = mask_from_net(ub, net)

            def upsample(x):
                return _nhwc(convex_upsample(x, up_mask))
        flow = coords1 - coords0
        out = {"flow": _nhwc(flow), "flow_up": upsample(flow),
               "fmap1": f1, "fmap2": f2, "mean_response": mean_response}
    if cfg.variant == "orig":
        return out

    k = 2 * cfg.radius + 1
    coords1 = _nhwc(coords1).contiguous()
    if sparse_weight_head and cfg.variant == "weighted":
        mr_flat = mean_response.reshape(B * H1 * W1)
        rows = corr.rows_at(coords1)

        @torch.no_grad()
        def weight_head_at(cells):
            M = cells.shape[0]
            with span("woft.weight_head", dev):
                corr_s = rows(cells).reshape(1, 1, M, k, k, cfg.corr_levels)
                with layers.precision_scope(cfg.precision):
                    w = weight_head_apply(model.weight_head, corr_s,
                                          mr_flat[cells].reshape(1, 1, M))
                return w.reshape(M)

        out.update(up_mask=_nhwc(up_mask), weight_head_at=weight_head_at)
        return out

    with span("woft.weight_head", dev):
        corr_final = corr.lookup_natural(coords1)          # (B,H1,W1,L*k*k)
        corr_sample = corr_final.reshape(B, H1, W1, k, k, cfg.corr_levels)
        weights = weight_head_apply(model.weight_head, corr_sample,
                                    mean_response)
        out.update(weights=weights, weights_up=upsample(_nchw(weights)) / 8.0)
    if cfg.variant == "weighted_masked":
        # the current features sampled at the flow's end points (zero
        # outside, align_corners pixel coordinates)
        warped = _nchw(grid_sample(f2, coords1))
        mask = mask_head_apply(model.mask_head, fmap1, warped)
        out["mask_up"] = upsample(mask) / 8.0
    return out
