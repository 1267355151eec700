"""RAFT (large and small) and WeightedRAFT in PyTorch.

PyTorch twin of ``woft_tpu/models/raft.py``. The networks are
``nn.Module``s whose parameter names follow the reference checkpoints
(``fnet``, ``cnet``, ``update_block``, and by ``RaftConfig.variant``
``weight_head`` and ``mask_head``); the forward pass is a plain function
over the module, as in the JAX package. Variants: 'weighted' (flow and
reliability weights), 'orig' (RAFT: flow only) and 'weighted_masked'
(weights and a visibility mask from ``mask_head`` over the template
features and the current features sampled at the flow's end points).

- the template's features are encoded once per sequence
  (``encode_template``); per frame only the current frame is encoded,
- ``corr_impl='dense'``: the correlation pyramid is built from pooled
  features (``models/corr.py:corr_pyramid_fused``) and looked up 12x per
  flow by kernel B; ``alternate_corr``: no pyramid, each lookup computed
  from the features (``corr_lookup_alternate``, plain PyTorch, as the
  reference's is XLA); ``corr_impl='local'`` (one frame pair): the block-local
  volume is built by kernel C and looked up by kernels D and E in blocked
  form, which the motion encoder's 1x1 ``convc1`` consumes directly
  (``_corr_conv1``),
- the loop-invariant context (``inp``) contribution to the SepConvGRU convs
  is computed once per frame (``precompute_gru_context``; exact by conv
  linearity), and the convex-upsample mask is computed after the loop from
  the final hidden state (``mask_from_net``),
- ``sparse_weight_head=True`` defers the weight head to a closure
  ``weight_head_at(cells)`` that evaluates the same logits at M cells only,
  reading their pyramid rows in place.
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

The SepConvGRU's route by precision (``_gru_route``): in 'highest' every
forward of RAFT-large on one frame pair that records no gradient through
the update block runs each direction as one launch of kernel G's float32
form (``models/update.py:gru_update_f32``: float32 FFMA, the unfused
path's arithmetic in another summation order), with no flag; in 'bf16'
``gru_fused`` / ``tail_fused`` (one frame pair) run the SepConvGRU and the
flow head as one launch each of kernels G and I; 'default' (the TF32
control), RAFT-small, a batch of pairs and a forward that trains the
network keep the unfused path. On a fused route the GRU state lives
channels-minor across the loop.
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
from .corr import (BlockedCorr, build_local_corr, corr_lookup,
                   corr_lookup_alternate, corr_lookup_local_blocked,
                   corr_mean_response, corr_pyramid_fused)
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
        package's ``gru_pallas``. In effect only in bf16 mode and for one
        frame pair; otherwise the precision's route runs (float32:
        kernel G's float32 form, without this flag; 'default' and the
        other cases: the unfused path).
    tail_fused: the flow head as one fused kernel (I) in the loop; the
        counterpart of ``tail_pallas``, with the same gating. As there, the
        motion encoder stays unfused on the forward path (kernel H is
        reached through ``BasicMotionEncoder.forward(fused=True)``).
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
        x = F.relu(self.norm1(conv(self.conv1, x, layers.get_compute_dtype())))
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
        cor = _corr_conv1(self.convc1, corr)
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
        cor = _corr_conv1(self.convc1, corr)
        flo = F.relu(conv(self.convf1, flow, sd))
        flo = F.relu(conv(self.convf2, flo, sd))
        out = F.relu(conv(self.conv, torch.cat([cor, flo], dim=1), sd))
        return torch.cat([out, flow.to(out.dtype)], dim=1)


def _corr_conv1(convc1, corr):
    """relu(convc1(corr)) for a natural (B, L*k*k, H1, W1) lookup or a
    ``BlockedCorr``.

    convc1 is 1x1 and the only consumer of the raw lookup channels, so for
    a blocked lookup (NB, L*k*k, BQ), channels in (level, j, i) order, both
    the relayout and the (j, i) -> (i, j) swap fold into one matmul: the
    weight's input channels are permuted (exact: every output channel is
    its own sum) and only the 256-channel result is laid out spatially."""
    sd = layers.get_compute_dtype()
    if not isinstance(corr, BlockedCorr):
        # 'default' mode: a bf16 lookup enters a float32 convolution
        return F.relu(conv(convc1, corr if sd else corr.float()))
    L, k = corr.levels, corr.k
    co = convc1.weight.shape[0]
    wv = (convc1.weight.reshape(co, L, k, k).permute(0, 1, 3, 2)  # (l, i, j)
          .reshape(co, L * k * k))                               # -> (l, j, i)
    data, bias = corr.data, convc1.bias
    if sd is not None:
        data, wv, bias = data.to(sd), wv.to(sd), bias.to(sd)
    else:
        data = data.float()
    nb, C, bq = data.shape
    out = torch.baddbmm(bias.reshape(1, co, 1), wv.expand(nb, co, C), data)
    meta = corr.meta
    out = out.reshape(meta["nbh"], meta["nbw"], co, meta["bh"], meta["bw"])
    out = out.permute(2, 0, 3, 1, 4).reshape(
        co, meta["nbh"] * meta["bh"], meta["nbw"] * meta["bw"])
    return F.relu(out[None, :, :meta["H1"], :meta["W1"]])


_GRU_DIRS = (("convz1", "convr1", "convq1", (0, 2)),
             ("convz2", "convr2", "convq2", (2, 0)))


class SepConvGRU(nn.Module):
    """1x5 then 5x1 gated updates. Each conv reads [h, inp, motion]."""

    def __init__(self, hidden_dim=128, input_dim=256):
        super().__init__()
        c = hidden_dim + input_dim
        for names, ksize in ((_GRU_DIRS[0][:3], (1, 5)),
                             (_GRU_DIRS[1][:3], (5, 1))):
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
        stays float32, as in ``_sep_conv_gru``."""
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


def _gru_context(gru, inp, hd, names, pad, cast, sd):
    """(zr_pre, q_pre): the ``inp`` rows of one direction's convolutions
    ``names`` (z, r, q) convolved with ``inp`` (bias-free), z and r as one
    convolution."""
    ci = inp.shape[1]
    wz, wr, wq = (getattr(gru, n).weight[:, hd:hd + ci] for n in names)
    return (conv2d(inp, cast(torch.cat([wz, wr])), padding=pad,
                   out_dtype=sd),
            conv2d(inp, cast(wq), padding=pad, out_dtype=sd))


def precompute_gru_context(gru, inp, hd, fused=False):
    """Per-frame loop-invariant context terms of the SepConvGRU.

    A convolution is linear in its input channels, so conv([h, inp, m]) =
    conv_hm([h, m]) + conv_inp(inp): the ``inp`` rows are convolved once per
    frame here (bias-free). Returns, per direction, (zr_pre, q_pre, w_zr,
    b_zr, w_q, b_q, padding) — the context terms plus the recurrent
    weights with the ``inp`` rows dropped and z, r fused into one conv.

    ``fused`` (bf16 mode): the arguments of ``update.gru_update`` instead,
    per direction (pre_zr, pre_q, wzr, wq, bzr, bq, axis): the same context
    terms laid out channels-minor, the taps stacked tap-major (5, C_out,
    256) and the biases in float32, all prepared here once per forward."""
    if fused:
        kernels.require_no_grad("G (fused_gru_update)", *gru.parameters())
        update.require_bf16_mode("the fused SepConvGRU")
    ci = inp.shape[1]
    sd = layers.get_compute_dtype()
    out = []

    def cast(t):        # bf16 mode: round the derived weights once a frame
        return t if sd is None else t.to(sd)

    for kz, kr, kq, pad in _GRU_DIRS:
        wz, wr, wq = (getattr(gru, n).weight for n in (kz, kr, kq))
        bz, br, bq = (getattr(gru, n).bias for n in (kz, kr, kq))

        def hm(w):
            return torch.cat([w[:, :hd], w[:, hd + ci:]], dim=1)

        zr_pre, q_pre = _gru_context(gru, inp, hd, (kz, kr, kq), pad, cast,
                                     sd)
        if fused:
            w_zr, b_zr = update.gru_taps(gru, (kz, kr), hd, ci)
            w_q, b_q = update.gru_taps(gru, (kq,), hd, ci)
            out.append((update.nhwc(zr_pre), update.nhwc(q_pre), w_zr, w_q,
                        b_zr, b_q, "w" if pad == (0, 2) else "h"))
            continue
        out.append((zr_pre, q_pre, cast(torch.cat([hm(wz), hm(wr)])),
                    cast(torch.cat([bz, br])), cast(hm(wq)), cast(bq), pad))
    return out


def precompute_gru_context_f32(gru, inp, hd):
    """``precompute_gru_context`` for kernel G's float32 form (float32
    mode): per direction the arguments of ``update.gru_update_f32``,
    (pre_zr, pre_q, w, b, axis): the same context terms laid out
    channels-minor, the taps ``update.gru_taps_f32`` and the axis, all
    prepared here once per forward."""
    if layers.get_compute_dtype() is not None:
        raise ValueError("kernel G's float32 form is a float32-mode path")
    ci = inp.shape[1]
    out = []
    for kz, kr, kq, pad in _GRU_DIRS:
        zr_pre, q_pre = _gru_context(gru, inp, hd, (kz, kr, kq), pad,
                                     lambda t: t, None)
        w, b = update.gru_taps_f32(gru, (kz, kr, kq), hd, ci)
        out.append((update.nhwc(zr_pre), update.nhwc(q_pre), w, b,
                    "w" if pad == (0, 2) else "h"))
    return out


def _gru_route(cfg, B, ub, *tensors):
    """How the refinement loop runs its SepConvGRU, from what the forward
    can observe: 'f32' (kernel G's float32 form) in float32 mode ('highest':
    TF32 off) for RAFT-large on one frame pair when nothing it reads
    records a gradient (``tensors``: the loop's inputs; and the update
    block's parameters); True (the bf16 kernel G) under the opt-in
    ``gru_fused`` in bf16 mode, one frame pair; False (the unfused path)
    otherwise: 'default' (TF32 products), RAFT-small, a batch, a forward
    that trains the network."""
    if B != 1 or cfg.small:
        return False
    if layers.get_compute_dtype() == torch.bfloat16:
        return cfg.gru_fused
    if cfg.precision != "highest":
        return False
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (*tensors, *ub.parameters())):
        return False
    return "f32"


def _sep_conv_gru(h, x, pre, fused=False):
    """One SepConvGRU update of hidden state ``h`` by motion features ``x``
    with the hoisted context ``pre`` (``precompute_gru_context``). In bf16
    mode the gates are bf16 and the state ``h`` stays float32: ``r * h``
    and the convex blend are taken at the state's precision.

    ``fused``: one kernel launch a direction, ``update.gru_update`` (True,
    ``pre`` made with ``fused=True``: bf16 G) or ``update.gru_update_f32``
    ('f32', ``pre`` from ``precompute_gru_context_f32``); ``h`` and ``x``
    are re-laid channels-minor once per call. bf16 G's state is handed back
    channels-minor in memory under its (B, C, H, W) shape, which costs no
    copy; the float32 route copies it back to NCHW, since cuDNN's float32
    flow and mask heads ran slower on a channels-last map (49.87 against
    49.64 ms a 720p frame of ``WOFT.py``, in turns in one process)."""
    if fused:
        step = update.gru_update_f32 if fused == "f32" else update.gru_update
        h, x = update.nhwc(h), update.nhwc(x)
        for args in pre:
            h = step(h, x, *args)
        return _nchw(h).contiguous() if fused == "f32" else _nchw(h)
    sd = layers.get_compute_dtype()
    for zr_pre, q_pre, w_zr, b_zr, w_q, b_q, pad in pre:
        zr = conv2d(torch.cat([h.to(x.dtype), x], dim=1), w_zr, b_zr,
                    padding=pad, out_dtype=sd)
        zr = zr + zr_pre
        C = h.shape[1]
        z = torch.sigmoid(zr[:, :C])
        r = torch.sigmoid(zr[:, C:])
        q = conv2d(torch.cat([(r * h).to(x.dtype), x], dim=1), w_q, b_q,
                   padding=pad, out_dtype=sd)
        q = torch.tanh(q + q_pre)
        h = (1 - z) * h + z * q
    return h


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


def small_update_apply(block, net, inp, corr, flow):
    """One RAFT-small refinement step -> (net, delta_flow)."""
    motion = block.encoder(flow, corr)
    net = block.gru(net, torch.cat([inp.to(motion.dtype), motion], dim=1))
    return net, block.flow_head(net)


def update_block_apply(block, net, corr, flow, pre, gru_fused=False,
                       tail_fused=False):
    """One refinement step -> (net, delta_flow). ``corr``: (B, L*k*k, H1,
    W1) lookup or a ``BlockedCorr``; ``pre``: this frame's context terms
    for the SepConvGRU's route ``gru_fused`` (``_gru_route``: False, True
    or 'f32'; ``_sep_conv_gru``). The
    convex-upsample mask is not computed here (``mask_from_net``: only the
    last iteration's mask is consumed). The motion encoder stays unfused
    under ``tail_fused``, as in the JAX package."""
    motion = block.encoder(flow, corr, fused=False)
    net = _sep_conv_gru(net, motion, pre, fused=gru_fused)
    return net, block.flow_head(net, fused=tail_fused)


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
            ``sp`` ranks of a mesh (``parallel/sharding.py``, the JAX
            package's hook of this name): its ``pyramid`` and ``lookup``
            replace ``corr_pyramid_fused`` and ``corr_lookup`` (each rank
            holds a range of key columns, one ``all_reduce`` a lookup), its
            ``local`` and ``lookup_local`` replace ``build_local_corr`` and
            the block-local lookup (each rank holds a range of blocks).
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
    radius = cfg.radius
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
    # the block-local volume and the loop as one CUDA graph (loop_graph.py)
    graphed = (cfg.corr_impl == "local" and B == 1 and corr_shard is None
               and not cfg.alternate_corr and not cfg.small
               and x2.is_cuda and not torch.is_grad_enabled()
               and not torch.cuda.is_current_stream_capturing())
    with span("woft.flow.volume", dev):
        local = None
        if cfg.alternate_corr:
            # no stored volume: each lookup from the features, chunked
            mean_response = corr_mean_response(f1, f2)
            chunk = min(cfg.alt_chunk, B * H1 * W1)

            def lookup_natural(coords):
                return corr_lookup_alternate(f1, f2, coords, radius,
                                             cfg.corr_levels, chunk=chunk)

            def lookup(coords):
                return _nchw(lookup_natural(coords))
        elif cfg.corr_impl == "local" and B == 1:
            # exact within +-local_margin cells of residual flow, saturated
            # beyond; 'bf16' and 'default' store the volume (and the lookups)
            # in bf16
            if corr_shard is None:
                def volume(f1, f2):
                    return build_local_corr(
                        f1, f2, radius, cfg.corr_levels,
                        margin=cfg.local_margin, out_dtype=cfg.volume_dtype)

                if not graphed:     # else built in the loop's graph
                    local = volume(f1, f2)
                lookup_blocked = corr_lookup_local_blocked
            else:           # this rank's band of blocks
                local = corr_shard.local(f1, f2, radius, cfg.corr_levels,
                                         cfg.local_margin, cfg.volume_dtype)
                lookup_blocked = corr_shard.lookup_local
            mean_response = corr_mean_response(f1, f2)

            def lookup(coords):        # blocked: convc1 absorbs the layout
                return lookup_blocked(local, coords, radius,
                                      check=cfg.fine_check)

            def lookup_natural(coords):
                return lookup_blocked(local, coords, radius).to_natural()
        else:
            if corr_shard is None:
                pyramid, mean_response = corr_pyramid_fused(
                    f1, f2, cfg.corr_levels, out_dtype=cfg.volume_dtype)
                lookup_rows = corr_lookup
            else:           # this rank's key columns of each level
                pyramid, mean_response = corr_shard.pyramid(
                    f1, f2, cfg.corr_levels, out_dtype=cfg.volume_dtype)
                lookup_rows = corr_shard.lookup

            def lookup(coords):
                return _nchw(lookup_rows(pyramid, coords, radius))

            def lookup_natural(coords):
                return lookup_rows(pyramid, coords, radius)

    ub = model.update_block
    with span("woft.flow.refine", dev):
        coords0 = _nchw(coords_grid(B, H1, W1, x2.device))  # (B, 2, H1, W1)
        coords1 = (coords0 if flow_init is None
                   else coords0 + _nchw(flow_init))
        # kernel I is a bf16-mode kernel for one frame pair; the GRU's
        # route by _gru_route
        tail_fused = (cfg.tail_fused and B == 1 and not cfg.small
                      and layers.get_compute_dtype() == torch.bfloat16)
        gru_fused = _gru_route(cfg, B, ub, net, inp, f1, f2)

        def refine(lookup, net, inp, coords0, coords1):
            if cfg.small:
                pre = None
            elif gru_fused == "f32":
                pre = precompute_gru_context_f32(ub.gru, inp, cfg.hidden_dim)
            else:
                pre = precompute_gru_context(ub.gru, inp, cfg.hidden_dim,
                                             fused=gru_fused)
            for _ in range(iters):         # no host sync inside this loop
                # the coordinate chain is cut at every iteration (the
                # reference's coords1.detach(); a no-op under no_grad)
                coords1 = coords1.detach()
                corr = lookup(_nhwc(coords1).contiguous())
                if cfg.small:
                    net, delta = small_update_apply(ub, net, inp, corr,
                                                    coords1 - coords0)
                else:
                    net, delta = update_block_apply(ub, net, corr,
                                                    coords1 - coords0, pre,
                                                    gru_fused, tail_fused)
                coords1 = coords1 + delta
            return net, coords1

        if graphed:
            def volume_and_refine(f1, f2, net, inp, coords0, coords1):
                nonlocal local          # what ``lookup`` reads
                local = volume(f1, f2)
                return (local, *refine(lookup, net, inp, coords0, coords1))

            # everything the graph reads besides its inputs: the
            # configuration, the update block's weights, the routes and
            # the precision flags it was captured under
            key = (cfg, iters, gru_fused, tail_fused,
                   layers.get_compute_dtype(),
                   torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32,
                   tuple(p.data_ptr() for p in ub.parameters()))
            local, net, coords1 = loop_graph.run(
                model, key, volume_and_refine, f1, f2, net, inp, coords0,
                coords1)
        else:
            net, coords1 = refine(lookup, net, inp, coords0, coords1)

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

    k = 2 * radius + 1
    coords1 = _nhwc(coords1).contiguous()
    if sparse_weight_head and cfg.variant == "weighted":
        # pyramid row b*H1*W1 + cell holds batch element b's cell
        coords1_flat = coords1.reshape(B * H1 * W1, 2)
        mr_flat = mean_response.reshape(B * H1 * W1)
        if local is not None:
            # queries are minor in the block-local volume, so per-cell reads
            # would be strided: one more dense lookup at the final
            # coordinates, then a row select
            with span("woft.weight_head", dev):
                corr_dense_flat = lookup_natural(coords1).reshape(H1 * W1, -1)

        @torch.no_grad()
        def weight_head_at(cells):
            M = cells.shape[0]
            with span("woft.weight_head", dev):
                if local is not None:
                    corr_f = corr_dense_flat[cells]
                elif cfg.alternate_corr:
                    corr_f = corr_lookup_alternate(
                        f1.reshape(B * H1 * W1, -1)[cells][None, None], f2,
                        coords1_flat[cells][None, None], radius,
                        cfg.corr_levels, chunk=min(cfg.alt_chunk, M),
                        batch=cells // (H1 * W1))
                else:
                    corr_f = lookup_rows(
                        pyramid, coords1_flat[cells][None, None], radius,
                        rows=cells)                     # (1, 1, M, L*k*k)
                corr_s = corr_f.reshape(1, 1, M, k, k, cfg.corr_levels)
                with layers.precision_scope(cfg.precision):
                    w = weight_head_apply(model.weight_head, corr_s,
                                          mr_flat[cells].reshape(1, 1, M))
                return w.reshape(M)

        out.update(up_mask=_nhwc(up_mask), weight_head_at=weight_head_at)
        return out

    with span("woft.weight_head", dev):
        corr_final = lookup_natural(coords1)                # (B,H1,W1,L*k*k)
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
