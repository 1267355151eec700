"""The refinement loop's route, and the fused loop: the update block's
convolution chains as single kernels, their plain PyTorch versions, and the
weight layouts both read.

``loop_route`` decides once a forward how the loop runs its update block
(a ``LoopRoute``, which gives the per-frame context and the step), from
what the forward can observe. Every forward of RAFT-large on one frame
pair that records no gradient through the loop runs fused: in float32
('highest': TF32 off) the SepConvGRU as kernel G's float32 form
(``gru_update_f32``), one launch a direction; in bf16 mode on the card the
motion encoder's 3x3 stack as kernel H, each SepConvGRU direction as
kernel G and the flow head as kernel I. bf16 mode on the CPU keeps the
unfused path, the parity path of the JAX package's, where the flags
``RaftConfig.gru_fused`` and ``tail_fused`` take G and I (as the JAX
package's ``gru_pallas`` and ``tail_pallas`` do); 'default' (TF32
products), a batch of frame pairs and a forward that records a gradient
keep the unfused path; RAFT-small runs its own block (no fused kernel).
Under GMA (``RaftConfig.gma``) the step runs the aggregation
(``models/gma.py``) between the motion encoder and the SepConvGRU: kernel
M on the card's bf16 route, its plain form on every other; G then reads
256 motion channels, and 'highest' keeps the unfused path (G's float32
form reads 128).

PyTorch twin of ``woft_tpu/ops/pallas/gru.py`` (``sep_conv_gru_pallas``) and
``woft_tpu/ops/pallas/update_tail.py`` (``motion_encoder_pallas``,
``flow_head_pallas``). Three functions, one kernel each on the card:

- ``gru_update`` (kernel G): one direction of the SepConvGRU: the z|r
  convolution, the gates, ``r * h``, the q convolution, ``tanh`` and the
  convex blend;
- ``motion_encoder_tail`` (kernel H, two launches through L2: ``convc2``
  and ``convf2``, then ``conv``): the motion encoder's 3x3 stack and the
  final ``cat`` with the flow;
- ``flow_head`` (kernel I): ``conv2(relu(conv1(net)))``;

and, with no TPU twin (the JAX package runs its float32 GRU through XLA),
``gru_update_f32`` (kernel G's float32 form): the direction of G in
float32, products on FFMA, at the unfused path's arithmetic, forward only
and raising under grad as the others do; its maps are float32 and
channels-minor, its taps ``gru_taps_f32``.

The three are bf16-mode functions for one frame pair, and forward only: none
has a backward (nor has its JAX twin), and the taps are detached copies of
the weights, so each raises under grad when an input requires grad
(``kernels.require_no_grad``), as do the model paths that reach them
(``models/raft.py``: ``gru_fused``, ``tail_fused``, the fused motion
encoder) when a parameter of theirs requires grad. Maps are channels-minor,
(1, H, W, C); taps are stacked tap-major with the input channels minor,
(taps, C_out, C_in), which is how a tensor-core product reads them. On a
CUDA tensor each launches its kernel (``ops/kernels.py``); on a CPU tensor it
takes the plain version below, written at the kernel's rounding points,
which are the JAX kernels': bf16 operands, float32 accumulation, the bias
added in float32, one rounding to bf16, the hoisted context added in bf16,
sigmoid and tanh taken in float32 and rounded, ``r * h``, ``1 - z`` and
``z * q`` rounded, the blend summed in float32 against the float32 state;
first-stage activations are zero outside the image before a second
convolution; the flow delta is never rounded. The unfused path
(``layers.conv2d``) rounds a bias to bf16 before a bf16 convolution, so the
two paths agree to bf16 rounding noise, not bit for bit.
"""

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import gma, layers
from .layers import conv2d
from ..ops import kernels

_BF16 = torch.bfloat16


def nhwc(x):
    """(B, C, H, W) -> contiguous channels-minor (B, H, W, C); free when the
    tensor already has that memory layout."""
    return x.permute(0, 2, 3, 1).contiguous()


def require_bf16_mode(what):
    if layers.get_compute_dtype() != _BF16:
        raise ValueError(f"{what} is a bf16-mode path: call it inside "
                         f"layers.precision_scope('bf16')")


def taps(weight):
    """Conv weight (C_out, C_in, kh, kw) -> bf16 (kh * kw, C_out, C_in)."""
    co, ci, kh, kw = weight.shape
    return (weight.detach().permute(2, 3, 0, 1).reshape(kh * kw, co, ci)
            .to(_BF16).contiguous())


def gru_taps(gru, names, hd, ci):
    """The recurrent taps of the convolutions ``names`` of a ``SepConvGRU``
    (the z and r pair, or q): the ``inp`` rows ``[hd, hd + ci)`` dropped,
    the outputs of a pair fused -> ((5, C_out, hd + motion) bf16 taps,
    (C_out,) float32 bias)."""
    ws = [getattr(gru, n).weight for n in names]
    w = torch.cat([torch.cat([w[:, :hd], w[:, hd + ci:]], dim=1) for w in ws])
    b = torch.cat([getattr(gru, n).bias for n in names])
    return taps(w), b.detach().float().contiguous()


def _conv_taps(x, w, kh, kw):
    """Zero-padded (kh x kw) convolution as a sum of per-tap products.

    x: (1, H, W, C_in) bf16 or float32; w: (kh * kw, C_out, C_in) of the
    same type. Returns (1, H, W, C_out) float32: the products (exact in
    float32 for bf16 operands) summed in float32."""
    H, W = x.shape[1:3]
    xp = F.pad(x.float(), (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    wf = w.float()
    acc = None
    for t in range(kh * kw):
        ky, kx = divmod(t, kw)
        part = xp[:, ky:ky + H, kx:kx + W] @ wf[t].T
        acc = part if acc is None else acc + part
    return acc


def gru_update_plain(h, x, pre_zr, pre_q, wzr, wq, bzr, bq, axis):
    """Plain version of kernel G (arguments as ``gru_update``)."""
    kh, kw = (1, 5) if axis == "w" else (5, 1)
    C = h.shape[-1]
    zr = (_conv_taps(torch.cat([h.to(_BF16), x], -1), wzr, kh, kw)
          + bzr).to(_BF16) + pre_zr
    z = torch.sigmoid(zr[..., :C].float()).to(_BF16)
    r = torch.sigmoid(zr[..., C:].float()).to(_BF16)
    rh = (r.float() * h).to(_BF16)
    q = (_conv_taps(torch.cat([rh, x], -1), wq, kh, kw) + bq).to(_BF16) + pre_q
    q = torch.tanh(q.float()).to(_BF16)
    return (1 - z).float() * h + (z * q).float()


def gru_update(h, x, pre_zr, pre_q, wzr, wq, bzr, bq, axis):
    """One direction of the SepConvGRU (``axis`` 'w': 1x5, 'h': 5x1).

    h: (1, H, W, 128) float32 state; x: (1, H, W, X) bf16 motion features,
    X = 128, or 256 under GMA (``cat(mf, mf_g)``); pre_zr (1, H, W, 256),
    pre_q (1, H, W, 128): bf16 context terms; wzr (5, 256, 128 + X), wq (5,
    128, 128 + X): ``gru_taps``; bzr, bq: float32 biases. Returns the new
    float32 state."""
    kernels.require_no_grad("G (fused_gru_update)", h, x, pre_zr, pre_q, wzr,
                            wq, bzr, bq)
    if h.device.type == "cuda":
        return kernels.fused_gru_update(h, x, pre_zr, pre_q, wzr, wq, bzr, bq,
                                        axis)
    return gru_update_plain(h, x, pre_zr, pre_q, wzr, wq, bzr, bq, axis)


def gru_taps_f32(gru, names, hd, ci):
    """Kernel G's float32 form's taps of one ``SepConvGRU`` direction, the
    convolutions ``names`` (z, r, q) with their ``inp`` rows ``[hd, hd +
    ci)`` dropped -> ((3, hd + motion, 5, C_out) float32 taps, input
    channel, tap, output channel: a slice of input channels is one
    contiguous block; (3 * C_out,) float32 biases bz | br | bq)."""
    ws = [getattr(gru, n).weight.detach() for n in names]
    w = torch.stack([torch.cat([v[:, :hd], v[:, hd + ci:]], dim=1)
                     for v in ws])                  # (3, C_out, C_in, kh, kw)
    w = w.flatten(3).permute(0, 2, 3, 1).float().contiguous()
    b = torch.cat([getattr(gru, n).bias.detach() for n in names])
    return w, b.float().contiguous()


def gru_update_f32_plain(h, x, pre_zr, pre_q, w, b, axis):
    """Plain version of kernel G's float32 form (arguments as
    ``gru_update_f32``): the unfused path's arithmetic in float32, each
    convolution summed tap by tap."""
    kh, kw = (1, 5) if axis == "w" else (5, 1)
    C = h.shape[-1]
    wz, wr, wq = (t.permute(1, 2, 0) for t in w)    # (5, C_out, C_in)
    hx = torch.cat([h, x], -1)
    z = torch.sigmoid(_conv_taps(hx, wz, kh, kw) + b[:C] + pre_zr[..., :C])
    r = torch.sigmoid(_conv_taps(hx, wr, kh, kw) + b[C:2 * C]
                      + pre_zr[..., C:])
    q = torch.tanh(_conv_taps(torch.cat([r * h, x], -1), wq, kh, kw)
                   + b[2 * C:] + pre_q)
    return (1 - z) * h + z * q


def gru_update_f32(h, x, pre_zr, pre_q, w, b, axis):
    """One direction of the SepConvGRU in float32 (``axis`` 'w': 1x5, 'h':
    5x1), kernel G's float32 form on a CUDA tensor.

    h, x: (1, H, W, 128) float32 state and motion features; pre_zr (1, H,
    W, 256), pre_q (1, H, W, 128): float32 context terms; w, b:
    ``gru_taps_f32``. Returns the new float32 state."""
    kernels.require_no_grad("G (fused_gru_update_f32)", h, x, pre_zr, pre_q,
                            w, b)
    if h.device.type == "cuda":
        return kernels.fused_gru_update_f32(h, x, pre_zr, pre_q, w, b, axis)
    return gru_update_f32_plain(h, x, pre_zr, pre_q, w, b, axis)


def motion_encoder_stage1_plain(cor1, flo1, wc2, bc2, wf2, bf2):
    """Plain version of kernel H's first launch: ``cat(cor2, flo2)``, the
    (1, H, W, 256) bf16 map of first-stage activations."""
    cor2 = F.relu((_conv_taps(cor1, wc2, 3, 3) + bc2).to(_BF16))
    flo2 = F.relu((_conv_taps(flo1, wf2, 3, 3) + bf2).to(_BF16))
    return torch.cat([cor2, flo2], -1)


def motion_encoder_stage2_plain(mid, flow, wcv, bcv):
    """Plain version of kernel H's second launch: the 256 -> 126
    convolution of the first stage's map, zero outside the image, and
    ``bf16(flow)`` in lanes 126-127."""
    out = F.relu((_conv_taps(mid, wcv, 3, 3) + bcv).to(_BF16))
    return torch.cat([out[..., :-2], flow.to(_BF16)], -1)


def motion_encoder_tail_plain(cor1, flo1, flow, wc2, bc2, wf2, bf2, wcv, bcv):
    """Plain version of kernel H (arguments as ``motion_encoder_tail``)."""
    mid = motion_encoder_stage1_plain(cor1, flo1, wc2, bc2, wf2, bf2)
    return motion_encoder_stage2_plain(mid, flow, wcv, bcv)


def motion_encoder_tail(cor1, flo1, flow, wc2, bc2, wf2, bf2, wcv, bcv):
    """The motion encoder after its first convolutions.

    cor1 (1, H, W, 256), flo1 (1, H, W, 128): bf16 ``relu(convc1(corr))``
    and ``relu(convf1(flow))``; flow (1, H, W, 2) float32; taps and float32
    biases from ``motion_encoder_params``. Returns (1, H, W, 128) bf16,
    ``cat(out126, bf16(flow))``."""
    kernels.require_no_grad("H (motion_encoder_tail)", cor1, flo1, flow, wc2,
                            bc2, wf2, bf2, wcv, bcv)
    if cor1.device.type == "cuda":
        return kernels.motion_encoder_tail(cor1, flo1, flow, wc2, bc2, wf2,
                                           bf2, wcv, bcv)
    return motion_encoder_tail_plain(cor1, flo1, flow, wc2, bc2, wf2, bf2,
                                     wcv, bcv)


def motion_encoder_params(enc):
    """(wc2, bc2, wf2, bf2, wcv, bcv) of a ``BasicMotionEncoder`` for
    ``motion_encoder_tail``; ``conv``'s 126 outputs are padded to 128 with
    zero taps (the kernel's tile is a multiple of 32 channels wide; it
    writes the flow into those two lanes)."""
    def bias(mod, n=0):
        return F.pad(mod.bias.detach().float(), (0, n)).contiguous()

    wcv = F.pad(taps(enc.conv.weight), (0, 0, 0, 2))
    return (taps(enc.convc2.weight), bias(enc.convc2),
            taps(enc.convf2.weight), bias(enc.convf2), wcv, bias(enc.conv, 2))


def flow_head_plain(net, w1, b1, w2, b2):
    """Plain version of kernel I (arguments as ``flow_head``)."""
    hid = F.relu((_conv_taps(net.to(_BF16), w1, 3, 3) + b1).to(_BF16))
    return _conv_taps(hid, w2, 3, 3) + b2


def flow_head(net, w1, b1, w2, b2):
    """``conv2(relu(conv1(net)))``: net (1, H, W, 128) float32 -> (1, H, W,
    2) float32 delta. w1 (9, 256, 128), w2 (9, 2, 256): ``taps``; b1, b2:
    float32 biases."""
    kernels.require_no_grad("I (flow_head)", net, w1, b1, w2, b2)
    if net.device.type == "cuda":
        return kernels.flow_head(net, w1, b1, w2, b2)
    return flow_head_plain(net, w1, b1, w2, b2)


def flow_head_params(head):
    """(w1, b1, w2, b2) of a ``FlowHead`` for ``flow_head``."""
    return (taps(head.conv1.weight),
            head.conv1.bias.detach().float().contiguous(),
            taps(head.conv2.weight),
            head.conv2.bias.detach().float().contiguous())


# ---------------------------------------------------------------------------
# the refinement loop's route
# ---------------------------------------------------------------------------

# a SepConvGRU direction: its z, r and q convolutions and their padding
GRU_DIRS = (("convz1", "convr1", "convq1", (0, 2)),
            ("convz2", "convr2", "convq2", (2, 0)))


@dataclass(frozen=True)
class LoopRoute:
    """How one forward's refinement loop runs its update block
    (``loop_route``). Hashable: ``models/loop_graph.py`` keys a graph on it.

    gru: 'small' (RAFT-small's block: its motion encoder and 3x3 ConvGRU),
        'unfused' (the SepConvGRU's convolutions through ``layers.conv2d``),
        'f32' (kernel G's float32 form, ``gru_update_f32``) or 'bf16'
        (kernel G, ``gru_update``). On a fused route the state is re-laid
        channels-minor for the kernel once a step.
    tail: the flow head as kernel I (``flow_head``).
    encoder: the motion encoder's 3x3 stack and its ``cat`` as kernel H
        (``BasicMotionEncoder.forward(fused=True)``); the card's bf16 route
        only, the JAX package has no caller of its twin.
    gma: GMA's aggregation between the motion encoder and the SepConvGRU
        (``models/gma.py:aggregate``): '' (RAFT: none), 'kernel' (kernel M,
        the card's bf16 route) or 'plain' (every other route); the GRU then
        reads ``cat(mf, mf_g)``, 256 channels.
    """
    gru: str = "unfused"
    tail: bool = False
    encoder: bool = False
    gma: str = ""

    def context(self, gru, inp):
        """This frame's loop-invariant context: ``inp`` itself for 'small';
        for a SepConvGRU ``gru``, per direction, the ``inp`` rows of its
        convolutions convolved once (bias-free: conv([h, inp, m]) =
        conv_hm([h, m]) + conv_inp(inp), exact by linearity) with the
        recurrent weights the step reads.

        'unfused': (zr_pre, q_pre, w_zr, b_zr, w_q, b_q, padding), z and r
        as one convolution, the weights rounded once a frame in bf16 mode;
        'bf16': ``gru_update``'s (pre_zr, pre_q, wzr, wq, bzr, bq, axis),
        the terms channels-minor, the taps ``gru_taps``; 'f32':
        ``gru_update_f32``'s (pre_zr, pre_q, w, b, axis), the taps
        ``gru_taps_f32``."""
        if self.gru == "small":
            return inp
        if self.gru == "bf16":
            kernels.require_no_grad("G (fused_gru_update)",
                                    *gru.parameters())
            require_bf16_mode("the fused SepConvGRU")
        sd = layers.get_compute_dtype()
        if self.gru == "f32" and sd is not None:
            raise ValueError("kernel G's float32 form is a float32-mode "
                             "path")
        hd, ci = gru.convz1.out_channels, inp.shape[1]

        def cast(t):        # bf16 mode: round the derived weights once a frame
            return t if sd is None else t.to(sd)

        def hm(w):          # the recurrent rows: h and the motion features
            return torch.cat([w[:, :hd], w[:, hd + ci:]], dim=1)

        out = []
        for kz, kr, kq, pad in GRU_DIRS:
            wz, wr, wq = (getattr(gru, n).weight for n in (kz, kr, kq))
            zr_pre = conv2d(inp, cast(torch.cat([wz[:, hd:hd + ci],
                                                 wr[:, hd:hd + ci]])),
                            padding=pad, out_dtype=sd)
            q_pre = conv2d(inp, cast(wq[:, hd:hd + ci]), padding=pad,
                           out_dtype=sd)
            axis = "w" if pad == (0, 2) else "h"
            if self.gru == "bf16":
                w_zr, b_zr = gru_taps(gru, (kz, kr), hd, ci)
                w_q, b_q = gru_taps(gru, (kq,), hd, ci)
                out.append((nhwc(zr_pre), nhwc(q_pre), w_zr, w_q, b_zr, b_q,
                            axis))
            elif self.gru == "f32":
                w, b = gru_taps_f32(gru, (kz, kr, kq), hd, ci)
                out.append((nhwc(zr_pre), nhwc(q_pre), w, b, axis))
            else:
                bz, br, bq = (getattr(gru, n).bias for n in (kz, kr, kq))
                out.append((zr_pre, q_pre, cast(torch.cat([hm(wz), hm(wr)])),
                            cast(torch.cat([bz, br])), cast(hm(wq)),
                            cast(bq), pad))
        return out

    def sep_conv_gru(self, h, x, ctx):
        """One SepConvGRU update of the (B, C, H, W) state ``h`` by the
        motion features ``x`` with the context ``ctx`` (``context``; a
        slice of its directions runs those only). In bf16 mode the gates
        are bf16 and the state stays float32: ``r * h`` and the convex
        blend are taken at the state's precision.

        On a fused route each direction is one launch. bf16 G's state is
        handed back channels-minor in memory under its (B, C, H, W) shape,
        which costs no copy; the float32 form copies it back to NCHW, since
        cuDNN's float32 flow and mask heads ran slower on a channels-last
        map (49.87 against 49.64 ms a 720p frame of ``WOFT.py``, in turns
        in one process)."""
        if self.gru != "unfused":
            step = gru_update_f32 if self.gru == "f32" else gru_update
            h, x = nhwc(h), nhwc(x)
            for args in ctx:
                h = step(h, x, *args)
            h = h.permute(0, 3, 1, 2)
            return h.contiguous() if self.gru == "f32" else h
        sd = layers.get_compute_dtype()
        for zr_pre, q_pre, w_zr, b_zr, w_q, b_q, pad in ctx:
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

    def step(self, block, net, corr, flow, ctx, attn=None):
        """One refinement step of the update block ``block`` -> (net, delta
        flow). ``corr``: the loop's lookup (``Correlation.lookup``); ``ctx``:
        ``context(block.gru, inp)``; ``attn``: GMA's attention (B, N, N)
        under ``gma``. The convex-upsample mask is not computed here
        (``raft.mask_from_net``: only the last iteration's mask is
        consumed)."""
        if self.gru == "small":
            motion = block.encoder(flow, corr)
            net = block.gru(net, torch.cat([ctx.to(motion.dtype), motion],
                                           dim=1))
            return net, block.flow_head(net)
        motion = block.encoder(flow, corr, fused=self.encoder)
        if self.gma:
            motion = gma.aggregate(block.aggregator, attn, motion,
                                   self.gma == "kernel")
        net = self.sep_conv_gru(net, motion, ctx)
        return net, block.flow_head(net, fused=self.tail)


def _on_card(*tensors):
    return all(t.is_cuda for t in tensors)


def loop_route(cfg, batch, block, *tensors):
    """The ``LoopRoute`` of a forward of ``batch`` frame pairs under the
    ``RaftConfig`` ``cfg``, from what it can observe (``tensors``: the
    loop's inputs; with ``block``'s parameters, what it reads): 'small' for
    RAFT-small; 'unfused' for a batch. On one frame pair that records no
    gradient through the loop: in bf16 mode on the card, kernels G, H and
    I; in 'highest', 'f32'. Otherwise ('default': TF32 products; a forward
    that trains the network; bf16 on the CPU) 'unfused', except that bf16
    mode off the card takes 'bf16' under ``cfg.gru_fused`` and the flow
    head as I under ``cfg.tail_fused``. Under ``cfg.gma`` the aggregation
    runs as kernel M on the card's bf16 route and in its plain form on
    every other, and 'highest' takes 'unfused' (kernel G's float32 form
    reads 128 motion channels, GMA's GRU 256)."""
    if cfg.small:
        return LoopRoute("small")
    plain = "plain" if cfg.gma else ""
    if batch != 1:
        return LoopRoute("unfused", gma=plain)
    frozen = not (torch.is_grad_enabled() and any(
        t.requires_grad for t in (*tensors, *block.parameters())))
    if layers.get_compute_dtype() == torch.bfloat16:
        if frozen and _on_card(*tensors):
            return LoopRoute("bf16", tail=True, encoder=True,
                             gma="kernel" if cfg.gma else "")
        return LoopRoute("bf16" if cfg.gru_fused else "unfused",
                         cfg.tail_fused, gma=plain)
    if cfg.precision != "highest" or not frozen or cfg.gma:
        return LoopRoute("unfused", gma=plain)
    return LoopRoute("f32")
