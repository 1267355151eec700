"""Network building blocks (NCHW) and their seeded initialisation.

PyTorch twin of ``woft_tpu/models/layers.py``. Module and parameter names
follow the reference checkpoints, so a state dict's keys read like the JAX
parameter tree's paths (``fnet.layer1.0.conv1.weight``). Norm semantics:

- instance norm: ``nn.InstanceNorm2d`` (affine=False), per-sample
  spatial statistics;
- eval batch norm: always the running statistics and the affine;
- group norm: ``nn.GroupNorm`` (affine).

Precision: ``precision_scope('bf16')`` switches the convolutions below to
the reference's bf16 mode for the duration of one forward pass, with the
casts written out where the reference has them: inputs and weights rounded
to bf16, float32 accumulation, the result stored in bf16 where the caller
asks for it (``out_dtype``) and in float32 otherwise. Norm statistics are
float32 and the result goes back to the input's type. ``torch.autocast``
is not used: it rounds elsewhere and would reach the geometry.
``precision_scope('default')`` keeps float32 activations and lets the
card's float32 convolutions and matmuls use TF32 for the scope only (the
reference's lax ``DEFAULT`` on a GPU): the previous flags come back when it
ends, so the geometry outside a forward never runs in TF32
(``device.resolve_device`` turns TF32 off). ``full_float32()`` turns it off
again inside a forward, where the reference asks for ``HIGHEST``.

Initialisation mirrors the JAX package's distributions, drawn from an
explicit ``torch.Generator``.
"""

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F


PRECISIONS = ("highest", "default", "bf16")
_COMPUTE_DTYPE = None      # torch.bfloat16 inside a bf16 precision_scope
_ROUNDED = {}              # per-scope cache: (id(parameter), dtype) -> its
#                            rounded copy; once_per_pass keys


@contextlib.contextmanager
def _tf32(allow):
    """TF32 for float32 matmuls and cuDNN convolutions set to ``allow`` for
    the enclosed code, the previous flags restored after it."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def full_float32():
    """No TF32 inside a 'default' scope (the reference's ``HIGHEST``
    products: the mean response)."""
    return _tf32(False)


@contextlib.contextmanager
def precision_scope(precision):
    """Run the enclosed forward pass in ``precision`` ('highest': float32
    throughout; 'default': float32 activations, TF32 products on the card;
    'bf16': see the module docstring). Parameters rounded to bf16 are cached
    for the scope, so each is cast once per pass; under grad a parameter
    that requires grad is cast in the graph instead, at every use.

    The TF32 flags are process-global and restored when the scope ends, so
    a backward pass that autograd runs after the forward's scope has closed
    runs with the caller's flags (off after ``device.resolve_device``):
    full float32 products on the card."""
    global _COMPUTE_DTYPE, _ROUNDED
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    prev = (_COMPUTE_DTYPE, _ROUNDED)
    _COMPUTE_DTYPE = torch.bfloat16 if precision == "bf16" else None
    _ROUNDED = {}
    tf32 = _tf32(True) if precision == "default" else contextlib.nullcontext()
    try:
        with tf32:
            yield
    finally:
        _COMPUTE_DTYPE, _ROUNDED = prev


@contextlib.contextmanager
def fresh_pass():
    """A new pass inside the current precision scope: the weights rounded
    and the layouts made once a pass (``once_per_pass``) are made anew by
    the enclosed code, and the outer pass's come back after it (a CUDA
    graph's capture makes its own, on the graph's memory)."""
    global _ROUNDED
    prev = _ROUNDED
    _ROUNDED = {}
    try:
        yield
    finally:
        _ROUNDED = prev


def get_compute_dtype():
    """torch.bfloat16 in bf16 mode, else None."""
    return _COMPUTE_DTYPE


def _rounded(t, widen=False):
    """``t`` rounded to the compute dtype (``widen``: and back to float32,
    for a convolution whose result stays float32)."""
    if t is None:
        return None
    dtype = torch.float32 if widen else _COMPUTE_DTYPE
    if not isinstance(t, nn.Parameter) or (torch.is_grad_enabled()
                                           and t.requires_grad):
        # a parameter being trained is cast in the graph, at every use: a
        # cached cast would be detached from it
        return t.to(_COMPUTE_DTYPE).to(dtype)
    key = (id(t), dtype)
    if key not in _ROUNDED:
        _ROUNDED[key] = t.detach().to(_COMPUTE_DTYPE).to(dtype)
    return _ROUNDED[key]


def once_per_pass(key, make):
    """``make()``, evaluated once per precision scope and kept under ``key``
    until the scope ends (derived weight layouts of the fused kernels)."""
    if key not in _ROUNDED:
        _ROUNDED[key] = make()
    return _ROUNDED[key]


def conv2d(x, weight, bias=None, stride=1, padding=0, out_dtype=None):
    """Convolution under the current precision scope.

    float32 mode: ``F.conv2d``. bf16 mode: input and weight are rounded to
    bf16 and accumulated in float32. ``out_dtype=torch.bfloat16`` stores
    the result in bf16 (one bf16 convolution; the bias is rounded to bf16
    first, where the reference adds it in float32: below one bf16 ulp of
    the result). Otherwise the result stays float32, as the reference's
    does: the rounded operands are widened again and convolved in float32,
    which is the same sum, since products of bf16 values are exact there."""
    if _COMPUTE_DTYPE is None:
        return F.conv2d(x, weight, bias, stride, padding)
    if out_dtype == _COMPUTE_DTYPE:
        return F.conv2d(x.to(_COMPUTE_DTYPE), _rounded(weight),
                        _rounded(bias), stride, padding)
    return F.conv2d(x.to(_COMPUTE_DTYPE).to(torch.float32),
                    _rounded(weight, widen=True), bias, stride, padding)


def conv_bias(bias, out_dtype=None):
    """The bias ``conv2d`` adds to a result stored as ``out_dtype`` under
    the current precision scope: rounded to bf16 where the result is."""
    if _COMPUTE_DTYPE is not None and out_dtype == _COMPUTE_DTYPE:
        return _rounded(bias)
    return bias


def conv(mod, x, out_dtype=None):
    """``conv2d`` with an ``nn.Conv2d``'s parameters and geometry."""
    return conv2d(x, mod.weight, mod.bias, mod.stride, mod.padding, out_dtype)


class EvalBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that always normalises with its running statistics, in
    ``train()`` mode too: the JAX package's ``batch_norm_eval``, which its
    trainer also runs (the running statistics are never updated)."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def norm_layer(norm_fn, channels, num_groups):
    """The reference's norm_fn strings -> a norm module."""
    if norm_fn == "instance":
        return nn.InstanceNorm2d(channels)
    if norm_fn == "batch":
        return EvalBatchNorm2d(channels)
    if norm_fn == "group":
        return nn.GroupNorm(num_groups, channels)
    if norm_fn == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm_fn {norm_fn}")


@torch.no_grad()
def init_conv_(conv, generator, kaiming_out=False):
    """Seeded conv init. ``kaiming_out``: kaiming-normal fan_out/relu (the
    encoders' first conv); otherwise torch's default Conv2d init (kaiming
    uniform with a = sqrt(5), uniform bias)."""
    cout, cin, kh, kw = conv.weight.shape
    fan_in = kh * kw * cin
    if kaiming_out:
        std = math.sqrt(2.0 / (kh * kw * cout))
        w = torch.randn(conv.weight.shape, generator=generator) * std
    else:
        bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)
        w = (torch.rand(conv.weight.shape, generator=generator) * 2 - 1) * bound
    conv.weight.copy_(w)
    if conv.bias is not None:
        bound = 1.0 / math.sqrt(fan_in)
        conv.bias.copy_((torch.rand(conv.bias.shape, generator=generator)
                         * 2 - 1) * bound)
