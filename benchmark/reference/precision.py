"""Operand rounding of the reference's products.

The reference computes in float32 with TF32 off. Its controls put the same
reference in the program's place at the next precision below the one a
configuration states, by rounding both operands of every convolution and
of the correlation's matrix products before a float32 product:

- 'tf32': the 10-bit mantissa of TF32 (round to nearest even), for a
  configuration that states float32 with TF32 off;
- 'fp8': float8 e4m3 with one scale a tensor (its largest magnitude to
  448), or 'int8': symmetric 8-bit integers with one scale a tensor (its
  largest magnitude to 127), for a configuration that states bf16.

Rounding the operands and accumulating in float32 is what the card's
tensor cores do in those formats, so the control is the same on the CPU
and on the card.
"""

import torch

KINDS = ("fp32", "tf32", "fp8", "int8")
E4M3_MAX = 448.0


def round_tf32(x):
    """``x`` (float32) rounded to TF32's 10 mantissa bits, half to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & -0x2000
    return bits.view(torch.float32)


def round_fp8(x):
    """``x`` (float32) through float8 e4m3 with a scale of its own."""
    scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def round_int8(x):
    """``x`` (float32) through symmetric int8 with a scale of its own."""
    scale = x.abs().amax().clamp(min=1e-30) / 127.0
    return torch.round(x / scale).clamp(-127, 127) * scale


def rounder(kind):
    """The operand rounding of ``kind`` ('fp32' leaves operands as they
    are)."""
    if kind == "fp32":
        return lambda t: t
    if kind == "tf32":
        return round_tf32
    if kind == "fp8":
        return round_fp8
    if kind == "int8":
        return round_int8
    raise ValueError(f"precision must be one of {KINDS}, got {kind!r}")
