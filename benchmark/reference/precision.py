"""The arithmetic a configuration states, worked out on float32 values.

``Precision`` names it: ``weight_bits`` quantizes the matmul weights
that the configuration lists as quantized (symmetric, one scale per
output column over every input and tap); ``act_bits`` quantizes the
activations of the products the configuration lists as int8 x int8
(symmetric, one scale per row); ``tf32`` lets cuBLAS and cuDNN round
float32 operands to TF32; ``vocoder`` names the type both operands of
every vocoder product are rounded to (``bf16``; ``fp8``, e4m3 on a scale
per tensor). Every product then runs in float32 on the dequantized or
rounded values, which is the same function as an integer or bf16
product with its scales applied after the sum.

The reference of the int8 plane is ``Precision(8, 8, vocoder="bf16")``;
of the f32 plane ``Precision()``. The controls sit one step below: int4
weights and an fp8 vocoder for the int8 plane, TF32 for the f32 plane.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    weight_bits: Optional[int] = None
    act_bits: Optional[int] = None
    tf32: bool = False
    vocoder: Optional[str] = None


def _levels(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def quantize_weight(w: torch.Tensor, bits: Optional[int],
                    in_dims: tuple) -> torch.Tensor:
    """``w`` rounded to ``bits``-bit integers on a scale per output
    channel, the absmax over ``in_dims``, and scaled back (float32).
    ``bits=None`` returns ``w`` as float32."""
    wf = w.float()
    if bits is None:
        return wf
    q = _levels(bits)
    absmax = wf.abs().amax(dim=in_dims, keepdim=True)
    scale = absmax.clamp_min(1e-12) / torch.full_like(absmax, q)
    return torch.clamp(torch.round(wf / scale), -q, q) * scale


def quantize_rows(x: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    """``x`` rounded to ``bits``-bit integers on a scale per row (the last
    axis), scaled back. ``bits=None`` returns ``x``."""
    if bits is None:
        return x
    q = _levels(bits)
    absmax = x.abs().amax(dim=-1, keepdim=True)
    s = absmax.clamp_min(1e-12) / torch.full_like(absmax, q)
    return torch.clamp(torch.round(x / s), -q, q) * s


FP8_MAX = 448.0


def round_operand(x: torch.Tensor, kind: Optional[str]) -> torch.Tensor:
    """``x`` rounded to ``kind`` (``bf16``, or ``fp8``: e4m3 on a power
    of two scale that fits the tensor's absmax) and back to float32;
    float32 at None. Either is exact in TF32."""
    if kind is None:
        return x.float()
    if kind == "bf16":
        return x.to(torch.bfloat16).float()
    if kind == "fp8":
        s = torch.exp2(torch.ceil(torch.log2(
            x.float().abs().amax().clamp_min(1e-30) / FP8_MAX)))
        return (x.float() / s).to(torch.float8_e4m3fn).float() * s
    raise ValueError(f"no rounding named {kind!r}")


@contextlib.contextmanager
def tf32_mode(on: bool, conv: Optional[bool] = None):
    """cuBLAS TF32 set to ``on`` inside, cuDNN's to ``conv`` (default
    ``on``), both restored after."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on if conv is None else conv
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
