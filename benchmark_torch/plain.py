"""Helpers of the plain references under ``configs/``: plain PyTorch,
nothing of the program.

A reference runs each einsum as ``torch.einsum`` calls of two operands in
float32, with TF32 off (``run.py`` turns it off for the whole process).
``tf32=True`` gives the control that decides whether the check can tell a
lower precision: every operand of every product rounded to TF32 (10
mantissa bits, to nearest, ties away from zero, as the tensor cores'
``cvt.rna.tf32.f32``), the sums kept in float32, which is what a TF32
matrix product does.
"""

from __future__ import annotations

import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """*x* (float32) rounded to the nearest TF32 value, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def einsum(subscripts: str, a: torch.Tensor, b: torch.Tensor,
           tf32: bool) -> torch.Tensor:
    """``torch.einsum`` of two operands, their entries rounded to TF32
    first where *tf32*."""
    if tf32:
        a, b = to_tf32(a), to_tf32(b)
    return torch.einsum(subscripts, a, b)
