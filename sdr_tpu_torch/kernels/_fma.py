"""The exact f32 fused multiply-add in plain PyTorch, for the plain
versions of kernels that sum with ``__fmaf_rn``.

``fma_f32(a, b, c)`` is ``a * b + c`` rounded once to f32 (round to
nearest, ties to even), as the card's ``fmaf`` and C's ``fmaf`` give it,
on any device:

1. the product in float64 is exact (24 + 24 significand bits fit in 53);
2. the sum ``s = p + c`` in float64, and its exact error ``e`` by
   TwoSum (``p + c == s + e`` exactly);
3. ``s`` rounded to odd: where ``e`` is nonzero and the last bit of ``s``
   is even, ``s`` steps one float64 ulp toward ``e``;
4. the cast to f32.

Round-to-odd at 53 bits followed by round-to-nearest at 24 bits is the
correctly rounded result (Boldo and Melquiond, "Emulation of FMA and
correctly rounded sums: proved algorithms using rounding to odd", IEEE
Trans. Computers 57(4), 2008): 53 >= 24 + 2.  The plain float64 route,
``f32(f64(a) * f64(b) + f64(c))``, rounds twice and is not enough: for
``a = (2^12 + 1) 2^-12``, ``b = (2^24 - 2^12 + 1) 2^-48``, ``c = 1`` the
exact value is ``1 + 2^-24 + 2^-60``; float64 rounds it to ``1 + 2^-24``,
a tie that f32 rounds to even, ``1``, where ``fmaf`` gives ``1 + 2^-23``.

No kernel uses this module; it serves the plain versions only.
"""

from __future__ import annotations

import torch

__all__ = ["fma_f32"]

_F64 = torch.float64


def fma_f32(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, elementwise with broadcasting.
    ``a``, ``b`` and ``c`` hold f32 values: f32 tensors, or float64
    tensors that hold f32 values exactly (a caller that reuses one operand
    across many calls converts it once)."""
    p = a.to(_F64) * b.to(_F64)
    c = c.to(_F64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    up, down = e > 0, e < 0
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where(even & (up | down),
                    torch.nextafter(s, torch.where(up, float("inf"),
                                                   float("-inf"))), s)
    return s.to(torch.float32)
