"""K12: the linear AGC's affine scan (csrc/agc_linear.cu).

No TPU kernel has this role: the JAX package evaluates the recurrence
with ``jax.lax.associative_scan`` (sdr_tpu/ops/scans.py:44-61
``linear_scan``, used by ``agc_gains`` and ``agc_affine``), one XLA op.
Over rows of real envelopes ``m [..., n]``, or of planar I/Q
``x [..., 2, n]`` whose envelope it takes itself, the positive-gain AGC
recurrence

    g[n+1] = g[n] * (1 - mu*m[n]) + mu*ref,

with ``mu`` and ``mu*ref`` rounded to f32 as ops/scans.py rounds them,
in two modes: :func:`agc_affine` gives each row's affine map ``(A, B)``
(``g_out = A * g_in + B``, the carry algebra of block-parallel runs);
:func:`agc_gains` and :func:`agc_apply` run the scan from each row's
entering gain and give the gains applied to the samples, or the planes
scaled by them, and the gain after the row.

The plain versions are the scans in whole-tensor PyTorch operations
(:func:`linear_scan`, :func:`affine_reduce`), and the kernel keeps their
order of operations, each product, sum and root one rounded f32 operation,
so it equals them bitwise.  The envelope of planar I/Q is
``sqrt(re*re + im*im)`` correctly rounded: PyTorch's f32 ``sqrt`` on the
CPU is not (some results are an ulp off), so the plain version roots in
float64 and rounds, which is the kernel's ``__fsqrt_rn`` (kernels/agc.py
has the argument).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr
from sdr_tpu_torch.kernels.affine_prefix import compose, doubling

__all__ = ["KERNEL", "CHUNK", "SUB", "linear_scan", "affine_reduce",
           "envelope", "agc_affine", "agc_affine_reference", "agc_gains",
           "agc_gains_reference", "agc_apply", "agc_apply_reference",
           "scan_scratch_floats"]

CHUNK = 128                     # samples a chunk of the scan
SUB = 32                        # samples a sub-chunk (a kernel thread's)
REDUCE_TILE = 4096              # maps a block of the kernel's reduce folds
_F32 = torch.float32

_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
KERNEL = Kernel("agc_linear", {
    "launch_agc_linear_reduce": [_P, _P, _P, _P, _LL, _LL, _LL, _F, _F, _I],
    "launch_agc_linear_scan": [_P, _P, _P, _P, _P, _LL, _LL, _LL, _F, _F,
                               _I],
})


def _exclusive(a: torch.Tensor, b: torch.Tensor):
    """The inclusive prefix ``(a, b)`` over the leading axis shifted by
    one: the identity first."""
    return (torch.cat([torch.ones_like(a[:1]), a[:-1]]),
            torch.cat([torch.zeros_like(b[:1]), b[:-1]]))


def _inner(a: torch.Tensor, b: torch.Tensor, axis: int):
    """K15's plain :func:`~sdr_tpu_torch.kernels.affine_prefix.doubling`
    over ``axis``."""
    return tuple(t.movedim(0, axis) for t in doubling(a.movedim(axis, 0),
                                                      b.movedim(axis, 0)))


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                y0: torch.Tensor) -> torch.Tensor:
    """``y[n] = a[n] * y[n-1] + b[n]`` with ``y[-1] = y0``, for ``a``,
    ``b`` ``[..., N]`` and ``y0`` ``[...]``.

    Each sample's map ``y -> a*y + b`` is composed with those before it by
    the doubling of K15's plain version (log2 steps of whole-tensor ops, no
    per-sample loop) at three levels: inside each sub-chunk of SUB
    samples (the inclusive prefixes I), over each chunk's CHUNK / SUB
    sub-chunk maps (I at a sub-chunk's last sample; X their exclusive
    prefixes, the chunk's whole map the level's value at its last
    sub-chunk), and over a row's chunk maps (exclusive, P).  Then the
    state entering each chunk ``PA*y0 + PB``, each sub-chunk ``g = XA*enter
    + XB``, and ``y = IA*g + IB``.  Padded past N with identity maps."""
    lead, n = b.shape[:-1], b.shape[-1]
    if n == 0:
        return b.clone()
    L, S = CHUNK, SUB
    nc = -(-n // L)
    a = torch.nn.functional.pad(a, (0, nc * L - n), value=1.0)
    b = torch.nn.functional.pad(b, (0, nc * L - n))
    shape = lead + (nc, L // S, S)
    IA, IB = _inner(a.reshape(shape), b.reshape(shape), -1)
    QA, QB = _inner(IA[..., -1], IB[..., -1], -1)        # [..., nc, L // S]
    XA, XB = (t.movedim(0, -1) for t in _exclusive(QA.movedim(-1, 0),
                                                   QB.movedim(-1, 0)))
    PA, PB = _exclusive(*doubling(QA[..., -1].movedim(-1, 0),
                                   QB[..., -1].movedim(-1, 0)))
    enter = (PA * y0 + PB).movedim(0, -1)                 # [..., nc]
    g = XA * enter[..., None] + XB                        # [..., nc, L // S]
    y = IA * g[..., None] + IB
    return y.reshape(lead + (nc * L,))[..., :n]


def affine_reduce(a: torch.Tensor, b: torch.Tensor):
    """The composition of the maps ``y -> a[n]*y + b[n]`` over the last
    axis, ``(A, B)`` with ``y[N-1] = A * y[-1] + B``: a pairwise tree,
    halving the maps each step (about 2N map compositions, where
    :func:`linear_scan` would make all N outputs to keep one).  An empty
    axis gives the identity ``(1, 0)``."""
    if a.shape[-1] == 0:
        return (a.new_ones(a.shape[:-1]), b.new_zeros(b.shape[:-1]))
    while a.shape[-1] > 1:
        if a.shape[-1] % 2:
            a = torch.nn.functional.pad(a, (0, 1), value=1.0)
            b = torch.nn.functional.pad(b, (0, 1))
        # the earlier map of each pair first, then the later one
        a, b = compose((a[..., 1::2], b[..., 1::2]),
                        (a[..., 0::2], b[..., 0::2]))
    return a[..., 0], b[..., 0]


def envelope(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` of planar I/Q ``[..., 2, n]``: ``sqrt(re*re + im*im)``, the
    sum in f32 and the root correctly rounded."""
    re, im = x[..., 0, :], x[..., 1, :]
    return torch.sqrt((re * re + im * im).double()).to(_F32)


def _coeffs(mu: float, reference: float):
    """``mu`` and ``mu*ref`` as f32 values, as ops/scans.py rounds them."""
    mu32 = np.float32(mu)
    return float(mu32), float(mu32 * np.float32(reference))


def _check(x: torch.Tensor, planar: bool, g0: torch.Tensor | None = None):
    if x.dtype != _F32:
        raise ValueError(f"x must be float32, not {x.dtype}")
    if planar and (x.ndim < 2 or x.shape[-2] != 2):
        raise ValueError(f"x {tuple(x.shape)} must be planar [..., 2, n]")
    lead = x.shape[:-2] if planar else x.shape[:-1]
    if g0 is not None:
        if g0.dtype != _F32 or g0.device != x.device:
            raise ValueError("g0 must be float32 on x's device")
        if g0.shape != lead:
            raise ValueError(f"g0 {tuple(g0.shape)} must be x's leading "
                             f"dims {tuple(lead)}")


def _map_a(m: torch.Tensor, mu: float) -> torch.Tensor:
    return 1.0 - mu * m


def agc_affine_reference(x: torch.Tensor, mu: float, reference: float,
                         planar: bool = False):
    """Plain PyTorch version of :func:`agc_affine`."""
    _check(x, planar)
    mu, muref = _coeffs(mu, reference)
    a = _map_a(envelope(x) if planar else x, mu)
    return affine_reduce(a, torch.full_like(a, muref))


def agc_gains_reference(m: torch.Tensor, mu: float, reference: float,
                        g0: torch.Tensor):
    """Plain PyTorch version of :func:`agc_gains`."""
    _check(m, False, g0)
    mu, muref = _coeffs(mu, reference)
    if m.shape[-1] == 0:
        return m.clone(), g0.clone()
    a = _map_a(m, mu)
    h = linear_scan(a, torch.full_like(a, muref), g0)
    # h[n] = g[n+1]; sample n takes g[n] = (g0, h[:-1])
    g = torch.cat([g0[..., None], h[..., :-1]], dim=-1)
    return g, h[..., -1].clone()


def agc_apply_reference(x: torch.Tensor, mu: float, reference: float,
                        g0: torch.Tensor):
    """Plain PyTorch version of :func:`agc_apply`."""
    _check(x, True, g0)
    g, final = agc_gains_reference(envelope(x), mu, reference, g0)
    return x * g[..., None, :], final


def _device(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (the plain version); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def _rows(x: torch.Tensor, planar: bool) -> int:
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.shape[-1]
    return cuda_rows(x=x.view(x.shape[:-2] + (2 * n,)) if planar else x)


def agc_affine(x: torch.Tensor, mu: float, reference: float,
               planar: bool = False):
    """Each row's affine map ``(A, B)`` of the AGC recurrence over real
    envelopes ``x [..., n]`` or, ``planar``, over planar I/Q ``x [..., 2,
    n]`` (the envelope taken here): ``A``, ``B`` ``[...]``.  Launches K12
    for CUDA tensors; CPU tensors take the plain version."""
    if not _device(x):
        return agc_affine_reference(x, mu, reference, planar)
    _check(x, planar)
    rows = _rows(x, planar)
    lead = x.shape[:-2] if planar else x.shape[:-1]
    n = x.shape[-1]
    if n == 0 or rows == 0:             # the identity map
        return (torch.ones(lead, dtype=_F32, device=x.device),
                torch.zeros(lead, dtype=_F32, device=x.device))
    A = torch.empty(lead, dtype=_F32, device=x.device)
    B = torch.empty(lead, dtype=_F32, device=x.device)
    floats, count = 0, -(-n // REDUCE_TILE)
    while count > 1:                    # the folds before the last
        floats += 2 * rows * count
        count = -(-count // REDUCE_TILE)
    scratch = torch.empty(max(floats, 1), dtype=_F32, device=x.device)
    mu, muref = _coeffs(mu, reference)
    KERNEL.launch("launch_agc_linear_reduce", x.device, ptr(x), ptr(A),
                  ptr(B), ptr(scratch), floats, rows, n, mu, muref,
                  int(planar))
    return A, B


def scan_scratch_floats(rows: int, n: int) -> int:
    """The scan launch's scratch: its counters (a ticket, each row's
    completion count and ready flag), each chunk's map and entering
    state."""
    return 2 * rows + 2 + 3 * rows * -(-n // CHUNK)


def _scan(x: torch.Tensor, mu: float, reference: float, g0: torch.Tensor,
          planar: bool):
    _check(x, planar, g0)
    rows = _rows(x, planar)
    if not g0.is_contiguous():
        raise ValueError("g0 must be contiguous")
    n = x.shape[-1]
    out = torch.empty_like(x)
    final = torch.empty_like(g0)
    if n == 0 or rows == 0:
        final.copy_(g0)
        return out, final
    floats = scan_scratch_floats(rows, n)
    scratch = torch.empty(floats, dtype=_F32, device=x.device)
    mu, muref = _coeffs(mu, reference)
    KERNEL.launch("launch_agc_linear_scan", x.device, ptr(x), ptr(g0),
                  ptr(out), ptr(final), ptr(scratch), floats, rows, n, mu,
                  muref, int(planar))
    return out, final


def agc_gains(m: torch.Tensor, mu: float, reference: float,
              g0: torch.Tensor):
    """The AGC's gains from real envelopes ``m [..., n]`` and each row's
    entering gain ``g0 [...]``: ``(g, final)``, ``g[n]`` the gain applied
    to sample n and ``final`` the gain after the row.  Launches K12 for
    CUDA tensors; CPU tensors take the plain version."""
    if not _device(m):
        return agc_gains_reference(m, mu, reference, g0)
    return _scan(m, mu, reference, g0, planar=False)


def agc_apply(x: torch.Tensor, mu: float, reference: float,
              g0: torch.Tensor):
    """The AGC over planar I/Q ``x [..., 2, n]`` from each row's entering
    gain ``g0 [...]``: ``(y, final)``, both planes scaled by the gains of
    the envelope's recurrence, and the gain after the row.  Launches K12
    for CUDA tensors; CPU tensors take the plain version."""
    if not _device(x):
        return agc_apply_reference(x, mu, reference, g0)
    return _scan(x, mu, reference, g0, planar=True)
