"""FIR filter / decimator / polyphase rational resampler (counterpart of
sdr_tpu/ops/fir.py).

One formulation covers all three: a strided sliding dot product with a
per-output coefficient phase,

    y[m] = sum_k T[o_m, k] * x[start + i_m + k]

    filter / decimate:  i_m = m * f,          o_m = 0
    resample (I/D):     t_m = m*D - offset,   o_m = (-t_m) mod I,
                        i_m = (t_m + o_m) / I,  T[o, k] = taps[o + k*I]

The closed form makes every output's read position and phase a static
function of m, so no sequential recurrence is needed and a block's phase
is block-invariant.  ``fir_filter`` / ``fir_decimate`` run kernel K3
(kernels/fir.py) and ``fir_resample`` kernel K2 (kernels/resample.py) on
CUDA tensors, and their plain PyTorch versions on CPU tensors.  K3 reads
complex64 where it lies (its complex form: time-contiguous rows, or the
channel-major transpose ``Channelize`` gives) and writes complex64.  K2
runs complex input as a real batch: ``[..., N]`` complex64 becomes
``[..., 2, N]`` f32 planes (one copy), the kernel runs over the planes as
rows, and the output is rebuilt complex.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.kernels import fir as fir_kernel
from sdr_tpu_torch.kernels import resample as resample_kernel

__all__ = ["FirSpec", "prepare_phase_table", "resample_output_count",
           "resample_end_offset", "as_real_batch", "fir_filter",
           "fir_decimate", "fir_resample"]


def prepare_phase_table(taps, interpolation: int) -> np.ndarray:
    """Polyphase coefficient table ``T[o, k] = taps[o + k*I]`` (zero padded)."""
    taps = np.asarray(taps, dtype=np.float32)
    K = taps.shape[0]
    I = int(interpolation)
    Kp = -(-K // I)
    table = np.zeros((I, Kp), dtype=np.float32)
    for o in range(I):
        row = taps[o::I]
        table[o, : row.shape[0]] = row
    return table


def _resample_positions(num: int, interpolation: int, decimation: int,
                        offset: int, first: int = 0
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Closed-form (i_m, o_m) for outputs m in [first, first + num)."""
    m = np.arange(first, first + num, dtype=np.int64)
    t = m * decimation - offset
    o = (-t) % interpolation
    i = (t + o) // interpolation
    return i, o


def resample_output_count(n_in: int, n_taps: int, interpolation: int,
                          decimation: int, offset: int) -> int:
    """Outputs computable from ``n_in`` inputs at start phase ``offset``."""
    c = (n_in * interpolation - n_taps + offset) // decimation + 1
    return max(0, c)


def resample_end_offset(count: int, interpolation: int, decimation: int,
                        offset: int) -> int:
    """Phase after emitting ``count`` outputs (carry for the next block)."""
    return (offset - count * decimation) % interpolation


class FirSpec:
    """Static plan for a rational-rate FIR: ``interpolation == decimation
    == 1`` is a plain filter, ``interpolation == 1`` a decimator,
    otherwise a rational resampler.  ``symmetric=True`` takes the first
    half of a linear-phase filter and mirrors it."""

    def __init__(self, taps, interpolation: int = 1, decimation: int = 1,
                 symmetric: bool = False):
        taps = np.asarray(taps, dtype=np.float32)
        if symmetric:
            taps = np.concatenate([taps, taps[::-1]])
        if taps.ndim != 1:
            raise ValueError("taps must be 1-D")
        if interpolation < 1 or decimation < 1:
            raise ValueError("factors must be >= 1")
        self.taps = taps
        self.interpolation = int(interpolation)
        self.decimation = int(decimation)
        self.n_taps = int(taps.shape[0])
        self.phase_table = prepare_phase_table(taps, self.interpolation)
        self.taps_per_phase = self.phase_table.shape[1]

    def __repr__(self):
        return (f"FirSpec(K={self.n_taps}, I={self.interpolation}, "
                f"D={self.decimation})")


def _on(x: torch.Tensor, a) -> torch.Tensor:
    """``a`` (numpy or tensor) as an f32 tensor on ``x``'s device."""
    return torch.as_tensor(a, dtype=torch.float32, device=x.device)


def as_real_batch(x: torch.Tensor):
    """Complex ``[..., N]`` as real planes ``[..., 2, N]`` (a copy) and the
    function rebuilding a complex ``[..., M]`` from ``[..., 2, M]``; real
    ``x`` as itself and the identity."""
    if x.is_complex():
        return (torch.stack([x.real, x.imag], dim=-2),
                lambda y: torch.complex(y[..., 0, :], y[..., 1, :]))
    return x, lambda y: y


def fir_filter(taps, x: torch.Tensor, num: int | None = None,
               start: int = 0) -> torch.Tensor:
    """``y[i] = sum_j taps[j] * x[..., start + i + j]``; ``num`` defaults
    to the full valid length."""
    return fir_decimate(taps, 1, x, num, start)


# complex inputs fir_decimate copied to a layout K3 reads (none of the
# chains makes one): a count, as the kernels count their launches
layout_copies = 0


def fir_decimate(taps, factor: int, x: torch.Tensor, num: int | None = None,
                 start: int = 0, out: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """``y[i] = sum_j taps[j] * x[..., start + i*factor + j]``; complex
    ``x`` may write into ``out`` (a complex64 view with contiguous rows,
    returned)."""
    global layout_copies
    taps = _on(x, taps)
    if num is None:
        num = (x.shape[-1] - start - taps.shape[0]) // factor + 1
    if num < 0:
        raise ValueError("input shorter than filter")
    if (x.dtype == torch.complex64
            and fir_kernel.complex_layout(x) is None):
        # a layout neither complex form reads: one explicit copy to
        # contiguous rows, after which K3 still runs
        layout_copies += 1
        x = x.contiguous()
    return fir_kernel.fir_strided(taps, x, int(num), int(factor),
                                  int(start), out=out)


def fir_resample(taps, interpolation: int, decimation: int,
                 x: torch.Tensor, offset: int = 0, num: int | None = None,
                 start: int = 0, hist: torch.Tensor | None = None):
    """Polyphase rational resampler over ``concat(hist, x)`` (``hist``
    optional, read in place): returns ``(y, end_offset)``, ``end_offset``
    being the phase carry for the next block."""
    taps = np.asarray(taps, dtype=np.float32)
    I, D = int(interpolation), int(decimation)
    offset, start = int(offset), int(start)
    if not 0 <= offset < I:
        raise ValueError("offset must be in [0, interpolation)")
    if hist is None:
        hist = x.new_empty(x.shape[:-1] + (0,))
    if num is None:
        num = resample_output_count(hist.shape[-1] + x.shape[-1] - start,
                                    taps.shape[0], I, D, offset)
    num = int(num)
    table = _on(x, prepare_phase_table(taps, I))
    xr, rebuild = as_real_batch(x)
    hr, _ = as_real_batch(hist)
    y = resample_kernel.resample(table, I, D, xr, hr, offset, num, start)
    return rebuild(y), resample_end_offset(num, I, D, offset)
