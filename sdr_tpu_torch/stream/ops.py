"""Stream operators of the broadcast-FM receive path (counterpart of
sdr_tpu/stream/ops.py).

  ====================  ====================================================
  ``U8FrontDemod``      u8 IQ -> convert -> decimate -> FM demod (kernel K1)
  ``ResampleFirScale``  rational resample (K2) -> FIR with the gain folded
                        into its taps (K3)
  ====================  ====================================================

Both read their history and their block through two pointers, so neither
makes a concatenated copy of a block, and neither needs the JAX package's
seam split.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.kernels.fir import fir_strided
from sdr_tpu_torch.kernels.resample import resample
from sdr_tpu_torch.kernels.u8_front_demod import u8_front_demod
from sdr_tpu_torch.ops.fir import FirSpec, _resample_positions
from sdr_tpu_torch.ops.quantized import u8_front_plan
from sdr_tpu_torch.parallel.halo import left_halo, substitute_first
from sdr_tpu_torch.stream.block import StreamOp
from sdr_tpu_torch.utils.device import resolve_device

__all__ = ["U8FrontDemod", "ResampleFirScale", "resampler_hist_len"]


def _tail(hist: torch.Tensor, x: torch.Tensor, h: int) -> torch.Tensor:
    """The last ``h`` samples of ``concat(hist, x)``, as a new tensor."""
    if x.shape[-1] >= h:
        return x[..., x.shape[-1] - h:].clone()
    return torch.cat([hist, x], dim=-1)[..., hist.shape[-1] + x.shape[-1]
                                        - h:].clone()


def resampler_hist_len(spec: FirSpec, offset: int, n_in: int) -> int:
    """History a rational resampler needs: how far the last output of a
    block reads behind the block start (``Fir.hist_len`` of the JAX
    package)."""
    I, D, K = spec.interpolation, spec.decimation, spec.n_taps
    if (n_in * I) % D:
        raise ValueError(f"block {n_in} incompatible with rate {I}/{D}: "
                         "n_in*I must be divisible by D")
    if I == 1:
        return max(0, K - D)
    # output m + I has m's phase and reads D samples further, so the
    # furthest read is among the last I outputs
    n_out = n_in * I // D
    first = max(0, n_out - I)
    i, o = _resample_positions(n_out - first, I, D, offset, first)
    ktaps = -(-(K - o) // I)            # taps actually read per phase
    max_read = int((i + ktaps - 1).max())
    return max(0, max_read - n_in + 1)


class U8FrontDemod(StreamOp):
    """Fused receive front: u8 IQ -> convert -> K-tap decimate-by-f in
    exact integer arithmetic -> polynomial FM demod, in one kernel (K1).

    Carry: (trailing ``2*(K - f)`` raw bytes, 0x80 at warmup; the last
    decimated ``(I, Q)`` sample, zeros at warmup)."""

    def __init__(self, taps, factor: int, precision: str = "s16",
                 device="cuda"):
        self.taps = np.asarray(taps, dtype=np.float32)
        self.factor = int(factor)
        self.n_taps = self.taps.shape[0]
        self.precision = precision
        self.device = resolve_device(device)
        tq, self.scale = u8_front_plan(self.taps, precision)
        self.tq = torch.as_tensor(tq, device=self.device)

    def out_len(self, n_in):
        if n_in % 2:
            raise ValueError("interleaved IQ needs even block")
        n = n_in // 2
        if n % self.factor:
            raise ValueError(
                f"complex block {n} not divisible by factor {self.factor}")
        return n // self.factor

    def hist_len(self) -> int:
        return 2 * max(0, self.n_taps - self.factor)

    def init_carry(self, n_in, batch_shape=()):
        bs = tuple(batch_shape)
        return (torch.full(bs + (self.hist_len(),), 0x80, dtype=torch.uint8,
                           device=self.device),
                torch.zeros(bs + (2,), dtype=torch.float32,
                            device=self.device))

    def apply(self, carry, x):
        hist, liq = carry
        y, liq_new = u8_front_demod(self.tq, self.scale, self.factor, x,
                                    hist, liq, self.out_len(x.shape[-1]))
        return (_tail(hist, x, self.hist_len()), liq_new), y

    def shard_carry(self, xb, initial=None):
        # the previous block's last H + 2f bytes hold the window of its
        # last output: K1's single output over them gives that sample
        H, f2 = self.hist_len(), 2 * self.factor
        halo = left_halo(xb, H + f2, fill=0x80)
        zeros = torch.zeros(xb.shape[:-1] + (2,), dtype=torch.float32,
                            device=xb.device)
        _, liq = u8_front_demod(self.tq, self.scale, self.factor,
                                halo[..., H:].contiguous(),
                                halo[..., :H].contiguous(), zeros, 1)
        return substitute_first((halo[..., f2:].contiguous(), liq), initial)


class ResampleFirScale(StreamOp):
    """Back half: rational resample (K2) -> FIR (K3) -> gain, the gain
    folded into the FIR taps.  Block for block the same output as the
    three-op tail ``[Fir.resampler(taps_r, I, D), Fir.filter(taps_f),
    Scale(gain)]`` of the JAX package.

    The audio FIR lags its input by ``Kf - 1`` resampler outputs, so the
    resampler runs ``Kf - 1`` outputs ahead over ``concat(hist, x)`` at
    the rebased phase ``offset_k = off_u mod I`` with a history of
    ``H1 + q`` samples (``off_u = offset + (Kf - 1)*D``, ``q = off_u //
    I``, ``H1`` the resampler's own history).  The phase is
    block-invariant, so the carry is one input slice."""

    def __init__(self, taps_r, interpolation: int, decimation: int,
                 taps_f, gain: float = 1.0, offset: int = 0, device="cuda"):
        self.spec = FirSpec(taps_r, interpolation, decimation)
        self.taps_f = np.asarray(taps_f, dtype=np.float32)
        self.gain = float(gain)
        self.offset = int(offset)
        self.device = resolve_device(device)
        self._taps_scaled = (self.gain * self.taps_f).astype(np.float32)
        I, D = self.spec.interpolation, self.spec.decimation
        off_u = self.offset + (self.taps_f.shape[0] - 1) * D
        self._offset_k = off_u % I
        self._q = off_u // I
        self._table = torch.as_tensor(self.spec.phase_table,
                                      device=self.device)
        self._taps = torch.as_tensor(self._taps_scaled, device=self.device)

    def out_len(self, n_in):
        I, D = self.spec.interpolation, self.spec.decimation
        if (n_in * I) % D:
            raise ValueError(f"block {n_in} incompatible with rate {I}/{D}")
        return n_in * I // D

    def hist_len(self, n_in: int) -> int:
        return resampler_hist_len(self.spec, self.offset, n_in) + self._q

    def init_carry(self, n_in, batch_shape=()):
        return torch.zeros(tuple(batch_shape) + (self.hist_len(n_in),),
                           dtype=torch.float32, device=self.device)

    def apply(self, carry, x):
        n_out = self.out_len(x.shape[-1])
        yr = resample(self._table, self.spec.interpolation,
                      self.spec.decimation, x, carry, self._offset_k,
                      n_out + self.taps_f.shape[0] - 1)
        y = fir_strided(self._taps, yr, n_out)
        return _tail(carry, x, carry.shape[-1]), y

    def shard_carry(self, xb, initial=None):
        return substitute_first(left_halo(xb, self.hist_len(xb.shape[-1])),
                                initial)
