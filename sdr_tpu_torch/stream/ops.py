"""Stream operators of the broadcast-FM receive paths (counterpart of
sdr_tpu/stream/ops.py).

  ====================  ====================================================
  ``U8FrontDemod``      u8 IQ -> convert -> decimate -> FM demod (kernel K1)
  ``U8FrontEnd``        u8 IQ -> convert -> decimate, planar I/Q (K4)
  ``FmDemod``           planar I/Q -> FM demod
  ``StereoDecode``      FM composite -> L/R planes (five FIRs on K3)
  ``ResampleFirScale``  rational resample (K2) -> FIR with the gain folded
                        into its taps (K3); ``fused=True``: both in K5
  ``Iir``               cascaded biquads (ops/iir.py), e.g. de-emphasis
  ``Scale``             y = k * x
  ====================  ====================================================

The ops with a u8 or resampler history read it and their block through
two pointers, so none makes a concatenated copy of a block, and none
needs the JAX package's seam split.  ``U8FrontEnd`` and ``StereoDecode``
add a plane axis ([2] I/Q, [2] L/R) and ``FmDemod`` consumes one
(``map_batch_shape``); the ops after them batch over it.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.kernels.backhalf import resample_fir
from sdr_tpu_torch.kernels.fir import fir_strided
from sdr_tpu_torch.kernels.resample import resample
from sdr_tpu_torch.kernels.u8_front import u8_front
from sdr_tpu_torch.kernels.u8_front_demod import u8_front_demod
from sdr_tpu_torch.ops import design
from sdr_tpu_torch.ops.demod import fm_demod_planar
from sdr_tpu_torch.ops.fir import FirSpec, _resample_positions, fir_filter
from sdr_tpu_torch.ops.iir import companion_power, linear_recurrence
from sdr_tpu_torch.ops.quantized import u8_front_plan
from sdr_tpu_torch.parallel.halo import (exclusive_affine_prefix,
                                         exclusive_matrix_affine_prefix,
                                         left_halo, substitute_first)
from sdr_tpu_torch.stream.block import StreamOp
from sdr_tpu_torch.utils.device import resolve_device

__all__ = ["U8FrontDemod", "U8FrontEnd", "FmDemod", "StereoDecode",
           "ResampleFirScale", "Iir", "Scale", "resampler_hist_len"]

_F32 = torch.float32


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


class _U8Front(StreamOp):
    """What the two u8 front ends share: the quantized plan, the block
    geometry and the raw-byte history (``2*(K - f)`` bytes, 0x80 at
    warmup: the byte of the stream's zero sample)."""

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

    def _hist(self, batch_shape):
        return torch.full(tuple(batch_shape) + (self.hist_len(),), 0x80,
                          dtype=torch.uint8, device=self.device)


class U8FrontEnd(_U8Front):
    """u8 IQ ``[..., 2n]`` -> convert -> K-tap decimate-by-f in exact
    integer arithmetic -> planar I/Q ``[..., 2, n/f]`` f32, in one kernel
    (K4).  The integer taps are the JAX package's (8-bit for
    ``precision='s8'``, 16-bit for ``'s16'``), so a sample equals its
    sample bit for bit.

    Carry: the trailing ``2*(K - f)`` raw bytes, 0x80 at warmup."""

    def map_batch_shape(self, batch_shape):
        return tuple(batch_shape) + (2,)

    def init_carry(self, n_in, batch_shape=()):
        return self._hist(batch_shape)

    def apply(self, carry, x):
        y = u8_front(self.tq, self.scale, self.factor, x, carry,
                     self.out_len(x.shape[-1]))
        return _tail(carry, x, self.hist_len()), y

    def shard_carry(self, xb, initial=None):
        return substitute_first(left_halo(xb, self.hist_len(), fill=0x80),
                                initial)


class U8FrontDemod(_U8Front):
    """Fused receive front: u8 IQ -> convert -> K-tap decimate-by-f in
    exact integer arithmetic -> polynomial FM demod, in one kernel (K1).

    Carry: (trailing ``2*(K - f)`` raw bytes, 0x80 at warmup; the last
    decimated ``(I, Q)`` sample, zeros at warmup)."""

    def init_carry(self, n_in, batch_shape=()):
        return (self._hist(batch_shape),
                torch.zeros(tuple(batch_shape) + (2,), dtype=_F32,
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
        zeros = torch.zeros(xb.shape[:-1] + (2,), dtype=_F32,
                            device=xb.device)
        _, liq = u8_front_demod(self.tq, self.scale, self.factor,
                                halo[..., H:].contiguous(),
                                halo[..., :H].contiguous(), zeros, 1)
        return substitute_first((halo[..., f2:].contiguous(), liq), initial)


class FmDemod(StreamOp):
    """FM demodulation of planar I/Q ``[..., 2, n]`` -> ``[..., n]``,
    ``y[n] = atan2(x[n] * conj(x[n-1]))``; consumes the plane axis.
    ``atan2``: 'poly' (the polynomial of ops/demod.py, 5.8e-7 rad) or
    'exact' (``torch.atan2``).  The JAX package's complex-input form waits
    for the exact front's slice of the port.

    Carry: the last ``(I, Q)`` sample, zeros at warmup."""

    def __init__(self, atan2: str = "exact", device="cuda"):
        if atan2 not in ("poly", "exact"):
            raise ValueError(f"atan2 must be 'poly' or 'exact', got "
                             f"{atan2!r}")
        self.atan2 = atan2
        self.device = resolve_device(device)

    def map_batch_shape(self, batch_shape):
        return tuple(batch_shape)[:-1]

    def init_carry(self, n_in, batch_shape=()):
        # batch_shape ends with the [2] plane axis: the (I, Q) carry's shape
        return torch.zeros(tuple(batch_shape), dtype=_F32, device=self.device)

    def apply(self, carry, x):
        y, last = fm_demod_planar(x, carry, atan2=self.atan2)
        return last, y

    def shard_carry(self, xb, initial=None):
        return substitute_first(left_halo(xb, 1)[..., 0], initial)


class StereoDecode(StreamOp):
    """Broadcast-FM stereo multiplex decoder: the composite ``[..., n]``
    at ``fs`` (160 kS/s in the FM chain) -> L/R planes ``[..., 2, n]``,
    as the JAX package decodes it (see its docstring for the design).

    Open-loop carrier recovery: bandpass the 19 kHz pilot, square it,
    bandpass at 38 kHz, and normalise by a 65-tap moving average of the
    squared pilot (a soft Wiener normalisation); demodulate the
    difference, lowpass it and the mono sum at 15 kHz.  All five FIRs are
    65-tap centred filters run by ``fir_filter`` (K3 on the card); the
    outputs lag the composite by 96 samples.  ``L = mono + g*diff``,
    ``R = mono - g*diff``, with ``g = SEPARATION_GAIN``.

    **Pilot lock**: per block, the normalised pilot power ``r =
    mean(bp19(x)^2) / mean(x^2)`` locks (``r > LOCK_HI``) or unlocks
    (``r < LOCK_LO``); in between the previous block's state holds.  Unlocked, the difference channel is zeroed (L == R).  Each
    block's decision is an affine map on the entering lock (decisive:
    constant, hold: identity), so block-parallel runs compose them with
    the scalar affine prefix and equal the stream.

    Carry: (the trailing 192 composite samples, zeros at warmup; the lock
    state, 0 at warmup)."""

    H = 192                     # carry: trailing composite samples
    K = 65                      # all internal FIRs (odd -> integer delay)
    SEPARATION_GAIN = 2.0       # the JAX package's defaults
    PILOT_FLOOR = 1e-4
    LOCK_HI, LOCK_LO = 0.02, 0.005

    def __init__(self, fs: float = 160_000.0, device="cuda"):
        ny = fs / 2
        if ny <= 53_000:
            raise ValueError(f"composite rate {fs:.0f} too low for the "
                             "stereo multiplex (needs > 106 kS/s)")
        K = self.K
        try:
            self.bp19 = design.remez(
                K, [0, 15_300, 18_300, 19_700, 22_700, ny], [0, 1, 0],
                fs=fs)
            self.bp38 = design.remez(
                K, [0, 24_000, 34_000, 42_000, 52_000, ny], [0, 1, 0],
                fs=fs)
            self.lp15 = design.remez(K, [0, 15_000, 19_000, ny], [1, 0],
                                     fs=fs)
        except ImportError:   # scipy unavailable: the JAX package's fallback
            ws, h = design.windowed_sinc, design.hamming
            self.bp19 = ws(K, 21_000 / ny, h) - ws(K, 17_000 / ny, h)
            self.bp38 = ws(K, 46_000 / ny, h) - ws(K, 30_000 / ny, h)
            self.lp15 = ws(K, 15_000 / ny, h)
        self.avg = np.full(K, 1.0 / K, dtype=np.float32)
        self.device = resolve_device(device)
        self._bp19, self._bp38, self._lp15, self._avg = (
            torch.as_tensor(t, dtype=_F32, device=self.device)
            for t in (self.bp19, self.bp38, self.lp15, self.avg))

    def map_batch_shape(self, batch_shape):
        return tuple(batch_shape) + (2,)

    def init_carry(self, n_in, batch_shape=()):
        bs = tuple(batch_shape)
        return (torch.zeros(bs + (self.H,), dtype=_F32, device=self.device),
                torch.zeros(bs, dtype=_F32, device=self.device))

    def _lock_metric(self, xe, sq):
        """Normalised pilot power of the extended block: the lock
        decision's input, the same in apply and shard_carry."""
        return sq.mean(dim=-1) / ((xe * xe).mean(dim=-1) + 1e-12)

    def apply(self, carry, x):
        hist, lock = carry
        n = x.shape[-1]
        xe = torch.cat([hist, x], dim=-1)                # [.., H + n]
        nt = xe.shape[-1]
        d = (self.K - 1) // 2                            # 32
        # fir_filter output m is centred at input m + d; each stage of the
        # cascade shifts the centre by d
        pilot = fir_filter(self._bp19, xe, nt - 2 * d)   # centre +32
        sq = pilot * pilot
        car = fir_filter(self._bp38, sq, nt - 4 * d)     # centre +64
        norm = fir_filter(self._avg, sq, nt - 4 * d)     # centre +64
        car = car * norm / (norm * norm + self.PILOT_FLOOR ** 2)
        prod = xe[..., 2 * d: 2 * d + nt - 4 * d] * car  # centre +64
        diff = fir_filter(self._lp15, prod, nt - 6 * d)  # centre +96
        # mono: exactly the n emitted outputs (centres [H-96, H+n-96))
        m = fir_filter(self._lp15, xe, n, start=self.H - 4 * d)
        r = self._lock_metric(xe, sq)
        new_lock = torch.where(
            r > self.LOCK_HI, torch.ones_like(lock),
            torch.where(r < self.LOCK_LO, torch.zeros_like(lock), lock))
        s = diff[..., :n] * self.SEPARATION_GAIN * new_lock[..., None]
        y = torch.stack([m + s, m - s], dim=-2)
        return (xe[..., nt - self.H:].clone(), new_lock), y

    def shard_carry(self, xb, initial=None):
        h = left_halo(xb, self.H)
        lock0 = torch.zeros(xb.shape[:-1], dtype=_F32, device=xb.device)
        if initial is not None:
            h = substitute_first(h, initial[0])
            lock0 += torch.as_tensor(initial[1], dtype=_F32,
                                     device=xb.device)
        # the exact entering lock state: each row's decision is an affine
        # map on the lock, composed by the scalar affine prefix; r comes
        # from the same extended block apply will see
        xe = torch.cat([h, xb], dim=-1)
        d = (self.K - 1) // 2
        pilot = fir_filter(self._bp19, xe, xe.shape[-1] - 2 * d)
        r = self._lock_metric(xe, pilot * pilot)
        decisive = (r > self.LOCK_HI) | (r < self.LOCK_LO)
        a = torch.where(decisive, 0.0, 1.0).to(_F32)
        b = torch.where(r > self.LOCK_HI, 1.0, 0.0).to(_F32)
        A, B = exclusive_affine_prefix(a, b)
        return (h, A * lock0 + B)


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
    block-invariant, so the carry is one input slice.

    ``fused=True`` runs both stages in one kernel (K5), the resampled
    intermediate kept in shared memory; the default runs K2 then K3, as
    the JAX package does by default.  The two give the same samples.
    Leading dims batch (the stereo chain's [2] L/R planes)."""

    def __init__(self, taps_r, interpolation: int, decimation: int,
                 taps_f, gain: float = 1.0, offset: int = 0,
                 fused: bool = False, device="cuda"):
        self.spec = FirSpec(taps_r, interpolation, decimation)
        self.taps_f = np.asarray(taps_f, dtype=np.float32)
        self.gain = float(gain)
        self.offset = int(offset)
        self.fused = bool(fused)
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
        I, D = self.spec.interpolation, self.spec.decimation
        if self.fused:
            y = resample_fir(self._table, I, D, self._taps, x, carry,
                             self._offset_k, n_out)
        else:
            yr = resample(self._table, I, D, x, carry, self._offset_k,
                          n_out + self.taps_f.shape[0] - 1)
            y = fir_strided(self._taps, yr, n_out)
        return _tail(carry, x, carry.shape[-1]), y

    def shard_carry(self, xb, initial=None):
        return substitute_first(left_halo(xb, self.hist_len(xb.shape[-1])),
                                initial)


class Iir(StreamOp):
    """Streaming cascaded-biquad IIR (ops/iir.py) with exact cross-block
    state: each section carries its last two inputs and outputs.

    Block-parallel runs: each section is an order-2 linear recurrence, so
    a row reduces to one affine map on the state ``(y[-1], y[-2])``,
    ``s -> C^n s + v`` (``C^n`` from float64, ``v`` the row's final state
    from zero), and the matrix affine prefix over the rows gives the state
    entering each row.  Section ``s+1``'s input is section ``s``'s output,
    known once its entering state is.  That state is rounded otherwise
    than the streamed recurrence's, so the two runs agree to f32 rounding,
    not bitwise.

    Carry: (last two inputs, last two outputs), each ``[..., S, 2]`` in
    time order, zeros at warmup."""

    def __init__(self, sos, device="cuda"):
        sos = np.asarray(sos, dtype=np.float32)
        if sos.ndim == 1:
            sos = sos[None, :]
        if sos.shape[-1] != 6:
            raise ValueError("sos must be [S, 6]")
        self.sos = sos / sos[:, 3:4]  # normalise a0
        self.device = resolve_device(device)

    def init_carry(self, n_in, batch_shape=()):
        shape = tuple(batch_shape) + (self.sos.shape[0], 2)
        return (torch.zeros(shape, dtype=_F32, device=self.device),
                torch.zeros(shape, dtype=_F32, device=self.device))

    def _section(self, s):
        """(feed-forward taps as floats, feedback coefficients)."""
        b, a = self.sos[s, :3], self.sos[s, 3:]
        return ([float(v) for v in b],
                np.array([-a[1], -a[2]], dtype=np.float32))

    @staticmethod
    def _drive(b, xp):
        return b[0] * xp[..., 2:] + b[1] * xp[..., 1:-1] + b[2] * xp[..., :-2]

    def apply(self, carry, x):
        xin, yout = carry
        new_xin, new_yout = [], []
        for s in range(self.sos.shape[0]):
            b, coeffs = self._section(s)
            xp = torch.cat([xin[..., s, :], x], dim=-1)
            # the state is (y[-1], y[-2]); the carry stores time order
            y = linear_recurrence(coeffs, self._drive(b, xp),
                                  yout[..., s, :].flip(-1))
            new_xin.append(xp[..., -2:])
            new_yout.append(y[..., -2:])
            x = y
        return (torch.stack(new_xin, dim=-2),
                torch.stack(new_yout, dim=-2)), x

    def shard_carry(self, xb, initial=None):
        x = xb.to(_F32)
        n = x.shape[-1]
        xin_list, yout_list = [], []
        for s in range(self.sos.shape[0]):
            b, coeffs = self._section(s)
            xin = left_halo(x, 2)
            if initial is not None:
                xin = substitute_first(xin, initial[0][..., s, :])
            drive = self._drive(b, torch.cat([xin, x], dim=-1))
            y_zero = linear_recurrence(coeffs, drive)
            Mn = companion_power(tuple(float(c) for c in coeffs), n,
                                 x.device)
            v = y_zero[..., -2:].flip(-1)
            A, enter = exclusive_matrix_affine_prefix(
                Mn.expand(v.shape[:-1] + (2, 2)), v)
            if initial is not None:
                s0 = torch.as_tensor(initial[1][..., s, :], dtype=_F32,
                                     device=x.device).flip(-1)
                enter = enter + (A @ s0[..., None])[..., 0]
            xin_list.append(xin)
            yout_list.append(enter.flip(-1))
            if s + 1 < self.sos.shape[0]:
                x = linear_recurrence(coeffs, drive, enter)
        return (torch.stack(xin_list, dim=-2),
                torch.stack(yout_list, dim=-2))


class Scale(StreamOp):
    """y = k * x (stateless)."""

    def __init__(self, factor: float, device="cuda"):
        self.factor = float(np.float32(factor))
        self.device = resolve_device(device)

    def apply(self, carry, x):
        return carry, x * self.factor
