"""Host-side plans of the port's redesigned kernels, checked on the CPU.

* K1 and K4 (csrc/u8_window.cuh) sum the u8 front's windows with
  ``__dp4a`` over tap words that ``kernels/u8_front.py:pack_taps`` packs.
  A numpy emulation of the kernels' arithmetic (staging at a byte offset,
  funnel shifts, ``__byte_perm`` deinterleave into ``^ 0x80`` planes,
  ``dp4a`` signed x signed and unsigned x signed) over those words equals
  ``ops/quantized.py:front_acc`` bit for bit: tolerance 0, every step is
  integer.
* ``u8_front.tap_words`` keeps the words of each taps tensor and makes
  them anew when the tensor changes in place.
* ``kernel_variants`` (what binds K1, K4, K3, K2, K5, K9, K12 and K13 on
  the card)
  patches each snippet of each variant exactly once, and raises otherwise.

Inputs come from a numpy seed; no JAX here.
"""

import numpy as np
import pytest
import torch

from sdr_tpu_torch import kernel_variants
from sdr_tpu_torch.kernels import (agc_linear, backhalf, channelize,
                                   fft_stream, fir, iir, mix, resample,
                                   stereo_decode, u8_front, u8_front_demod)
from sdr_tpu_torch.kernels.u8_front import pack_taps, tap_words
from sdr_tpu_torch.ops.quantized import front_acc, u8_front_plan

M32 = 0xFFFFFFFF


def funnel(lo, hi, sh):
    """``__funnelshift_r(lo, hi, sh)`` on uint32 arrays."""
    sh = np.asarray(sh, dtype=np.uint64)
    return ((hi.astype(np.uint64) << np.uint64(32) | lo.astype(np.uint64))
            >> sh) & np.uint64(M32)


def byte_perm(a, b, sel):
    """``__byte_perm(a, b, sel)`` on uint32 arrays."""
    src = np.stack([(a >> 8 * i) & 0xFF for i in range(4)]
                   + [(b >> 8 * i) & 0xFF for i in range(4)])
    return sum(src[(sel >> 4 * i) & 0xF] << 8 * i for i in range(4))


def dp4a(a, b, a_signed):
    """Sum of the byte products of tap words ``a`` [nw] and data words
    ``b`` [..., nw]; ``b`` signed, ``a`` signed or unsigned."""
    ab = a.astype("<u4").view(np.int8 if a_signed else np.uint8)
    bb = b.astype("<u4").view(np.int8).reshape(b.shape[:-1] + (-1,))
    return (ab.astype(np.int64) * bb.astype(np.int64)).sum(-1)


def kernel_acc(words, K, f, stream, num, start, off):
    """The kernels' int32 sums [2, num] of the stream's windows from byte
    ``start`` on, staged ``off`` bytes into a 16-byte chunk."""
    nw = words.shape[1]
    L = (num - 1) * f + K                      # plane samples
    groups = -(-L // 4)
    rng = np.random.default_rng(off)
    staged = rng.integers(0, 256, 16 + 8 * groups + 32).astype(np.uint8)
    staged[off: off + 2 * L] = stream[start: start + 2 * L]
    w = staged.view("<u4").astype(np.uint64)
    wi = (off >> 2) + 2 * np.arange(groups)
    a = funnel(w[wi], w[wi + 1], 8 * (off & 3))
    b = funnel(w[wi + 1], w[wi + 2], 8 * (off & 3))
    # past the window the planes hold bytes that meet zero taps
    planes = []
    for sel in (0x6420, 0x7531):
        p = rng.integers(0, 256, 4 * (groups + nw + 4)).astype(np.uint8)
        p[: 4 * groups] = (byte_perm(a, b, sel) ^ 0x80808080).astype(
            "<u4").view(np.uint8)
        planes.append(p.view("<u4").astype(np.uint64))
    pos = np.arange(num) * f
    q, sh = pos >> 2, (8 * (pos & 3))[:, None]
    idx = q[:, None] + np.arange(nw)
    acc = []
    for p in planes:
        data = funnel(p[idx], p[idx + 1], sh)
        hi = dp4a(words[0], data, True)
        acc.append(hi if words.shape[0] == 1
                   else 256 * hi + dp4a(words[1], data, False))
    return np.stack(acc).astype(np.int32)


@pytest.mark.parametrize("start", [0, 1, 10])
@pytest.mark.parametrize("f", [1, 4, 8])
@pytest.mark.parametrize("K", [16, 51, 63])
@pytest.mark.parametrize("precision", ["s8", "s16"])
def test_dp4a_packing_matches_front_acc(rng, precision, K, f, start):
    """pack_taps' words through the emulated staging, deinterleave and
    dp4a sums == front_acc, for staging offsets 0 to 15."""
    tq, _ = u8_front_plan(rng.uniform(-1, 1, K).astype(np.float32),
                          precision)
    words = pack_taps(tq)
    assert words.shape == ((1 if precision == "s8" else 2), 2 * -(-K // 8))
    num = 37
    stream = rng.integers(0, 256, start + 2 * ((num - 1) * f + K) + 5
                          ).astype(np.uint8)
    want = front_acc(tq, f, torch.from_numpy(stream), num, start).numpy()
    for off in (0, 3, 6, 15):
        got = kernel_acc(words, K, f, stream, num, start, off)
        np.testing.assert_array_equal(got, want)


def test_pack_taps_layout():
    """Tap 4w + i in byte i of word w, zero-padded to an even word count;
    16-bit taps split into a signed high and an unsigned low byte row."""
    w = pack_taps([1, -2, 3, -128, 127])
    assert w.shape == (1, 2)
    assert w.view(np.int8).tolist() == [[1, -2, 3, -128, 127, 0, 0, 0]]
    w16 = pack_taps([300, -300])
    assert w16.shape == (2, 2)
    hi = w16[0].view(np.int8)[:2].astype(int)
    lo = w16[1].view(np.uint8)[:2].astype(int)
    assert (256 * hi + lo).tolist() == [300, -300]
    with pytest.raises(ValueError):
        pack_taps([40_000])


def test_tap_words_kept_per_taps_tensor():
    """One tensor's words are made once; an in-place change or another
    tensor gets words of its own, equal to pack_taps'."""
    t = torch.tensor([1, -2, 3, 300], dtype=torch.int32)
    w = tap_words(t)
    assert tap_words(t) is w
    np.testing.assert_array_equal(w.numpy(), pack_taps([1, -2, 3, 300]))
    t[3] = 4                                    # now s8 taps
    w8 = tap_words(t)
    assert w8 is not w
    np.testing.assert_array_equal(w8.numpy(), pack_taps([1, -2, 3, 4]))
    u = t.clone()
    assert tap_words(u) is not w8
    assert torch.equal(tap_words(u), w8)


def test_tap_words_cache_is_bounded():
    """Many taps tensors: the cache keeps a few, and a tensor that fell
    out gets its words again."""
    first = torch.tensor([7, 8], dtype=torch.int32)
    w = tap_words(first)
    for k in range(40):
        tap_words(torch.tensor([k, 1], dtype=torch.int32))
    assert len(u8_front._WORDS) <= u8_front._WORDS_KEPT
    assert torch.equal(tap_words(first), w)


MODS = {"u8_front_demod": u8_front_demod, "u8_front": u8_front, "fir": fir,
        "resample": resample, "backhalf": backhalf, "fft_stream": fft_stream,
        "agc_linear": agc_linear, "iir": iir,
        "stereo_decode": stereo_decode, "mix": mix, "channelize": channelize}


@pytest.mark.parametrize("name", sorted(kernel_variants.VARIANTS))
def test_kernel_variants_patch_each_snippet_once(tmp_path, monkeypatch,
                                                  name):
    """Every variant's snippets are found in today's csrc, once each."""
    monkeypatch.setattr(kernel_variants, "OUT", tmp_path)
    targets, patches = kernel_variants.VARIANTS[name]
    for m in targets:
        k = kernel_variants.variant(MODS[m].KERNEL, name, patches)
        text = "".join(p.read_text() for p in k.source.parent.iterdir()
                       if p.name == k.source.name or p.suffix == ".cuh")
        for _, new in patches:
            assert new in text


@pytest.mark.parametrize("old", ["no such line;", "#include"])
def test_kernel_variants_raise_for_a_snippet_not_found_once(
        tmp_path, monkeypatch, old):
    """A snippet found nowhere, or more than once, raises."""
    monkeypatch.setattr(kernel_variants, "OUT", tmp_path)
    with pytest.raises(ValueError, match="not once"):
        kernel_variants.variant(fir.KERNEL, "bad", [(old, "x")])
