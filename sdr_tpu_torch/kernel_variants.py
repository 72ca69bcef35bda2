"""What binds K1, K4, K3, K2, K5, K9, K12, K13, K14, K8's complex form
and K7 + DFT on the card: each kernel beside source variants of itself, timed in
turns in one process.

    python -m sdr_tpu_torch.kernel_variants [--kernels fir ...]

Each variant is the kernels' sources (``csrc/``) with a few lines replaced,
each snippet found exactly once or the tool raises (:func:`variant`),
built like the kernels themselves into ``build/variants/<name>/``.  A
variant that drops work (``no_sums``: the windows are staged but not
summed; ``no_demod``: K1 writes a sum of the products instead of the
atan2; ``ring_no_stores``: K1 computes the atan2 but stores (almost)
nothing; ``ring_no_loads``: K1's producer copies its block's first S
tiles only, and the consumers compute every later tile from the bytes
left in its slot; ``ring_no_deint``: K1's consumer warps sum planes
never deinterleaved; ``ring_skeleton``: K1's warps only wait, read
heads and release slots (no copies, deinterleave, sums, demod or
stores); ``resample_no_stores``: K2 sums but stores (almost) nothing;
``backhalf_no_stage1`` / ``no_stage2``: K5 without its resample or its
FIR sums; ``fir_dec_no_sums``: K3's staged f > 1 branch stages and
splits its tiles into phase rows but sums nothing; ``fft_no_stores``,
``fft_no_stage``, ``fft_no_dft``, ``fft_no_twiddles``: K9 without its
stores of ``|X|``, its staging loads, its register DFTs or its
twiddles) shows what the rest costs; ``fft_sqrt_approx`` writes ``|X|``
through the approximate square root (within about an ulp, not the
committed rounding); ``fma`` and ``fir_dec_fma`` contract K3's (and K5's second
stage's) multiply and add (not the plain version's rounding) and show
what the no-FMA order costs; the others change a design choice (the
runtime loop in place of a compiled geometry, the phase rows unpadded,
4 outputs a thread at f = 8, half the tile (K4's ``ns512``, K1's
``ring_w64``), K1's tiles of 256 samples a warp in one slot
(``ring_w256``); K1's ring of two slots (``ring_stages2``), at two
blocks an SM (``ring_occ2``, five slots) or four (``ring_occ4``, two
slots, 56 registers); for K3's complex form
``fir_iq_both_planes``, a thread summing both planes of its two
outputs and storing them as one float4; ``fir_iq_inline``, the tile's
split and sums inlined into the persistent loop) and must equal the
committed
kernels bitwise; ``fir_iq_no_sums`` and ``fir_cm_no_sums`` stage (and
split) the complex tiles but sum nothing; ``stereo_no_sums`` and
``stereo_no_stores``: K14's launch B stages its tiles but sums none of
its three filters nor the boxcar, or sums but stores nothing;
``stereo_no_loads`` and ``pilot_no_loads``: launch B or A stages its
first tile only and computes every later one from it (the copies' cost,
and whether they overlap the sums); ``pilot_no_sums``: launch A without
its pilot sums; ``pilot_no_fence``:
launch A without the fence between a row's partial sums and their
completion count (the lock may then read a stale sum); ``pilot_stride``:
launch A's blocks walk every grid-th tile, counting each done behind its
own fence, in place of runs of consecutive tiles (must equal it
bitwise); ``stereo_mul_add``:
both launches' sums as a rounded product then a rounded sum (the
former arithmetic in the new design: what FMA buys); ``stereo_fir_avg``: the
boxcar as a 65-tap FMA filter of the average's taps (what the shared
sum buys); these two change the rounding.  ``stereo_bounds1``: launch B
at the compiler's own register count, without its bound of three
blocks; ``stereo_blocks2``: launch B asks for 40 KB more shared memory,
two blocks an SM in place of three;
``stereo_one_buffer``: both launches wait for the next tile's copies
before the current tile's sums (what the overlap buys);
``stereo_single_stage``: launch B with one stage buffer (38.7 KB of
shared memory, as many blocks an SM as its registers allow), each tile's
copies issued and waited for at the start of its own step; these four
must equal it bitwise.  ``mix_complex_no_stores``: K8's
complex form computes but stores nothing.  K7 + DFT (``branch_dft``,
the wideband bank's [32, 4,096,000] complex64 rows with a 704-sample
carry, C = 64, P = 12): ``dft_no_dft``, ``dft_no_sums`` and
``dft_no_stores`` drop the transform, the stencil's sums or the output
stores; ``dft_sync_stage`` stages through registers in place of
``cp.async``, ``dft_occ2`` and ``dft_occ4`` bound the registers for two
or four blocks an SM in place of three, ``dft_full_tile`` takes twice the
tile at two blocks an SM (four stencil items a thread, every thread a
row DFT); these four must equal it bitwise.  K14 is timed as
``StereoDecode`` runs it: launch A writing the squared pilot
(``stereo_a``, ``apply``'s form) and without it or an entering lock
(``stereo_a_bare``, ``shard_carry``'s), and launch B from a squared pilot
written beforehand (``stereo_b``).
Shapes are
the paths': 32 rows of 10,485,760 random u8 bytes with an 86-byte history
(K1, K4: 51 s8 taps, decimation 8), f32 rows of 196,671 (K3, 64 taps)
and 655,552 (K3, 65 taps from 128), [32, 2] planes of 5,242,880 (K3's
f > 1 branch: 51 taps at f = 8 from 5, the exact front's, and 64 at
f = 16, the AM channel filter's, and K3's complex form on [32,
5,242,880] complex64 rows at both and on the wideband bank's
channel-major [32, 64, 64,000] view at f = 8; K9 over them with a
512-sample carry,
the waterfall's 1,024-point Blackman frames at hop 512, and
``fft_occ2``, two blocks an SM in place of three, must equal it
bitwise), and rows of 655,360 with an 82-float history, 3/10
with 11 taps a phase (K2 over [32] and [32, 2] rows to 196,671 outputs,
K5 over [32, 2] to 196,608 through 64 FIR taps), AM's planar [32, 2,
327,677] and envelopes [32, 327,677] (K12's scan, ``mu`` 0.005) and
DC blocker [32, 327,677] and stereo's de-emphasis [32, 2, 196,608] (K13,
the full and the final-state launch), the stereo composite [32, 655,360]
with a 192-sample history (K14, random: every row locks) and the AM
sequential path's [32, 5,242,880] complex64 rows (K8's complex form).  Times
are the mean of 20 launches by CUDA events, queued behind a device-side
sleep (device time, not the host's enqueue), in the order committed,
variants, committed.  A ``clone`` of each input is the copy yardstick.
Prints the card's name and power limit, each build's registers and
spills as ``ptxas`` reports them, and one JSON line.  ``--kernels``
limits the run to some kernels (the sources' names: ``u8_front_demod``,
``u8_front``, ``fir``, ``resample``, ``backhalf``, ``fft_stream``,
``agc_linear``, ``iir``, ``stereo_decode``, ``mix``, ``channelize``).
Needs a CUDA GPU and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess

import torch

from sdr_tpu_torch.kernels import (_build, agc_linear, backhalf,
                                   channelize, fft_stream, fir, iir, mix,
                                   resample, stereo_decode, u8_front,
                                   u8_front_demod)
from sdr_tpu_torch.ops.design import blackman, hamming, windowed_sinc
from sdr_tpu_torch.ops.fir import prepare_phase_table
from sdr_tpu_torch.ops.quantized import u8_front_plan
from sdr_tpu_torch.stream import Mix, StereoDecode

ROWS, ROW_BYTES, HIST = 32, 10_485_760, 86
DEC_N = ROW_BYTES // 2                # f32 samples a plane of a row
AM_N, STEREO_N = 327_677, 196_608     # K12's and K13's rows
STEREO_COMP = 655_360                 # K14's composite samples a row
WB_N = 64_000                         # the wideband bank's channel samples
DC = ((1.0, -1.0), (0.997,))          # the DC blocker's section
DEEMPH = ((0.12195122, 0.12195122, 0.0), (0.75609756, 0.0))
WAVE_K12 = "constexpr long long kWaveBytes = 32LL << 20;"
WAVE_K13 = "constexpr long long kWaveBytes = 8LL << 20;"
# every copy in flight waited for, the next tile's too (the host build's
# copies are synchronous)
WAIT_ALL = """#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_all;\\n" ::);
#endif
    __syncthreads();
"""
SERIAL_RUNS = """__device__ __forceinline__ void block_scan(const double* pw, double* w,
                                           const double* enter,
                                           double* after,
                                           double (*totals)[P]) {
  __shared__ double v[kThreads][P];
  for (int k = 0; k < P; ++k) v[threadIdx.x][k] = w[k];
  __syncthreads();
  if (threadIdx.x == 0) {       // v[t] becomes the state entering run t
    double e[P];
    for (int k = 0; k < P; ++k) e[k] = enter[k];
    for (int t = 0; t < kThreads; ++t) {
      double u[P];
      for (int k = 0; k < P; ++k) {
        u[k] = v[t][k];
        v[t][k] = e[k];
      }
      advance<P>(pw + 4, e, u);
    }
    for (int k = 0; k < P; ++k) totals[0][k] = e[k];
  }
  __syncthreads();
  for (int k = 0; k < P; ++k) {
    w[k] = v[threadIdx.x][k];
    after[k] = totals[0][k];
  }
  __syncthreads();
}

template <int P>
__device__ __forceinline__ void block_scan_shfl(const double* pw, double* w,
"""
SMEM_LEVEL2 = """__device__ __forceinline__ float2 shfl_up2(float2 v, int d) {
  __shared__ float2 ex[kScanThreads];
  ex[threadIdx.x] = v;
  __syncthreads();
  const float2 o = (threadIdx.x & 3) >= d ? ex[threadIdx.x - d] : v;
  __syncthreads();
  return o;
}

__device__ __forceinline__ float2 shfl_up2_unused(float2 v, int d) {"""
# K3's complex rows: both planes' sums in one work item, stored as one
# float4 (the plane-a-work-item form's alternative)
IQ_ITEMS = """  const int pairs = (nb + 1) / 2;
  for (int v = threadIdx.x; v < 2 * pairs; v += NT) {"""
IQ_BOTH_PLANES = """  for (int u = threadIdx.x; 2 * u < nb; u += NT) {
    float ai[2] = {}, aq[2] = {};
    if constexpr (KC > 0) {
      poly_sums<KC, FC, 2>(ai, P, RS, s_taps, u);
      poly_sums<KC, FC, 2>(aq, P + f * RS, RS, s_taps, u);
    } else {
      poly_sums_rt<2>(ai, P, RS, s_taps, u, K, f);
      poly_sums_rt<2>(aq, P + f * RS, RS, s_taps, u, K, f);
    }
    float* yo = yt + 4 * u;
    if (2 * u + 2 <= nb && (reinterpret_cast<uintptr_t>(yo) & 15) == 0) {
      *reinterpret_cast<float4*>(yo) = make_float4(ai[0], aq[0], ai[1],
                                                   aq[1]);
    } else {
      for (int r = 0; r < 2; ++r)
        if (2 * u + r < nb)
          *reinterpret_cast<float2*>(yo + 2 * r) = make_float2(ai[r],
                                                               aq[r]);
    }
  }
  const int pairs = 0;
  for (int v = threadIdx.x; v < 2 * pairs; v += NT) {"""
REPS, SLEEP_CYCLES = 20, 20_000_000
OUT = _build.BUILD.parent / "variants"

# name -> (kernels it applies to, [(old, new), ...] in csrc)
VARIANTS = {
    "no_sums": (("u8_front_demod", "u8_front"), [(
        "  const int nw = tp.count();\n",
        "  if (pos >= 0) return make_int2(0, 0);\n"
        "  const int nw = tp.count();\n")]),
    "no_demod": (("u8_front_demod",), [(
        "        r[j] = poly_atan2(bq, a);", "        r[j] = bq + a;")]),
    "ns512": (("u8_front",), [(
        "for (long long ns = 4LL * NT;", "for (long long ns = 2LL * NT;")]),
    "ring_w64": (("u8_front_demod",), [(
        "constexpr int kMaxWarpSamples = 128;",
        "constexpr int kMaxWarpSamples = 64;")]),
    "ring_w256": (("u8_front_demod",), [
        ("constexpr int kMaxWarpSamples = 128;",
         "constexpr int kMaxWarpSamples = 256;"),
        ("constexpr int kMinStages = 3, kMaxStages = 8;",
         "constexpr int kMinStages = 1, kMaxStages = 8;")]),
    "ring_stages2": (("u8_front_demod",), [(
        "constexpr int kMinStages = 3, kMaxStages = 8;",
        "constexpr int kMinStages = 2, kMaxStages = 2;")]),
    "ring_occ2": (("u8_front_demod",), [(
        "constexpr int kBlocksPerSm = 3;",
        "constexpr int kBlocksPerSm = 2;")]),
    "ring_occ4": (("u8_front_demod",), [
        ("constexpr int kBlocksPerSm = 3;",
         "constexpr int kBlocksPerSm = 4;"),
        ("constexpr int kMinStages = 3, kMaxStages = 8;",
         "constexpr int kMinStages = 2, kMaxStages = 8;")]),
    "ring_no_stores": (("u8_front_demod",), [(
        "          yt[q] = r[j];",
        "          if (r[j] == 1e38f) yt[q] = r[j];")]),
    "ring_no_deint": (("u8_front_demod",), [(
        "    if (ws > 1)\n      deinterleave(",
        "    if (ws < 0)\n      deinterleave(")]),
    "ring_skeleton": (("u8_front_demod",), [
        ("    if (ws > 1)\n      deinterleave(",
         "    if (ws < 0)\n      deinterleave("),
        ("    if (ws > 1) {\n      // sample q",
         "    if (ws < 0) {\n      // sample q"),
        ("        const unsigned bytes = 16u * (sp.c1 - sp.c0);",
         "        const unsigned bytes = 0u * (sp.c1 - sp.c0);")]),
    "ring_no_loads": (("u8_front_demod",), [(
        "        const unsigned bytes = 16u * (sp.c1 - sp.c0);",
        "        const unsigned bytes = k < stages ? 16u * (sp.c1 - sp.c0) "
        ": 0u;")]),
    "fir_no_sums": (("fir",), [(
        "      if (K == 64)\n        sums_at<64>(acc, xs, s_taps, K, off);\n"
        "      else if (K == 65)\n        sums_at<65>(acc, xs, s_taps, K, off);"
        "\n      else\n", "      if (K < 0)\n")]),
    "fir_runtime_taps": (("fir",), [
        ("      if (K == 64)\n", "      if (K == -64)\n"),
        ("      else if (K == 65)\n", "      else if (K == -65)\n")]),
    "fir_fma": (("fir",), [(
        "acc[r] = __fadd_rn(acc[r], __fmul_rn(tj[jj], w[OFF + jj + r]));",
        "acc[r] = __fmaf_rn(tj[jj], w[OFF + jj + r], acc[r]);")]),
    "fir_dec_no_sums": (("fir",), [(
        "    if constexpr (KC > 0)\n      poly_sums<KC, FC, RC>(a, P, RS, s_taps, u);"
        "\n    else\n      poly_sums_rt<RC>(a, P, RS, s_taps, u, K, f);\n",
        "")]),
    "fir_dec_fma": (("fir",), [(
        "a[r] = __fadd_rn(a[r], __fmul_rn(t, w[p][q + r]));",
        "a[r] = __fmaf_rn(t, w[p][q + r], a[r]);")]),
    "fir_dec_runtime": (("fir",), [
        ("    if (f == 8 && K == 51)\n", "    if (f == -8 && K == 51)\n"),
        ("    else if (f == 16 && K == 64)\n",
         "    else if (f == -16 && K == 64)\n")]),
    "fir_dec_nopad": (("fir",), [(
        " +\n         (f % 4 == 0 && f <= 32 ? (32 / f) % 8 : 0);", ";")]),
    "fir_dec_rc4": (("fir",), [(
        "dec_tile<51, 8, 2>", "dec_tile<51, 8, 4>")]),
    "fir_dec_occ3": (("fir",), [
        ("__launch_bounds__(NT, 2)\nfird_kernel",
         "__launch_bounds__(NT, 3)\nfird_kernel"),
        ("constexpr int kDecSpan = 8192;", "constexpr int kDecSpan = 4096;")]),
    "fir_dec_occ4": (("fir",), [
        ("__launch_bounds__(NT, 2)\nfird_kernel",
         "__launch_bounds__(NT, 4)\nfird_kernel"),
        ("constexpr int kDecSpan = 8192;", "constexpr int kDecSpan = 4096;")]),
    "fir_dec_span4096": (("fir",), [(
        "constexpr int kDecSpan = 8192;", "constexpr int kDecSpan = 4096;")]),
    "fir_iq_both_planes": (("fir",), [(IQ_ITEMS, IQ_BOTH_PLANES)]),
    "fir_iq_inline": (("fir",), [(
        "__device__ __noinline__ void iq_tile(",
        "__device__ __forceinline__ void iq_tile(")]),
    "fir_iq_no_sums": (("fir",), [(
        "    if constexpr (KC > 0)\n"
        "      poly_sums<KC, FC, 2>(a, P + c * f * RS, RS, s_taps, u);\n"
        "    else\n"
        "      poly_sums_rt<2>(a, P + c * f * RS, RS, s_taps, u, K, f);\n",
        "")]),
    "fir_cm_no_sums": (("fir",), [(
        "        s_y[c * LY + i] = cm_sum(xs + i * f * kChannels, s_taps, K);",
        "        s_y[c * LY + i] = make_float2(0.f, 0.f);")]),
    "resample_no_sums": (("resample",), [(
        "    tile_periods(buf0 + b * bf, off,",
        "    if (nb < 0) tile_periods(buf0 + b * bf, off,")]),
    "resample_no_stores": (("resample",), [(
        "if (u < nb) yr[u] = acc;",
        "if (u < nb && acc == 1e38f) yr[u] = acc;")]),
    "resample_runtime_geometry": (("resample", "backhalf"), [(
        "  if (I == 3 && D == 10 && Kp == 11) {",
        "  if (I == -3 && D == 10 && Kp == 11) {")]),
    "resample_tile1536": (("resample",), [(
        "std::max(1, 3072 / I)", "std::max(1, 1536 / I)")]),
    "resample_unroll2": (("resample", "backhalf"), [(
        "  for (int p = threadIdx.x; p < np; p += NT) {\n    const float2*",
        "#pragma unroll 2\n  for (int p = threadIdx.x; p < np; p += NT) {\n"
        "    const float2*")]),
    "backhalf_no_stage1": (("backhalf",), [(
        "    resample_tile::tile_periods(",
        "    if (ng < 0) resample_tile::tile_periods(")]),
    "backhalf_no_stage2": (("backhalf",), [(
        "      if (Kf == 64)\n        fir_tile::tile_sums<0, 64>",
        "      if (Kf < 0)\n        fir_tile::tile_sums<0, 64>"), (
        "      else\n        fir_tile::tile_sums<0, 0>",
        "      else if (Kf < 0)\n        fir_tile::tile_sums<0, 0>")]),
    "backhalf_fma": (("backhalf",), [(
        "acc[r] = __fadd_rn(acc[r], __fmul_rn(tj[jj], w[OFF + jj + r]));",
        "acc[r] = __fmaf_rn(tj[jj], w[OFF + jj + r], acc[r]);")]),
    "fft_no_stores": (("fft_stream",), [(
        "if (slot < fc)\n", "if (slot < fc && H < 0)\n")]),
    "fft_no_stage": (("fft_stream",), [(
        "  if (cnt <= 0) return;",
        "  if (cnt <= 0 || nthreads > 0) return;")]),
    "fft_no_dft": (("fft_stream",), [
        ("  dft<G::E>(re, im);\n  __syncthreads();", "  __syncthreads();"),
        ("    dft<R>(re + q * R, im + q * R);\n", "")]),
    "fft_no_twiddles": (("fft_stream",), [(
        "    if (NS > 1) {", "    if (NS < 0) {")]),
    "fft_sqrt_approx": (("fft_stream",), [(
        "sqrtf(re[v] * re[v] + im[v] * im[v]);",
        "sqrt_approx(re[v] * re[v] + im[v] * im[v]);"), (
        "// (a + ib) times exp(-i pi k / 16), 0 <= k < 16",
        "__device__ __forceinline__ float sqrt_approx(float v) {\n"
        "  float r;\n"
        "  asm(\"sqrt.approx.f32 %0, %1;\" : \"=f\"(r) : \"f\"(v));\n"
        "  return r;\n}\n\n"
        "// (a + ib) times exp(-i pi k / 16), 0 <= k < 16")]),
    "fft_occ2": (("fft_stream",), [(
        "kPasses == 2 ? 3 : 2;", "kPasses == 2 ? 2 : 2;")]),
    "agc_no_stores": (("agc_linear",), [(
        "row[k] = xs[p * kSlots + slot(k)];",
        "if (k < 0) row[k] = xs[p * kSlots + slot(k)];")]),
    "agc_stream_stores": (("agc_linear",), [(
        "row[k] = xs[p * kSlots + slot(k)];",
        "__stcs(row + k, xs[p * kSlots + slot(k)]);")]),
    "agc_one_wave": (("agc_linear",), [(
        WAVE_K12, "constexpr long long kWaveBytes = 1LL << 60;")]),
    "agc_wave2": (("agc_linear",), [(
        WAVE_K12, "constexpr long long kWaveBytes = 2LL << 20;")]),
    "agc_wave8": (("agc_linear",), [(
        WAVE_K12, "constexpr long long kWaveBytes = 8LL << 20;")]),
    "agc_no_wait": (("agc_linear",), [(
        "    tickets::wait(ready, r);\n", "")]),
    "agc_bounds5": (("agc_linear",), [(
        "__launch_bounds__(kScanThreads)\nscan_kernel",
        "__launch_bounds__(kScanThreads, 5)\nscan_kernel")]),
    "agc_bounds6": (("agc_linear",), [(
        "__launch_bounds__(kScanThreads)\nscan_kernel",
        "__launch_bounds__(kScanThreads, 6)\nscan_kernel")]),
    "agc_no_doubling": (("agc_linear",), [(
        "  doubling<1>(v);", "")]),
    "agc_smem_level2": (("agc_linear",), [(
        "__device__ __forceinline__ float2 shfl_up2(float2 v, int d) {",
        SMEM_LEVEL2)]),
    "iir_no_stores": (("iir",), [(
        "out[k] = xs[slot(k)];", "if (k < 0) out[k] = xs[slot(k)];")]),
    "iir_stream_stores": (("iir",), [(
        "out[k] = xs[slot(k)];", "__stcs(out + k, xs[slot(k)]);")]),
    "iir_one_wave": (("iir",), [(
        WAVE_K13, "constexpr long long kWaveBytes = 1LL << 60;")]),
    "iir_wave2": (("iir",), [(
        WAVE_K13, "constexpr long long kWaveBytes = 2LL << 20;")]),
    "iir_no_wait": (("iir",), [(
        "tickets::wait(ready, r);\n", "\n")]),
    "iir_wave32": (("iir",), [(
        WAVE_K13, "constexpr long long kWaveBytes = 32LL << 20;")]),
    "iir_bounds8": (("iir",), [(
        "__launch_bounds__(kThreads)\nsection_kernel",
        "__launch_bounds__(kThreads, 8)\nsection_kernel")]),
    "iir_bounds10": (("iir",), [(
        "__launch_bounds__(kThreads)\nsection_kernel",
        "__launch_bounds__(kThreads, 10)\nsection_kernel")]),
    "iir_no_runs": (("iir",), [(
        "  run<P>(sec, tile, base, end, x1, x2, s, false);", "")]),
    "iir_no_scan": (("iir",), [
        ("    block_scan<P>(sec.span, s, zero, after, totals);",
         "    for (int k = 0; k < P; ++k) after[k] = s[k];"),
        ("  block_scan<P>(sec.span, s, e, after, totals);", "")]),
    "stereo_no_sums": (("stereo_decode",), [
        ("fma_sums(acc, ws, taps + KP);", ""),
        ("boxcar(acc, ws, taps[2 * KP]);", ""),
        ("fma_sums(acc, ws, taps + 3 * KP);", ""),
        ("fma_sums(acc, xs + (K - 1), taps + 3 * KP);", "")]),
    "stereo_no_stores": (("stereo_decode",), [(
        "    store_row(cs, yl, nb);\n    store_row(ws, yl + n, nb);",
        "    if (nb < 0) {\n      store_row(cs, yl, nb);\n"
        "      store_row(ws, yl + n, nb);\n    }")]),
    "pilot_no_sums": (("stereo_decode",), [(
        "fma_sums(acc, x, taps);", "")]),
    "pilot_no_fence": (("stereo_decode",), [(
        "      if (leaves) __threadfence();\n", "")]),
    "pilot_stride": (("stereo_decode",), [
        ("  long long it = blockIdx.x * per;\n"
         "  const long long end = min(total, it + per);",
         "  long long it = blockIdx.x;\n  const long long end = total;"),
        ("  for (int b = 0; it < end; ++it, b ^= 1) {",
         "  for (int b = 0; it < end; it += gridDim.x, b ^= 1) {"),
        ("    const long long next = it + 1;",
         "    const long long next = it + gridDim.x;")]),
    "stereo_no_loads": (("stereo_decode",), [(
        "    if (next < total) {\n      long long r, i0;",
        "    if (next < 0) {\n      long long r, i0;")]),
    "pilot_no_loads": (("stereo_decode",), [(
        "    if (next < end) {", "    if (next < 0) {")]),
    "stereo_bounds1": (("stereo_decode",), [(
        "__launch_bounds__(NT, 3)\ncascade_kernel",
        "__launch_bounds__(NT)\ncascade_kernel")]),
    "stereo_blocks2": (("stereo_decode",), [(
        "constexpr long long SMEM_B = 4LL * B_FLOATS;",
        "constexpr long long SMEM_B = 4LL * B_FLOATS + 40960;")]),
    "stereo_one_buffer": (("stereo_decode",), [
        ("persistent::wait_prev();\n    __syncthreads();\n"
         "    long long r, q0;", WAIT_ALL + "    long long r, q0;"),
        ("persistent::wait_prev();\n    __syncthreads();\n"
         "    long long r, i0;", WAIT_ALL + "    long long r, i0;")]),
    "stereo_single_stage": (("stereo_decode",), [
        ("constexpr int B_FLOATS = 4 * KP + TILE + 2 * (XB + WB);",
         "constexpr int B_FLOATS = 4 * KP + TILE + (XB + WB);"),
        ("    stage_xe(stages, g, r, i0, XB);\n"
         "    stage_row(stages + XB, sq + r * nq, nq, i0, WB);\n", ""),
        ("    const long long next = it + gridDim.x;\n",
         "    const long long next = it;\n"),
        ("      float* nx = stages + (b ^ 1) * (XB + WB);",
         "      float* nx = stages;"),
        ("persistent::wait_prev();\n    __syncthreads();\n"
         "    long long r, i0;", WAIT_ALL + "    long long r, i0;"),
        ("    float* const xs = stages + b * (XB + WB);",
         "    float* const xs = stages;")]),
    "stereo_mul_add": (("stereo_decode",), [(
        "acc[j] = __fmaf_rn(tj[jj], w[jj + j], acc[j]);",
        "acc[j] = __fadd_rn(acc[j], __fmul_rn(tj[jj], w[jj + j]));")]),
    "stereo_fir_avg": (("stereo_decode",), [(
        "boxcar(acc, ws, taps[2 * KP]);",
        "zero(acc);\n    fma_sums(acc, ws, taps + 2 * KP);")]),
    "mix_complex_no_stores": (("mix",), [
        ("    if (vec) {\n      *reinterpret_cast<float4*>(yr) =\n"
         "          make_float4(out[0]",
         "    if (vec && out[0] == 1234.5f) {\n"
         "      *reinterpret_cast<float4*>(yr) =\n"
         "          make_float4(out[0]"),
        ("        if (k < cnt)\n          *reinterpret_cast<float2*>(yr + "
         "2 * k) =",
         "        if (k < 0)\n          *reinterpret_cast<float2*>(yr + "
         "2 * k) =")]),
    "iir_serial_runs": (("iir",), [(
        "__device__ __forceinline__ void block_scan(const double* pw, "
        "double* w,\n", SERIAL_RUNS)]),
    "dft_no_dft": (("channelize",), [(
        "const bool busy = slot < rows_here;", "const bool busy = false;")]),
    "dft_no_sums": (("channelize",), [(
        "    if (it < items) {\n      const int g = it / lanes;\n"
        "      const int j",
        "    if (it < 0) {\n      const int g = it / lanes;\n"
        "      const int j")]),
    "dft_no_stores": (("channelize",), [(
        "    out[i] = make_float4(", "    if (H < 0) out[i] = make_float4(")]),
    "dft_sync_stage": (("channelize",), [(
        "if (kAsync && aligned16(dv)) {",
        "if (kAsync && aligned16(dv) && cnt < 0) {")]),
    "dft_occ2": (("channelize",), [(
        "__launch_bounds__(kThreads, 3)", "__launch_bounds__(kThreads, 2)")]),
    "dft_occ4": (("channelize",), [(
        "__launch_bounds__(kThreads, 3)", "__launch_bounds__(kThreads, 4)")]),
    "dft_full_tile": (("channelize",), [
        ("constexpr int kDftRows = 4096;", "constexpr int kDftRows = 8192;"),
        ("__launch_bounds__(kThreads, 3)", "__launch_bounds__(kThreads, 2)")]),
}
EXACT = {"ns512", "ring_w64", "ring_w256", "ring_stages2", "ring_occ2",
         "ring_occ4",
         "fir_runtime_taps", "fir_dec_runtime", "fir_dec_nopad",
         "fir_iq_both_planes", "fir_iq_inline",
         "fir_dec_rc4", "fir_dec_occ3", "fir_dec_occ4", "fir_dec_span4096", "resample_runtime_geometry",
         "resample_tile1536", "resample_unroll2", "fft_occ2", "agc_one_wave",
         "agc_wave2", "agc_wave8", "agc_smem_level2", "agc_bounds5", "agc_bounds6", "agc_stream_stores",
         "iir_one_wave", "iir_wave2", "iir_wave32", "iir_stream_stores",
         "iir_bounds8", "iir_bounds10", "stereo_bounds1", "stereo_blocks2",
         "stereo_one_buffer", "stereo_single_stage", "pilot_stride",
         "dft_sync_stage", "dft_occ2", "dft_occ4", "dft_full_tile"}
CALL_KERNEL = {"fir65": "fir", "fir_dec8": "fir", "fir_dec16": "fir",
               "fir_iq8": "fir", "fir_iq16": "fir", "fir_cm8": "fir",
               "resample_stereo": "resample", "agc_gains": "agc_linear",
               "iir_final": "iir", "iir_deemph": "iir",
               "iir_deemph_final": "iir", "stereo_a": "stereo_decode",
               "stereo_a_bare": "stereo_decode", "stereo_b": "stereo_decode",
               "mix_complex": "mix", "branch_dft": "channelize"}


def variant(kernel: _build.Kernel, name: str, patches) -> _build.Kernel:
    """``kernel`` built from a patched copy of csrc.  Each ``old`` snippet
    must occur exactly once in the kernel's source and the shared headers
    together, or this raises: a snippet that an edit of csrc no longer
    matches would otherwise leave the committed kernel timed as the
    variant."""
    texts = {f.name: f.read_text() for f in sorted(_build.CSRC.iterdir())}
    patched = [n for n in texts
               if n == kernel.source.name or n.endswith(".cuh")]
    for old, new in patches:
        hits = {n: texts[n].count(old) for n in patched}
        if sum(hits.values()) != 1:
            raise ValueError(f"variant {name} of {kernel.name}: {old!r} "
                             f"occurs {hits}, not once")
        n = next(n for n, c in hits.items() if c)
        texts[n] = texts[n].replace(old, new)
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for n, text in texts.items():
        if n.endswith(".cu"):   # the library's name digests the patches
            text += f"\n// variant {name}: {patches!r}\n"
        (d / n).write_text(text)
    k = _build.Kernel(kernel.name, kernel.functions)
    k.source = d / kernel.source.name
    return k


def time_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / REPS


def main(argv=None) -> int:
    mods = {"u8_front_demod": u8_front_demod, "u8_front": u8_front,
            "fir": fir, "resample": resample, "backhalf": backhalf,
            "fft_stream": fft_stream, "agc_linear": agc_linear, "iir": iir,
            "stereo_decode": stereo_decode, "mix": mix,
            "channelize": channelize}
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", nargs="+", choices=sorted(mods),
                    default=sorted(mods))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    builds = {(m, "committed"): mods[m].KERNEL for m in args.kernels}
    for name, (targets, patches) in VARIANTS.items():
        for m in targets:
            if m in args.kernels:
                builds[(m, name)] = variant(mods[m].KERNEL, name, patches)
    _build.build_all(builds.values())
    for (m, name), k in builds.items():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {m} {name}: {line.strip()}")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, 256, (ROWS, ROW_BYTES), generator=g,
                      dtype=torch.uint8, device=dev)
    hist = torch.randint(0, 256, (ROWS, HIST), generator=g,
                         dtype=torch.uint8, device=dev)
    liq = torch.zeros(ROWS, 2, device=dev)
    tq, scale = u8_front_plan(windowed_sinc(51, 0.125, hamming), "s8")
    tq = torch.as_tensor(tq, device=dev)
    num = ROW_BYTES // 16
    xm = torch.randn(ROWS, 196_671, generator=g, device=dev)
    xs = torch.randn(ROWS, 655_552, generator=g, device=dev)
    t64 = torch.randn(64, generator=g, device=dev)
    t65 = torch.randn(65, generator=g, device=dev)
    table = torch.as_tensor(prepare_phase_table(
        windowed_sinc(31, 0.25, hamming), 3), device=dev)
    xd = torch.randn(ROWS, 2, DEC_N, generator=g, device=dev)
    t51 = torch.randn(51, generator=g, device=dev)
    xc = torch.randn(ROWS, DEC_N, generator=g, device=dev,
                     dtype=torch.complex64)
    xw = torch.randn(ROWS, WB_N, 64, generator=g, device=dev,
                     dtype=torch.complex64).transpose(-1, -2)
    xr = torch.randn(ROWS, 655_360, generator=g, device=dev)
    hr = torch.randn(ROWS, 82, generator=g, device=dev)
    xr2 = torch.randn(ROWS, 2, 655_360, generator=g, device=dev)
    hr2 = torch.randn(ROWS, 2, 82, generator=g, device=dev)
    hd = torch.randn(ROWS, 2, 512, generator=g, device=dev)
    wb = torch.as_tensor(blackman(1024), device=dev)
    xa = torch.randn(ROWS, 2, AM_N, generator=g, device=dev) * 0.7
    ma = torch.complex(xa[:, 0], xa[:, 1]).abs()
    ga = torch.rand(ROWS, generator=g, device=dev) + 0.5
    xdc = torch.rand(ROWS, AM_N, generator=g, device=dev) + 0.5
    xde = torch.randn(ROWS, 2, STEREO_N, generator=g, device=dev)
    zin = (torch.zeros(ROWS, 2, device=dev), torch.zeros(ROWS, 1, device=dev))
    zde = (torch.zeros(ROWS, 2, 2, device=dev),
           torch.zeros(ROWS, 2, 2, device=dev))
    sd = StereoDecode(device=dev)
    xst = torch.randn(ROWS, STEREO_COMP, generator=g, device=dev)
    hst = torch.randn(ROWS, 192, generator=g, device=dev)
    lock = torch.zeros(ROWS, device=dev)
    gate = torch.ones(ROWS, device=dev)
    sq = torch.empty(ROWS, STEREO_COMP + 128, device=dev)
    sq_b = torch.empty_like(sq)     # launch B's input, written once here
    if "stereo_decode" in args.kernels:
        stereo_decode.pilot_lock(sd._bp19, hst, xst, lock, sd.lock_hi,
                                 sd.lock_lo, sq_b)
    lo_c = Mix(0.25, device=dev)._table(DEC_N)
    carry_c = torch.polar(torch.ones(ROWS, device=dev),
                          torch.rand(ROWS, generator=g, device=dev) * 6.28)
    if "channelize" in args.kernels:
        hb_w = torch.randn(12, 64, generator=g, device=dev)
        x_w = torch.randn(ROWS, 64 * WB_N, generator=g, device=dev,
                          dtype=torch.complex64)
        hist_w = torch.randn(ROWS, 11 * 64, generator=g, device=dev,
                             dtype=torch.complex64)

    calls = {
        "u8_front_demod": lambda: u8_front_demod.u8_front_demod(
            tq, scale, 8, x, hist, liq, num)[0],
        "u8_front": lambda: u8_front.u8_front(tq, scale, 8, x, hist, num),
        "fir": lambda: fir.fir_strided(t64, xm, 196_608),
        "fir65": lambda: fir.fir_strided(t65, xs, 655_360, 1, 128),
        "fir_dec8": lambda: fir.fir_strided(t51, xd, 655_354, 8, 5),
        "fir_dec16": lambda: fir.fir_strided(t64, xd, 327_677, 16, 0),
        "fir_iq8": lambda: fir.fir_strided(t51, xc, 655_354, 8, 5),
        "fir_iq16": lambda: fir.fir_strided(t64, xc, 327_677, 16, 0),
        "fir_cm8": lambda: fir.fir_strided(t51, xw, 7_994, 8, 5),
        "resample": lambda: resample.resample(table, 3, 10, xr, hr, 0,
                                              196_671),
        "resample_stereo": lambda: resample.resample(table, 3, 10, xr2, hr2,
                                                     0, 196_671),
        "backhalf": lambda: backhalf.resample_fir(table, 3, 10, t64, xr2, hr2,
                                                  0, 196_608),
        "fft_stream": lambda: fft_stream.fft_stream(hd, xd, wb, 512),
        "agc_linear": lambda: agc_linear.agc_apply(xa, 0.005, 1.0, ga)[0],
        "agc_gains": lambda: agc_linear.agc_gains(ma, 0.005, 1.0, ga)[0],
        "iir": lambda: iir.iir_section(xdc, *DC, *zin)[0],
        "iir_final": lambda: iir.iir_section(xdc, *DC, *zin, store=False)[1],
        "iir_deemph": lambda: iir.iir_section(xde, *DEEMPH, *zde)[0],
        "iir_deemph_final": lambda: iir.iir_section(xde, *DEEMPH, *zde,
                                                    store=False)[1],
        "stereo_a": lambda: stereo_decode.pilot_lock(
            sd._bp19, hst, xst, lock, sd.lock_hi, sd.lock_lo, sq)[0],
        "stereo_a_bare": lambda: stereo_decode.pilot_lock(
            sd._bp19, hst, xst, None, sd.lock_hi, sd.lock_lo)[1],
        "stereo_b": lambda: stereo_decode.stereo_decode(
            sd._taps, hst, xst, gate, sd.gain, sd.pilot_floor, sq_b),
        "mix_complex": lambda: mix.mix_complex(lo_c, carry_c, xc),
        "branch_dft": lambda: channelize.branch_dft(hb_w, hist_w, x_w,
                                                    WB_N),
    }
    out = {"card": card, "clone_ms": {
        "u8 [32, 10485760]": time_ms(x.clone),
        "f32 [32, 196671]": time_ms(xm.clone),
        "f32 [32, 655552]": time_ms(xs.clone),
        "f32 [32, 655360]": time_ms(xr.clone),
        "f32 [32, 2, 5242880]": time_ms(xd.clone),
        "c64 [32, 5242880]": time_ms(xc.clone),
        "c64 [32, 64000, 64]": time_ms(xw.clone),
        "f32 [32, 2, 655360]": time_ms(xr2.clone),
        "f32 [32, 2, 327677]": time_ms(xa.clone),
        "f32 [32, 327677]": time_ms(xdc.clone),
        "f32 [32, 2, 196608]": time_ms(xde.clone),
        "f32 [32, 655360] composite": time_ms(xst.clone)}, "ms": {}}
    names = ["committed", *VARIANTS, "committed again"]
    want = {}
    for name in names:
        for call, fn in calls.items():
            m = CALL_KERNEL.get(call, call)
            key = (m, name.replace(" again", ""))
            if key not in builds:
                continue
            mods[m].KERNEL = builds[key]
            y = fn()
            if name == "committed":
                want[call] = y
            elif name in EXACT and not torch.equal(y, want[call]):
                raise RuntimeError(f"{name} differs from the committed {m}")
            out["ms"][f"{call} {name}"] = time_ms(fn)
            print(f"{call:15s} {name:18s} {out['ms'][f'{call} {name}']:.4f} "
                  "ms")
    for m in args.kernels:
        mods[m].KERNEL = builds[(m, "committed")]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
