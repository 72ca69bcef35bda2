// The register DFT that K9 (fft_stream.cu) and the channelizer's fused
// filterbank (channelize.cu) share: Stockham's autosort form over rows of
// N = 2^LOG2N complex values held as two padded shared-memory planes.
//
// * log2 N / 5 passes of radix 32 (E = 32 elements a thread) and a last
//   pass of radix 2, 4, 8 or 16 for the rest; T = N / E threads a row.
// * A pass reads a thread's radix-R butterflies (strided by N / R),
//   multiplies by the twiddles, runs the R-point DFT in registers (radix-2
//   decimation in frequency, its constants folded) and writes them
//   (strided by the product of the radices before it).
// * The planes are apart and padded by one word every 32 (no bank conflict
//   at E = 32).
// * The twiddles exp(-2 pi i k r / (Ns R)) come from a table computed in
//   float64 and rounded to f32 once (kernels/fft_stream.py:twiddles), laid
//   out a pass at a time so that a warp reads consecutive words.
//
// Include after <cuda_runtime.h> (or the host test shim that stands in for
// it).

#pragma once

namespace stockham {

constexpr int kTargetThreads = 256;

// log2 of the elements a thread holds: the radix of every pass but the last
__host__ __device__ constexpr int log2_elems(int log2n) {
  return log2n < 5 ? log2n : 5;
}

// a word of padding every 32 words of an exchanged plane
__host__ __device__ constexpr int pad(int i) { return i + (i >> 5); }

// k's low `bits` (at most 5) reversed; no loop, so that an unrolled
// caller's register index folds to a constant
__host__ __device__ constexpr int bitrev(int k, int bits) {
  return (((k & 1) << 4) | ((k & 2) << 2) | (k & 4) | ((k & 8) >> 2) |
          ((k & 16) >> 4)) >> (5 - bits);
}

// cos(k pi / 16) for 0 <= k <= 8
__host__ __device__ constexpr float cos16(int k) {
  return k == 0 ? 1.0f
       : k == 1 ? 0.980785280403230449126f
       : k == 2 ? 0.923879532511286756128f
       : k == 3 ? 0.831469612302545237079f
       : k == 4 ? 0.707106781186547524401f
       : k == 5 ? 0.555570233019602224743f
       : k == 6 ? 0.382683432365089771728f
       : k == 7 ? 0.195090322016128267848f
       : 0.0f;
}

// (a + ib) times exp(-i pi k / 16), 0 <= k < 16
__device__ __forceinline__ void rotate(int k, float& a, float& b) {
  if (k == 0) return;
  if (k == 8) {                         // times -i
    const float t = a;
    a = b;
    b = -t;
    return;
  }
  const float c = k <= 8 ? cos16(k) : -cos16(16 - k);
  const float s = k <= 8 ? cos16(8 - k) : cos16(k - 8);
  const float t = a * c + b * s;
  b = b * c - a * s;
  a = t;
}

// One radix-2 stage of the decimation in frequency: butterflies h apart,
// the difference times W_{2h}^j; then the stages of h / 2 .. 1.  (A
// template a stage, so that every register index is a constant.)
template <int R, int h>
__device__ __forceinline__ void dft_stage(float* re, float* im) {
#pragma unroll
  for (int s0 = 0; s0 < R; s0 += 2 * h) {
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const int a = s0 + j, b = a + h;
      float dr = re[a] - re[b], di = im[a] - im[b];
      re[a] += re[b];
      im[a] += im[b];
      rotate(16 * j / h, dr, di);       // W_{2h}^j = exp(-i pi j / h)
      re[b] = dr;
      im[b] = di;
    }
  }
  if constexpr (h > 1) dft_stage<R, h / 2>(re, im);
}

// The R-point forward DFT of (re, im)[0, R) in registers, in place:
// radix-2 decimation in frequency, so X[k] ends at position bitrev(k).
template <int R>
__device__ __forceinline__ void dft(float* re, float* im) {
  dft_stage<R, R / 2>(re, im);
}

template <int LOG2N>
struct Geometry {
  static constexpr int kLog2N = LOG2N;
  static constexpr int N = 1 << LOG2N;
  static constexpr int kLog2E = log2_elems(LOG2N);
  static constexpr int E = 1 << kLog2E;
  static constexpr int T = N / E;                   // threads a frame
  static constexpr int kFull = LOG2N / kLog2E;      // passes of radix E
  static constexpr int kRest = LOG2N % kLog2E;      // log2 of the last radix
  static constexpr int kPasses = kFull + (kRest ? 1 : 0);
  static constexpr int kThreads = T > kTargetThreads ? T : kTargetThreads;
  // blocks of 256 threads an SM: three (at most 80 registers a thread,
  // their 67,584 bytes of shared memory three times) at two passes, two
  // at three, whose registers spill at 80
  static constexpr int kMinBlocks =
      kThreads != kTargetThreads ? 1 : kPasses == 2 ? 3 : 2;
  static constexpr int P = N + N / 32;              // a padded plane
};

// pass p's radix and the product of the radices before it
template <class G, int p>
struct Pass {
  static constexpr int kLog2R = p < G::kFull ? G::kLog2E : G::kRest;
  static constexpr int R = 1 << kLog2R;
  static constexpr int NS = 1 << (p * G::kLog2E);
};

// Pass p's loads: each of the thread's E / R butterflies jj = t + q T
// reads elements jj + r N / R of the frame's exchanged planes, times the
// twiddles exp(-2 pi i (jj mod Ns) r / (Ns R)), then its R-point DFT.
template <class G, int p>
__device__ __forceinline__ void load_pass(float* re, float* im,
                                          const float* xr, const float* xi,
                                          const float2* __restrict__ tw,
                                          int t) {
  using S = Pass<G, p>;
  constexpr int R = S::R, NS = S::NS;
#pragma unroll
  for (int q = 0; q < G::E / R; ++q) {
    const int jj = t + q * G::T;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = pad(jj + r * (G::N / R));
      re[q * R + r] = xr[i];
      im[q * R + r] = xi[i];
    }
    if (NS > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float2 w = __ldg(tw + NS - 1 + (r - 1) * NS + (jj & (NS - 1)));
        const float a = re[q * R + r], b = im[q * R + r];
        re[q * R + r] = a * w.x - b * w.y;
        im[q * R + r] = a * w.y + b * w.x;
      }
    }
    dft<R>(re + q * R, im + q * R);
  }
}

// Pass p's stores into the exchanged planes: butterfly jj's output k at
// (jj / Ns) Ns R + jj mod Ns + k Ns (the last pass's: X in natural order).
template <class G, int p>
__device__ __forceinline__ void store_pass(const float* re, const float* im,
                                           float* xr, float* xi, int t) {
  using S = Pass<G, p>;
  constexpr int R = S::R, NS = S::NS;
#pragma unroll
  for (int q = 0; q < G::E / R; ++q) {
    const int jj = t + q * G::T;
    const int base = (jj / NS) * NS * R + (jj & (NS - 1));
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = pad(base + k * NS);
      const int v = q * R + bitrev(k, S::kLog2R);
      xr[i] = re[v];
      xi[i] = im[v];
    }
  }
}

// Passes p .. kPasses - 1, the registers holding pass p - 1's output; then
// done(re, im) with the last pass's (output k = jj + k' Ns of butterfly jj
// at register q R + bitrev(k')).  A thread that is not busy only meets the
// barriers (every thread of the block calls this, and done).
template <class G, int p, class Done>
__device__ __forceinline__ void run_passes(float* re, float* im, float* xr,
                                           float* xi,
                                           const float2* __restrict__ tw,
                                           int t, bool busy, Done done) {
  if (busy) store_pass<G, p - 1>(re, im, xr, xi, t);
  __syncthreads();
  if (busy) load_pass<G, p>(re, im, xr, xi, tw, t);
  if constexpr (p + 1 < G::kPasses) {
    __syncthreads();
    run_passes<G, p + 1>(re, im, xr, xi, tw, t, busy, done);
  } else {
    done(re, im);
  }
}

}  // namespace stockham
