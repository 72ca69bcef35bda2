// The u8 IQ front end's window staging and exact integer sums, shared by
// K1 (u8_front_demod.cu) and K4 (u8_front.cu).
//
// A row's stream is concat(hist, x): byte p < H comes from the row's
// H-byte history, the rest from its block.  A tile is `ns` consecutive
// decimated samples of one row; sample u reads the K (I, Q) byte pairs
// from stream byte pb + 2 u f on.  The kernels are persistent: as many
// blocks as fit on the card at once walk the tiles, and each block, per
// tile,
//  1. has already issued the copies of the tile's stream bytes [pb, pe)
//     into one of its two staging buffers while it computed the tile
//     before (`stage_raw`): 16-byte cp.async copies for the chunks that
//     lie wholly in the block tensor `x` (16-byte aligned in device
//     memory, whatever the row base, the 86-byte history or the byte
//     offset), byte by byte for the chunks that hold history bytes or
//     cross the tensor's ends.  So every block keeps a tile's bytes in
//     flight while it computes (measured on the H100: blocks that staged,
//     then computed, then exited spent most of the kernel's time in the
//     copies);
//  2. deinterleaves them into two s8 planes, I and Q, each byte `^ 0x80`:
//     taken as int8, `v ^ 0x80` is `v - 128` exactly.  A thread turns 8
//     staged bytes into 4 bytes of each plane: two funnel shifts undo the
//     staging's byte offset, two `__byte_perm`s split I from Q
//     (`deinterleave`);
//  3. sums each sample's window with `__dp4a`, four taps a word
//     (`window_sums`).  The taps arrive packed by the wrapper
//     (kernels/u8_front.py:pack_taps): s8 taps four to an int32 word,
//     zero-padded to an even number of words `nw` (51 taps: 14 words);
//     16-bit taps as T = 256 Th + Tl, a word row of the signed high bytes
//     and one of the unsigned low bytes, summed as 256 sum(Th x) +
//     sum(Tl x) (|sum Th x| <= 128 * 128 * K, so exact in int32).  The
//     words live in registers for the common counts (template NW) and are
//     read through the read-only cache otherwise (NW = 0).  The kernels
//     are persistent and double-buffered as K3 is (persistent.cuh).
//
// Bank conflicts.  Samples go to threads round-robin (u = t, t + NT, ...),
// so neighbouring threads' windows sit f plane bytes apart.  For f a
// multiple of 8 a thread reads its window as 8-byte words: 16 threads of
// a half-warp read 128 contiguous bytes, one per bank pair, which shared
// memory serves in one pass (no conflict).  Otherwise it reads 4-byte
// words and funnel-shifts them into place: for f = 4 neighbours are one
// word apart (no conflict), for f < 4 several threads read the same word
// (a broadcast, no conflict).  Staging writes 16 contiguous bytes per
// thread; the deinterleave reads 4-byte words at an 8-byte thread stride
// (2-way), over a quarter of the bytes the sums read.
//
// The sums are int32 and exact; the caller applies one rounded f32
// multiply by the plan's scale, so a sample does not depend on the tile or
// grid that computed it and equals the plain PyTorch version bitwise.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent.cuh"

namespace u8w {

using persistent::commit;
using persistent::cp_async16;
using persistent::wait_prev;

constexpr int NT = 256;              // threads per block
constexpr int MAX_SMEM = 232448;     // an H100 block's shared memory

__host__ __device__ constexpr long long align16(long long v) {
  return (v + 15) / 16 * 16;
}

// samples of a plane a tile of ns samples reads
__host__ __device__ constexpr long long plane_len(long long ns, int f,
                                                 int K) {
  return (ns - 1) * f + K;
}

// staged stream bytes: up to 15 bytes of alignment slack, the window, and
// the deinterleave's read of 8 bytes past its last group
__host__ __device__ constexpr long long raw_bytes(long long ns, int f,
                                                 int K) {
  return align16(8 * ((plane_len(ns, f, K) + 3) / 4) + 32);
}

// one plane: the window plus the sums' read past it (nw tap words and one
// funnel word; the bytes past the window meet zero taps)
__host__ __device__ constexpr long long plane_bytes(long long ns, int f,
                                                   int nw) {
  return align16((ns - 1) * f + 4LL * nw + 8);
}

// a block's shared memory for tiles of ns samples: two staging buffers,
// each also room for `per_sample` bytes a sample once its window is
// deinterleaved (K1's (I, Q)), then the two planes
struct Layout {
  long long raw, plane;
  __host__ __device__ Layout(long long ns, int f, int K, int nw,
                             int per_sample)
      : raw(raw_bytes(ns, f, K) > align16(per_sample * ns)
                ? raw_bytes(ns, f, K)
                : align16(per_sample * ns)),
        plane(plane_bytes(ns, f, nw)) {}
  __host__ __device__ long long total() const { return 2 * raw + 2 * plane; }
};

// the largest tile of NT * {4, 2, 1} samples whose layout fits a block's
// shared memory; 0 if none does
inline long long tile_samples(int f, int K, int nw, int per_sample) {
  for (long long ns = 4LL * NT; ns >= NT; ns /= 2)
    if (Layout(ns, f, K, nw, per_sample).total() <= MAX_SMEM) return ns;
  return 0;
}

// Issue the copies of stream bytes [pb, pe) of concat(hist, x) ->
// raw[off + p - pb], where off puts the chunks that come from x on 16-byte
// device addresses; returns off.  [xb, xe) is the whole tensor x.  Bytes
// before the stream (p < 0) are left unset.  The caller commits the group.
__device__ __forceinline__ int stage_raw(unsigned char* raw,
                                         const uint8_t* __restrict__ hr,
                                         const uint8_t* __restrict__ xr,
                                         int H, long long pb, long long pe,
                                         const uint8_t* xb,
                                         const uint8_t* xe) {
  // device address of stream byte 0, as if x extended back over hist
  const long long x0 =
      static_cast<long long>(reinterpret_cast<uintptr_t>(xr)) - H;
  const long long a_lo = static_cast<long long>(
      reinterpret_cast<uintptr_t>(xb));
  const long long a_hi = static_cast<long long>(
      reinterpret_cast<uintptr_t>(xe));
  const int off = static_cast<int>((x0 + pb) & 15);
  const long long base = pb - off;
  const int chunks = static_cast<int>((off + pe - pb + 15) / 16);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const long long p0 = base + 16LL * c;
    if (p0 >= H && x0 + p0 >= a_lo && x0 + p0 + 16 <= a_hi) {
      cp_async16(raw + 16 * c, xr + (p0 - H));
    } else {
      for (int i = 0; i < 16; ++i) {
        const long long p = p0 + i;
        if (p >= pb && p >= 0 && p < pe)
          raw[16 * c + i] = p < H ? hr[p] : xr[p - H];
      }
    }
  }
  return off;
}

// staged bytes from raw[off] on -> planes pI, pQ of `len` samples, each
// byte ^ 0x80 (int8 v - 128)
__device__ __forceinline__ void deinterleave(const unsigned char* raw,
                                             int off, long long len,
                                             unsigned* pI, unsigned* pQ) {
  const unsigned* w = reinterpret_cast<const unsigned*>(raw);
  const unsigned sh = 8u * (off & 3);
  const int groups = static_cast<int>((len + 3) / 4);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int wi = (off >> 2) + 2 * g;
    const unsigned w0 = w[wi], w1 = w[wi + 1], w2 = w[wi + 2];
    const unsigned a = __funnelshift_r(w0, w1, sh);
    const unsigned b = __funnelshift_r(w1, w2, sh);
    pI[g] = __byte_perm(a, b, 0x6420) ^ 0x80808080u;
    pQ[g] = __byte_perm(a, b, 0x7531) ^ 0x80808080u;
  }
}

// a tile's deinterleaved planes
struct Planes {
  unsigned* pI;
  unsigned* pQ;
};

// signed x signed and unsigned x signed byte dot products, accumulated
__device__ __forceinline__ int dp4a_ss(int a, unsigned b, int c) {
  return __dp4a(a, static_cast<int>(b), c);
}
__device__ __forceinline__ int dp4a_us(int a, unsigned b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// packed tap words: NW > 0 in registers, NW == 0 (any count) read through
// the read-only cache (every thread the same word: one broadcast)
template <int NW, bool S16>
struct Taps {
  int h[NW], l[S16 ? NW : 1];
  __device__ Taps(const int32_t* __restrict__ tw, int) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      h[w] = __ldg(tw + w);
      if (S16) l[S16 ? w : 0] = __ldg(tw + NW + w);
    }
  }
  __device__ int count() const { return NW; }
  __device__ int hi(int w) const { return h[w]; }
  __device__ int lo(int w) const { return l[S16 ? w : 0]; }
};

template <bool S16>
struct Taps<0, S16> {
  const int32_t* __restrict__ tw;
  int nw;
  __device__ Taps(const int32_t* __restrict__ t, int n) : tw(t), nw(n) {}
  __device__ int count() const { return nw; }
  __device__ int hi(int w) const { return __ldg(tw + w); }
  __device__ int lo(int w) const { return __ldg(tw + nw + w); }
};

// exact (I, Q) sums of the window at plane byte pos
template <int NW, bool S16>
__device__ __forceinline__ int2 window_sums(const Planes& win, long long pos,
                                            bool f8,
                                            const Taps<NW, S16>& tp) {
  const int nw = tp.count();
  int hi_i = 0, hi_q = 0, lo_i = 0, lo_q = 0;
  if (f8) {
    // pos is a multiple of 8: 8-byte words, two tap words each
    const uint2* qi = reinterpret_cast<const uint2*>(win.pI) + (pos >> 3);
    const uint2* qq = reinterpret_cast<const uint2*>(win.pQ) + (pos >> 3);
#pragma unroll
    for (int w = 0; w < nw; w += 2) {
      const uint2 a = qi[w >> 1], b = qq[w >> 1];
      hi_i = dp4a_ss(tp.hi(w), a.x, hi_i);
      hi_q = dp4a_ss(tp.hi(w), b.x, hi_q);
      hi_i = dp4a_ss(tp.hi(w + 1), a.y, hi_i);
      hi_q = dp4a_ss(tp.hi(w + 1), b.y, hi_q);
      if (S16) {
        lo_i = dp4a_us(tp.lo(w), a.x, lo_i);
        lo_q = dp4a_us(tp.lo(w), b.x, lo_q);
        lo_i = dp4a_us(tp.lo(w + 1), a.y, lo_i);
        lo_q = dp4a_us(tp.lo(w + 1), b.y, lo_q);
      }
    }
  } else {
    // 4-byte words funnel-shifted to the window's byte
    const unsigned* wi = win.pI + (pos >> 2);
    const unsigned* wq = win.pQ + (pos >> 2);
    const unsigned sh = 8u * static_cast<unsigned>(pos & 3);
    unsigned i0 = wi[0], q0 = wq[0];
#pragma unroll
    for (int w = 0; w < nw; ++w) {
      const unsigned i1 = wi[w + 1], q1 = wq[w + 1];
      const unsigned a = __funnelshift_r(i0, i1, sh);
      const unsigned b = __funnelshift_r(q0, q1, sh);
      hi_i = dp4a_ss(tp.hi(w), a, hi_i);
      hi_q = dp4a_ss(tp.hi(w), b, hi_q);
      if (S16) {
        lo_i = dp4a_us(tp.lo(w), a, lo_i);
        lo_q = dp4a_us(tp.lo(w), b, lo_q);
      }
      i0 = i1;
      q0 = q1;
    }
  }
  if (S16) return make_int2(hi_i * 256 + lo_i, hi_q * 256 + lo_q);
  return make_int2(hi_i, hi_q);
}

__device__ __forceinline__ float2 scaled(int2 acc, float scale) {
  return make_float2(__fmul_rn(__int2float_rn(acc.x), scale),
                     __fmul_rn(__int2float_rn(acc.y), scale));
}

// Launch kern<NW, S16> for the packed tap count nw: the words in
// registers for the FM chains' 51 taps (14 words), read through the cache
// otherwise.  `Launch` is a functor template over <NW, S16>.
template <template <int, bool> class Launch, typename... A>
int dispatch(int nw, bool s16, A... a) {
  if (nw == 14)
    return s16 ? Launch<14, true>()(a...) : Launch<14, false>()(a...);
  return s16 ? Launch<0, true>()(a...) : Launch<0, false>()(a...);
}

}  // namespace u8w
